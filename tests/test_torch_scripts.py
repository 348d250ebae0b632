"""The experiment scripts' twins (umhs_torch/scripts/sh/) against the JAX
package's scripts/ on the CPU: every script has its twin, whose command is
the same argv with umhs_torch's module for umhs_tpu's, and each training
twin's flags resolve through the port's configs to the config that the JAX
script's flags give through umhs_tpu's, field by field (apart from the
JAX-only fields, configs.JAX_ONLY, and the port's impl, which no script
sets)."""

from pathlib import Path

import pytest

from umhs_tpu import configs as J
from umhs_torch import configs as T
from umhs_torch.scripts.shell_argv import script_argv

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = ROOT / "scripts"
TWINS = ROOT / "umhs_torch" / "scripts" / "sh"
SCRIPTS = sorted(p.relative_to(JAX_SCRIPTS).as_posix() for p in JAX_SCRIPTS.rglob("*.sh"))
TRAINING = [s for s in SCRIPTS if script_argv(JAX_SCRIPTS / s)[0] == "umhs_tpu.cli.train"]


def _shared(plain):
    """A _to_plain tree without the JAX-only fields and the port's impl."""
    if isinstance(plain, dict):
        cls = plain.get("__dataclass__")
        return {k: _shared(v) for k, v in plain.items()
                if (cls, k) not in T.JAX_ONLY and (cls, k) != ("ModelConfig", "impl")}
    if isinstance(plain, list):
        return [_shared(x) for x in plain]
    return plain


def test_every_script_is_found():
    assert len(SCRIPTS) == 17 and len(TRAINING) == 12
    assert {"render.sh", "visualize/hotdog.sh", "visualize/ajar.sh"} <= set(SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_each_script_has_its_twin_with_the_same_argv(name):
    module, argv = script_argv(JAX_SCRIPTS / name)
    twin = TWINS / name
    assert twin.is_file(), f"no twin of scripts/{name}"
    assert module.startswith("umhs_tpu.cli.")
    assert script_argv(twin) == (module.replace("umhs_tpu.", "umhs_torch.", 1), argv)
    assert "umhs_tpu.cli" not in twin.read_text()  # the commented commands too


@pytest.mark.parametrize("name", TRAINING)
def test_training_twin_resolves_to_the_jax_config(name):
    _, jargv = script_argv(JAX_SCRIPTS / name)
    _, targv = script_argv(TWINS / name)
    assert jargv[0] == targv[0] == "umhsnerf"  # the method, which cli.train takes first
    jcfg, jign = J.apply_cli_overrides(J.umhs_method_defaults(), jargv[1:])
    tcfg, tign = T.apply_cli_overrides(T.umhs_method_defaults(), targv[1:])
    assert _shared(T._to_plain(tcfg)) == _shared(J._to_plain(jcfg))
    assert set(tign) == set(jign)
    assert tcfg.pipeline.model.impl == "auto"
    data = Path(jargv[jargv.index("--data") + 1])
    assert tcfg.pipeline.datamanager.dataparser.data == data


def test_script_argv_reads_continuations_quotes_and_comments(tmp_path):
    script = tmp_path / "x.sh"
    script.write_text('#!/usr/bin/env bash\n# a note\n# python -m not.this --x 1\n'
                      'python -m umhs_torch.cli.train umhsnerf \\\n --a "b c" \\\n'
                      " --d 'e+f' --g h  # trailing\n# python -m nor.this\n")
    assert script_argv(script) == ("umhs_torch.cli.train",
                                   ["umhsnerf", "--a", "b c", "--d", "e+f", "--g", "h"])


@pytest.mark.parametrize("text", ["#!/usr/bin/env bash\n# only comments\n",
                                  "echo hello \\\n world\n"], ids=["empty", "not-python"])
def test_script_argv_refuses_a_script_without_a_python_command(tmp_path, text):
    script = tmp_path / "x.sh"
    script.write_text(text)
    with pytest.raises(ValueError):
        script_argv(script)
