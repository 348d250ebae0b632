"""umhs_torch.scripts.quality_seed_variance, the twin of
scripts/quality_seed_variance.py, on the CPU at a toy size: 2 seeds, 8 steps,
32^2, 4 bands, each seed's run in a process of its own with the model cut to
toy widths (tests/toy_quality_run.py, the cut of tests/test_torch_eval.py).
Its summary is the JAX script's own aggregation applied to the same per-seed
dicts, and each seed's command carries the JAX script's flags.

The seeds are 42 and 44. From seed 43 this toy's eval_all_images SAM is NaN
after 8 steps (and after 16, 24 and 32): both packages' sam nan-means over
the pixels where both spectra are nonzero, so some eval view has none; the
JAX script's aggregation (statistics.stdev) cannot take a NaN, and the twin
keeps that aggregation.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from umhs_torch.scripts import quality_seed_variance as twin

ROOT = Path(__file__).resolve().parent.parent
TOY = ROOT / "tests" / "toy_quality_run.py"
ARGV = ["--seeds", "42", "44", "--steps", "8", "--image-size", "32", "--views", "4"]


def _jax_script():
    """scripts/quality_seed_variance.py as a module (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_seed_variance", ROOT / "scripts" / "quality_seed_variance.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_run(monkeypatch, tmp_path, argv, per_seed):
    """The JAX script's main on `argv`, each seed's run replaced by writing
    that seed's eval_all_images from `per_seed`; returns (its JSON, the
    commands it would have run)."""
    module = _jax_script()
    commands = []

    def fake_run(cmd, check):
        commands.append(cmd)
        out = Path(cmd[cmd.index("--out") + 1])
        seed = cmd[cmd.index("--seed") + 1]
        out.write_text(json.dumps({"eval_all_images": per_seed[seed]}))

    monkeypatch.setattr(module.subprocess, "run", fake_run)
    monkeypatch.setattr(module.tempfile, "mkdtemp",
                        lambda prefix: str(Path(tmp_path) / f"{prefix}{len(commands)}"))
    for i in range(len(per_seed)):
        (Path(tmp_path) / f"umhs_seedvar_{i}").mkdir()
    monkeypatch.setattr(sys, "argv", ["quality_seed_variance.py", *argv])
    module.main()
    monkeypatch.undo()
    return json.loads(Path(argv[argv.index("--out") + 1]).read_text()), commands


def test_the_twin_at_a_toy_size(tmp_path, monkeypatch):
    full = twin.seed_command

    def toy_command(args, seed, out):
        cmd = full(args, seed, out)
        i = cmd.index("-m")
        return [*cmd[:i], str(TOY), *cmd[i + 2:], "--bands", "4"]

    monkeypatch.setattr(twin, "seed_command", toy_command)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "port" / "seed_variance.json"
    got = twin.main([*ARGV, "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    want_keys = set(json.loads((ROOT / "docs" / "tetra_2000_256.json").read_text())[
        "eval_all_images"])
    assert sorted(got["per_seed"]) == ["42", "44"]
    for seed, metrics in got["per_seed"].items():
        assert set(metrics) == want_keys, seed
        assert np.isfinite(metrics["psnr"]), seed
    assert got["per_seed"]["42"]["psnr"] != got["per_seed"]["44"]["psnr"]  # the seed matters
    assert got["config"] == {"steps": 8, "image_size": 32, "views": 4, "seeds": [42, 44],
                             "device": "cpu", "note": got["config"]["note"]}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port"]  # it leaves nothing else

    (tmp_path / "jax").mkdir()
    theirs, commands = _jax_run(monkeypatch, tmp_path / "jax",
                                [*ARGV, "--out", str(tmp_path / "jax" / "sv.json")],
                                got["per_seed"])
    assert theirs["summary"] == got["summary"]
    assert theirs["per_seed"] == got["per_seed"]
    for seed, cmd in zip((42, 44), commands):  # the same flags, seed by seed
        ours = full(twin.parse_args(ARGV), seed, Path("x"))
        for flag in ("--steps", "--image-size", "--views", "--seed"):
            assert ours[ours.index(flag) + 1] == cmd[cmd.index(flag) + 1], flag


def test_flags_and_defaults_match_the_jax_script(tmp_path, monkeypatch):
    """The JAX script's defaults (seeds 42 43 44, 3000 steps, 256^2, 16
    views) are the twin's; the twin writes under outputs/, not docs/."""
    args = twin.parse_args([])
    assert (args.seeds, args.steps, args.image_size, args.views, args.device) == (
        [42, 43, 44], 3000, 256, 16, "cuda")
    assert args.out == Path("outputs") / "seed_variance.json"
    per_seed = {str(s): {"psnr": 30.0 + s / 100.0} for s in args.seeds}
    _, commands = _jax_run(monkeypatch, tmp_path, ["--out", str(tmp_path / "sv.json")],
                           per_seed)
    assert len(commands) == 3
    for seed, cmd in zip(args.seeds, commands):
        ours = twin.seed_command(args, seed, Path("x"))
        assert ours[1:3] == ["-m", "umhs_torch.scripts.quality_reference_scale"]
        for flag in ("--steps", "--image-size", "--views", "--seed"):
            assert ours[ours.index(flag) + 1] == cmd[cmd.index(flag) + 1], flag
    assert twin.summarize(per_seed) == json.loads((tmp_path / "sv.json").read_text())["summary"]


def test_the_seed_command_runs_the_quality_twin():
    """The module each seed runs is the port's quality twin (its --help, in a
    process of its own, as the seeds run)."""
    cmd = twin.seed_command(twin.parse_args([]), 42, Path("x"))
    help_text = subprocess.run([*cmd[:3], "--help"], capture_output=True, text=True,
                               check=True, cwd=ROOT).stdout
    for flag in ("--steps", "--image-size", "--views", "--seed", "--out", "--device"):
        assert flag in help_text, flag
