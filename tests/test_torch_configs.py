"""umhs_torch.configs against umhs_tpu.configs on the CPU: the config
dataclasses' defaults, dotted flags resolved to the same values, config.yml
written by one package and read by the other (the port's YAML held to
PyYAML), the JAX-only fields recorded as inert, and the proposal sampler's
and the DINO head's fields resolved as the JAX package resolves them."""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from umhs_tpu import configs as J
from umhs_tpu.data import datamanager as j_dm
from umhs_tpu.data import dataparser as j_dp
from umhs_tpu.engine import trainer as j_tr
from umhs_tpu.models import model as j_model
from umhs_tpu.ops import encodings as j_enc
from umhs_torch import configs as T
from umhs_torch.data import datamanager as t_dm
from umhs_torch.data import dataparser as t_dp
from umhs_torch.engine import trainer as t_tr
from umhs_torch.models import model as t_model
from umhs_torch.ops import encodings as t_enc

PAIRS = {
    "TrainerConfig": (j_tr.TrainerConfig, t_tr.TrainerConfig),
    "OptimizerConfig": (j_tr.OptimizerConfig, t_tr.OptimizerConfig),
    "ModelConfig": (j_model.ModelConfig, t_model.ModelConfig),
    "DataManagerConfig": (j_dm.DataManagerConfig, t_dm.DataManagerConfig),
    "DataParserConfig": (j_dp.DataParserConfig, t_dp.DataParserConfig),
    "HashEncodingConfig": (j_enc.HashEncodingConfig, t_enc.HashEncodingConfig),
}

# the reference's own flags (scripts/hotdog.sh, as tests/test_configs_cli.py has them)
REFERENCE_ARGV = [
    "--steps_per_save", "1000", "--save_only_latest_checkpoint", "False",
    "--machine.seed", "42", "--log-gradients", "True", "--pipeline.num_classes", "6",
    "--pipeline.model.far-plane", "1000", "--pipeline.model.near_plane", "0.05",
    "--pipeline.model.background-color", "random",
    "--pipeline.model.spectral_loss_weight", "5.0", "--pipeline.model.temperature", "0.4",
    "--pipeline.model.pred_dino", "False", "--pipeline.model.pred_specular", "True",
    "--pipeline.model.load_vca", "True", "--pipeline.model.implementation", "tcnn",
    "--pipeline.datamanager.images-on-gpu", "True", "--pipeline.datamanager.patch-size", "1",
    "--pipeline.datamanager.train-num-rays-per-batch", "4096",
    "--pipeline.model.method", "rgb+spectral", "--data", "data/processed/hotdog",
    "--experiment-name", "hotdog-t0.4-k6-specular", "--vis", "console",
]
# README.md's Usage
README_ARGV = [
    "--data", "data/processed/hotdog", "--pipeline.num_classes", "6",
    "--pipeline.model.method", "rgb+spectral", "--pipeline.model.temperature", "0.4",
    "--pipeline.model.pred_specular", "True", "--pipeline.model.load_vca", "True",
    "--pipeline.datamanager.train-num-rays-per-batch", "4096",
    "--experiment-name", "hotdog-t0.4-k6", "--vis", "console",
]
# values that a YAML writer must quote or spell with care
AWKWARD_ARGV = [
    "--experiment-name", "True", "--trainer.method-name", "1.0",
    "--pipeline.datamanager.dataparser.vca-cache", "null",
    "--optimizers.fields.optimizer.eps", "1e-15", "--pipeline.model.near-plane", "1e-20",
    "--pipeline.model.far-plane", "inf", "--pipeline.model.render-step-size", "None",
    "--pipeline.datamanager.dataparser.downscale-factor", "2",
    "--output-dir", "out dir/x: y", "--trainer.eval-seg-dump-dir", "seg dump",
    "--load-step", "None", "--trainer.adapt-steps", "64 176,304",
    "--pipeline.model.stage-boundaries", "8,16,24", "--pipeline.model.method", "yes",
    "--pipeline.model.hash-interpolation", "'quoted'",
]
ARGVS = {"defaults": [], "reference": REFERENCE_ARGV, "readme": README_ARGV,
         "awkward": AWKWARD_ARGV}


def _both(argv):
    jcfg, jign = J.apply_cli_overrides(J.umhs_method_defaults(), list(argv))
    tcfg, tign = T.apply_cli_overrides(T.umhs_method_defaults(), list(argv))
    return jcfg, jign, tcfg, tign


def _shared(plain):
    """A _to_plain tree without the fields that only umhs_tpu's dataclasses
    have."""
    if isinstance(plain, dict):
        cls = plain.get("__dataclass__")
        return {k: _shared(v) for k, v in plain.items() if (cls, k) not in T.JAX_ONLY}
    if isinstance(plain, list):
        return [_shared(x) for x in plain]
    return plain


@pytest.mark.parametrize("name", list(PAIRS))
def test_shared_fields_have_the_jax_defaults(name):
    jcls, tcls = PAIRS[name]
    jdef, tdef = jcls(), tcls()
    shared = {f.name for f in dataclasses.fields(jcls)} & {f.name for f in dataclasses.fields(tcls)}
    assert shared
    for field in sorted(shared):
        a, b = getattr(jdef, field), getattr(tdef, field)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f"{name}.{field}: umhs_tpu {a!r}, umhs_torch {b!r}"
    # every field the port lacks is one that JAX_ONLY accounts for
    missing = {f.name for f in dataclasses.fields(jcls)} - shared
    assert {(name, f) for f in missing} <= set(T.JAX_ONLY)


def test_hash_grid_backward_defaults_to_exact():
    assert t_enc.HashEncodingConfig().stochastic_grad is False
    assert j_enc.HashEncodingConfig().stochastic_grad is False
    # the model still asks for the stochastic backward, as umhs_tpu's does
    assert t_model.ModelConfig().stochastic_hash_grad is True


@pytest.mark.parametrize("case", list(ARGVS))
def test_argv_resolves_to_the_jax_values(case):
    jcfg, jign, tcfg, tign = _both(ARGVS[case])
    assert _shared(T._to_plain(tcfg)) == _shared(J._to_plain(jcfg))
    assert tcfg.pipeline.model.pred_dino == jcfg.pipeline.model.pred_dino
    assert set(tign) == set(jign)


def test_reference_flags_parse():
    cfg, ignored = T.apply_cli_overrides(T.umhs_method_defaults(), REFERENCE_ARGV)
    assert cfg.pipeline.num_classes == 6 and cfg.trainer.seed == 42
    assert cfg.trainer.log_gradients is True and cfg.trainer.vis == "console"
    assert cfg.pipeline.model.temperature == 0.4 and cfg.pipeline.model.pred_specular is True
    assert cfg.pipeline.datamanager.dataparser.data == Path("data/processed/hotdog")
    assert {"pipeline.model.implementation", "pipeline.datamanager.images_on_gpu"} <= set(
        ignored)
    assert cfg.pipeline.model.pred_dino is False and "pipeline.model.pred_dino" not in ignored


@pytest.mark.parametrize("argv", [["--pipeline.model.nope", "1"], ["--nope", "1"],
                                  ["--pipeline.nope.x", "1"], ["--trainer.optimizer.beta", "1"]],
                         ids=["model", "top", "nested", "optimizer"])
def test_unknown_flags_raise(argv):
    with pytest.raises(KeyError):
        T.apply_cli_overrides(T.umhs_method_defaults(), argv)


def test_flag_syntax():
    cfg, _ = T.apply_cli_overrides(T.umhs_method_defaults(), [
        "--pipeline.model.temperature=0.7", "--pipeline.model.stage-boundaries", "8,16",
        "--trainer.adapt-steps", "256 368 512", "--pipeline.model.render-step-size", "0.01",
        "--pipeline.datamanager.dataparser.downscale-factor", "2", "--load-dir", "None"])
    assert cfg.pipeline.model.temperature == 0.7
    assert cfg.pipeline.model.stage_boundaries == (8, 16)
    assert cfg.trainer.adapt_steps == (256, 368, 512)
    assert cfg.pipeline.model.render_step_size == 0.01
    assert cfg.pipeline.datamanager.dataparser.downscale_factor == 2
    assert cfg.trainer.load_dir is None
    cfg, _ = T.apply_cli_overrides(cfg, ["--pipeline.model.render-step-size", "none"])
    assert cfg.pipeline.model.render_step_size is None
    with pytest.raises(ValueError):
        T.apply_cli_overrides(cfg, ["--mixed-precision", "maybe"])
    with pytest.raises(ValueError):
        T.apply_cli_overrides(cfg, ["--mixed-precision"])
    with pytest.raises(ValueError):
        T.apply_cli_overrides(cfg, ["mixed-precision", "True"])


@pytest.mark.parametrize("case", list(ARGVS))
def test_saved_config_reads_as_the_jax_file(case, tmp_path):
    """yaml.safe_load of the port's config.yml equals yaml.safe_load of
    umhs_tpu's for the same flags, on the shared fields."""
    jcfg, _, tcfg, _ = _both(ARGVS[case])
    J.save_config(jcfg, tmp_path / "jax.yml")
    T.save_config(tcfg, tmp_path / "torch.yml")
    ours = yaml.safe_load((tmp_path / "torch.yml").read_text())
    theirs = yaml.safe_load((tmp_path / "jax.yml").read_text())
    assert ours == _shared(theirs)
    # and the port reads its own file back to the same config
    assert T.load_config(tmp_path / "torch.yml") == tcfg


def test_default_config_text_is_pyyaml_s():
    plain = T._to_plain(T.umhs_method_defaults())
    assert T.dump_yaml(plain) == yaml.safe_dump(plain, sort_keys=False)


@pytest.mark.parametrize("case", list(ARGVS))
def test_jax_written_file_loads_in_the_port(case, tmp_path, capsys):
    jcfg, _, tcfg, _ = _both(ARGVS[case])
    J.save_config(jcfg, tmp_path / "config.yml")
    got, inert = T.read_config(tmp_path / "config.yml")
    assert got == tcfg
    assert {"trainer.fast_compile_effort", "pipeline.model.hash_split_dense_gather"} <= set(
        inert)
    assert "trainer.use_mesh" not in inert and got.trainer.use_mesh == jcfg.trainer.use_mesh
    assert not {"pipeline.model.sampler", "pipeline.model.num_proposal_samples"} & set(inert)
    assert got.pipeline.model.num_proposal_samples == (256, 96)
    assert got.pipeline.model.sampler == "occgrid"
    assert T.load_config(tmp_path / "config.yml") == tcfg
    assert "inert fields" in capsys.readouterr().out


@pytest.mark.parametrize("case", list(ARGVS))
def test_port_written_file_loads_in_jax(case, tmp_path):
    jcfg, _, tcfg, _ = _both(ARGVS[case])
    T.save_config(tcfg, tmp_path / "config.yml")
    got = J.load_config(tmp_path / "config.yml")
    assert _shared(J._to_plain(got)) == _shared(J._to_plain(jcfg))


def test_inert_flags_are_recorded():
    base = T.umhs_method_defaults()
    argv = ["--trainer.use-mesh", "False", "--trainer.fuse-occ-update", "False",
            "--trainer.fast-compile-effort", "None", "--trainer.background-full-compile", "False",
            "--trainer.full-compile-defer-chunks", "7",
            "--pipeline.model.hash-split-dense-gather", "True",
            "--pipeline.model.num-nerf-samples", "64",
            "--pipeline.model.num-proposal-samples", "128,64",
            "--pipeline.model.interlevel-loss-mult", "2.0",
            "--pipeline.model.distortion-loss-mult", "0.01",
            "--pipeline.model.sampler", "occgrid", "--machine.num-devices", "4"]
    cfg, ignored = T.apply_cli_overrides(base, argv)
    # the proposal sampler's fields are real fields now: applied, not recorded
    # so is use_mesh (data parallel over the cards)
    assert cfg == dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, use_mesh=False), pipeline=dataclasses.replace(
        base.pipeline, model=dataclasses.replace(
            base.pipeline.model, num_nerf_samples=64, num_proposal_samples=(128, 64),
            interlevel_loss_mult=2.0, distortion_loss_mult=0.01, sampler="occgrid")))
    assert ignored == {
        "trainer.fuse_occ_update": "False",
        "trainer.fast_compile_effort": "None", "trainer.background_full_compile": "False",
        "trainer.full_compile_defer_chunks": "7",
        "pipeline.model.hash_split_dense_gather": "True",
        "machine.num_devices": "4"}
    for (_, _), (kind, _, why) in T.JAX_ONLY.items():
        assert kind == "inert" and why


@pytest.mark.parametrize("flag,value", [("sampler", "proposal"), ("pred_dino", "True")])
def test_later_slices_raise(flag, value, tmp_path):
    """The two features the port once refused (the proposal sampler, the DINO
    head) now resolve: the flag gives the JAX package's config, and a
    config.yml the JAX package wrote with it loads to the same values."""
    argv = [f"--pipeline.model.{flag}", value]
    tcfg, tign = T.apply_cli_overrides(T.umhs_method_defaults(), argv)
    jcfg, jign = J.apply_cli_overrides(J.umhs_method_defaults(), argv)
    assert _shared(T._to_plain(tcfg)) == _shared(J._to_plain(jcfg))
    assert getattr(tcfg.pipeline.model, flag) == getattr(jcfg.pipeline.model, flag)
    assert getattr(tcfg.pipeline.model, flag) != getattr(T.umhs_method_defaults().pipeline.model,
                                                         flag)
    assert tign == jign == {}
    J.save_config(jcfg, tmp_path / "config.yml")
    got, inert = T.read_config(tmp_path / "config.yml")
    assert got == tcfg
    assert f"pipeline.model.{flag}" not in inert


def test_impl_is_left_out_at_its_default(tmp_path):
    cfg = T.umhs_method_defaults()
    T.save_config(cfg, tmp_path / "a.yml")
    assert "impl" not in yaml.safe_load((tmp_path / "a.yml").read_text())["pipeline"]["model"]
    plain = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, model=dataclasses.replace(cfg.pipeline.model, impl="plain")))
    T.save_config(plain, tmp_path / "b.yml")
    assert T.load_config(tmp_path / "b.yml") == plain
    assert J.load_config(tmp_path / "b.yml").pipeline.model.method == "rgb"


def test_unknown_yml_fields_raise(tmp_path):
    text = T.dump_yaml(T._to_plain(T.umhs_method_defaults()))
    (tmp_path / "a.yml").write_text(text.replace("  seed: 42\n", "  seed: 42\n  nope: 1\n"))
    with pytest.raises(KeyError, match="nope"):
        T.load_config(tmp_path / "a.yml")
    (tmp_path / "b.yml").write_text(text.replace("__dataclass__: FullConfig",
                                                 "__dataclass__: OtherConfig"))
    with pytest.raises(KeyError, match="OtherConfig"):
        T.load_config(tmp_path / "b.yml")


SCALARS = {
    "true_str": "True", "one_str": "1.0", "null_str": "null", "tiny": 1e-15, "inf": math.inf,
    "neg_inf": -math.inf, "empty": "", "exp_str": "1e-15", "yes_str": "yes", "space": "a b",
    "colon": "x: y", "dash": "-", "one": 1.0, "big": 3e20, "sum": 0.1 + 0.2, "tilde": "~",
    "hex_str": "0x1F", "oct_str": "012", "under_str": "1_000", "inf_str": ".inf", "on_str": "on",
    "date_str": "2001-01-01", "hash": "#a", "lead": " lead", "newline": "multi\nline",
    "huge": 12345678901234567890, "neg_zero": -0.0, "e16": 1e16, "at": "@x", "inner_hash": "a#b",
    "space_hash": "a #b", "quote": "'q", "dquote": '"q', "bracket": "[x]", "unicode": "é ñ",
    "control": "\x07\x7f\x85", "none": None, "t": True, "f": False, "neg": -5,
    "list": [1, "True", None, 2.5, "x"], "empty_list": [], "nested": {"a": {"b": [1e-20]}},
    "dash_word": "-x", "plus": "rgb+spectral", "dot": ".", "rel": "./data", "nan_str": "NaN",
    "merge": "<<", "eq": "=", "bin_str": "0b101", "sexa_str": "1:20", "plus_one": "+1",
    "half": ".5", "path": "/tmp/out dir/x",
}


def test_yaml_scalars_round_trip_through_pyyaml():
    text = T.dump_yaml(SCALARS)
    for reader in (yaml.safe_load, T.load_yaml):
        back = reader(text)
        assert list(back) == list(SCALARS)
        for k, v in SCALARS.items():
            assert back[k] == v and type(back[k]) is type(v), (reader, k, v, back[k])
    # the port's reader on PyYAML's own text (one line per scalar)
    flat = {k: v for k, v in SCALARS.items() if k not in ("newline",)}
    back = T.load_yaml(yaml.safe_dump(flat, sort_keys=False))
    assert back == flat
    assert math.isnan(T.load_yaml(T.dump_yaml({"x": math.nan}))["x"])
    assert math.isnan(yaml.safe_load(T.dump_yaml({"x": math.nan}))["x"])
    with pytest.raises(ValueError):
        T.dump_yaml({"on": 1})


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a: {b: 1}\n", "a: 'open\n", "a: &x 1\n",
                                  "a:\n  - b: 1\n", "a: 1 # c\n", "- 1\n", "a: 1\n  b: 2\n",
                                  "a: 2001-01-01\n", "a: |\n  x\n", "yes: 1\n"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        T.load_yaml(text)


def test_use_mesh_is_a_real_field(tmp_path):
    """use_mesh is TrainerConfig's own field with the JAX default (True),
    not an inert JAX-only one: the flag sets it and config.yml keeps it.
    --machine.num-devices stays accepted and inert, as in the JAX package
    (the mesh takes every visible card)."""
    assert ("TrainerConfig", "use_mesh") not in T.JAX_ONLY
    fields = {f.name: f.default for f in dataclasses.fields(T.TrainerConfig)}
    assert fields["use_mesh"] is True
    assert fields["use_mesh"] == {f.name: f.default for f in
                                  dataclasses.fields(J.TrainerConfig)}["use_mesh"]
    base = T.umhs_method_defaults()
    cfg, ignored = T.apply_cli_overrides(base, ["--trainer.use-mesh", "False"])
    assert cfg.trainer.use_mesh is False and not ignored
    T.save_config(cfg, tmp_path / "config.yml")
    assert T.load_config(tmp_path / "config.yml").trainer.use_mesh is False
    assert J.load_config(tmp_path / "config.yml").trainer.use_mesh is False
    cfg, ignored = T.apply_cli_overrides(base, ["--machine.num-devices", "4"])
    assert cfg == base and ignored == {"machine.num_devices": "4"}
