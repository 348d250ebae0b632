"""The port's aux modules against umhs_tpu's on the CPU: hooks, profiler,
writer (and the trainer's metrics.jsonl and gradient norms), prep and
explore, each on the same inputs or files."""

import json
import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from umhs_tpu.data import explore as j_explore
from umhs_tpu.data import prep as j_prep
from umhs_tpu.utils import hooks as j_hooks
from umhs_tpu.utils import writer as j_writer
from umhs_torch.data import explore as t_explore
from umhs_torch.data import prep as t_prep
from umhs_torch.data.png import png_bytes, read_png, write_png
from umhs_torch.utils import hooks as t_hooks
from umhs_torch.utils import profiler as t_profiler
from umhs_torch.utils import writer as t_writer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- hooks
def _tree(bad_leaf, kind):
    vals = [np.ones(3, np.float32), np.arange(4), np.full((2, 2), 0.5, np.float32)]
    if bad_leaf is not None:
        vals[bad_leaf] = np.array([1.0, np.nan if kind == "nan" else np.inf], np.float32)
    return {"b": [vals[1], (vals[2],)], "a": vals[0]}


@pytest.mark.parametrize("bad_leaf,kind", [(None, None), (0, "nan"), (2, "inf"), (1, "nan")])
@pytest.mark.parametrize("leaf_type", ["tensor", "array"])
def test_assert_finite_matches_jax(bad_leaf, kind, leaf_type):
    tree = _tree(bad_leaf, kind)
    j_tree = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0]),
                                                   (jnp.asarray(tree["b"][1][0]),)]}
    if leaf_type == "tensor":
        tree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0]),
                                                        (torch.from_numpy(tree["b"][1][0]),)]}
    try:
        j_hooks.assert_finite(j_tree, "x")
        want = None
    except FloatingPointError as e:
        want = str(e)
    if want is None:
        t_hooks.assert_finite(tree, "x")
    else:
        with pytest.raises(FloatingPointError) as got:
            t_hooks.assert_finite(tree, "x")
        assert str(got.value) == want


def test_checkify_nan():
    f = t_hooks.checkify_nan(torch.log)
    torch.testing.assert_close(f(torch.ones(3)), torch.zeros(3))
    with pytest.raises(FloatingPointError):
        f(torch.zeros(3) - 1.0)


def test_enable_nan_checks_is_autograd_anomaly_mode():
    try:
        t_hooks.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        t_hooks.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------- profiler
def test_time_function_records():
    @t_profiler.time_function
    def work():
        return 42

    assert work() == 42 and work() == 42
    assert len(t_profiler._TIMINGS[work.__qualname__]) == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with t_profiler.trace(tmp_path / "profiles", device="cpu") as path:
        (x @ x).sum()
    assert path.parent == tmp_path / "profiles" and path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with t_profiler.trace(tmp_path):
            pass


# ------------------------------------------------------------------ writer
METRICS = {"psnr": 21.5, "loss/total": 0.125, "rays_per_batch": 4096, "grad_norm/total": 1e-3}


def test_console_writer_writes_the_jax_jsonl(tmp_path, capsys):
    t_writer.ConsoleWriter(tmp_path / "t" / "m.jsonl").write(5, METRICS)
    t_out = capsys.readouterr().out
    j_writer.ConsoleWriter(tmp_path / "j" / "m.jsonl").write(5, METRICS)
    j_out = capsys.readouterr().out
    assert t_out == j_out
    ours = json.loads((tmp_path / "t" / "m.jsonl").read_text())
    theirs = json.loads((tmp_path / "j" / "m.jsonl").read_text())
    assert list(ours) == list(theirs) == ["step", "t", *METRICS]
    assert {k: v for k, v in ours.items() if k != "t"} == {
        k: v for k, v in theirs.items() if k != "t"}


@pytest.mark.parametrize("vis", ["console", "nonexistent+console", "wandb", "", "viewer,console"])
def test_make_writer_matches_jax(vis, tmp_path, capsys):
    t = t_writer.make_writer(vis, tmp_path / "t")
    t_msg = capsys.readouterr().out
    j = j_writer.make_writer(vis, tmp_path / "j")
    j_msg = capsys.readouterr().out
    assert [type(w).__name__ for w in t.writers] == [type(w).__name__ for w in j.writers]
    assert t_msg.replace(str(tmp_path / "t"), "") == j_msg.replace(str(tmp_path / "j"), "")
    t.write(1, {"x": 1.0})
    t.write_image(1, "img", np.zeros((2, 2, 3)))
    t.close()
    assert json.loads((tmp_path / "t" / "metrics.jsonl").read_text().splitlines()[0])["x"] == 1.0


def test_tensorboard_writer(tmp_path, monkeypatch):
    """The backend's calls, with a stand-in SummaryWriter (the real one
    imports TensorFlow where it is installed, ~15 s)."""
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, k, v, step):
            calls.append(("scalar", k, v, step))

        def add_image(self, name, img, step, dataformats):
            calls.append(("image", name, img.shape, float(img.max()), step, dataformats))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    w = t_writer.make_writer("tensorboard+console", tmp_path)
    assert [type(x).__name__ for x in w.writers] == ["TensorboardWriter", "ConsoleWriter"]
    w.write(3, {"psnr": 20.0, "label": "not a number"})
    w.write_image(3, "img", np.full((4, 4, 3), 1.5))
    w.close()
    assert calls == [("init", str(tmp_path / "tb")), ("scalar", "psnr", 20.0, 3),
                     ("image", "img", (4, 4, 3), 1.0, 3, "HWC"), ("close",)]


def test_trainer_logs_gradient_norms(tmp_path, monkeypatch):
    """With log_gradients the step's metrics carry the global L2 norms of
    the gradients Adam receives (optax.global_norm over the same arrays),
    and metrics.jsonl under run_dir holds the logged steps."""
    from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
    from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
    from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves
    from umhs_torch.models.model import ModelConfig

    monkeypatch.chdir(tmp_path)
    scene = SyntheticSceneConfig(num_views_train=2, image_size=8, num_bands=4, num_spheres=1)
    poses, cubes, rgba = render_views(scene, 2, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=64),
                             wavelengths=scene.wavelengths, device="cpu")
    model = ModelConfig(method="rgb+spectral", grid_resolution=16, grid_levels=1, march_pool=0,
                        hash_num_levels=2, log2_hashmap_size=8, max_res=32, num_candidates=64,
                        max_samples_per_ray=16, cone_angle=0.0, stage_boundaries=())
    cfg = TrainerConfig(log_gradients=True, mixed_precision=False, steps_per_log=1,
                        save_final=False, output_dir=tmp_path / "out", dynamic_batching=False)
    t = Trainer(cfg, model, num_classes=2, device="cpu", datamanager=dm).setup()
    draws = t.draw_step()
    t.loss_and_grads(draws)
    grads = {n: p.grad.numpy().copy() for n, p in named_leaves(t.state["params"])
             if p.grad is not None}
    norms = {k: float(v) for k, v in t.gradient_norms().items()}
    assert set(norms) == {"grad_norm/total", "grad_norm/hash_table", "grad_norm/endmembers"}
    np.testing.assert_allclose(norms["grad_norm/total"],
                               float(optax.global_norm([jnp.asarray(g) for g in grads.values()])),
                               rtol=1e-6)
    np.testing.assert_allclose(norms["grad_norm/hash_table"],
                               float(optax.global_norm(jnp.asarray(grads["hash_table"]))),
                               rtol=1e-6)
    np.testing.assert_allclose(norms["grad_norm/endmembers"],
                               float(optax.global_norm(jnp.asarray(grads["endmembers"]))),
                               rtol=1e-6)
    t.train(16)
    assert all(k in t.history[-1]["metrics"] for k in norms)
    records = [json.loads(line) for line in (t.run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [16]
    assert {"step", "t", "loss/total", "grad_norm/total", "rays_per_sec"} <= set(records[0])
    # without the flag the step carries none
    t2 = Trainer(TrainerConfig(mixed_precision=False, save_final=False,
                               output_dir=tmp_path / "out2"), model, num_classes=2, device="cpu",
                 datamanager=dm).setup()
    assert not any(k.startswith("grad_norm/") for k in t2.train_step())


# -------------------------------------------------------------------- prep
def test_transform_edits_match_jax(tmp_path):
    meta = {"camera_angle_x": 0.6911, "frames": [{"file_path": "train/r_0.png"},
                                                  {"file_path": "train/r_1"}]}
    for side in ("j", "t"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "transforms.json").write_text(json.dumps(meta))
        (tmp_path / side / "val.json").write_text(json.dumps({"frames": [{"f": 1}]}))
        (tmp_path / side / "train.json").write_text(json.dumps({"frames": [{"f": 2}], "fl_x": 5}))
    for side, mod in (("j", j_prep), ("t", t_prep)):
        d = tmp_path / side
        assert mod.add_camera_params(d / "transforms.json", 640, 480)["camera_model"] == "OPENCV"
        mod.add_hyperspectral_paths(d / "transforms.json")
        mod.merge_transforms(d / "val.json", d / "train.json", d / "merged.json")
    for name in ("transforms.json", "merged.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    out = json.loads((tmp_path / "t" / "transforms.json").read_text())
    assert abs(out["fl_x"] - 0.5 * 640 / math.tan(0.6911 / 2)) < 1e-9
    assert out["frames"][1]["hyperspectral_file_path"] == "train/r_1.npy"


def test_prep_main_matches_jax(tmp_path):
    meta = {"camera_angle_x": 0.5, "frames": [{"file_path": "a.png"}]}
    for side, mod in (("j", j_prep), ("t", t_prep)):
        (tmp_path / side).mkdir()
        p = tmp_path / side / "transforms.json"
        p.write_text(json.dumps(meta))
        mod.main(["add-camera-params", str(p)])
        mod.main(["add-hs-paths", str(p)])
    assert (tmp_path / "t" / "transforms.json").read_text() == (
        tmp_path / "j" / "transforms.json").read_text()
    with pytest.raises(SystemExit):
        t_prep.main(["nope"])


def test_spec_cube_png_matches_pillow(tmp_path):
    cube = np.random.default_rng(0).random((8, 9, 21)).astype(np.float32)
    t_prep.spec_cube_to_rgb_png(cube, t_prep.NESPOF_WAVELENGTHS, tmp_path / "t.png")
    j_prep.spec_cube_to_rgb_png(cube, j_prep.NESPOF_WAVELENGTHS, tmp_path / "j.png")
    ours = np.asarray(Image.open(tmp_path / "t.png"))
    assert ours.shape == (8, 9, 3)
    np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "j.png")))


@pytest.mark.parametrize("half", [False, True])
def test_exr_round_trip_is_exact(tmp_path, half):
    img = np.random.default_rng(3).random((9, 13)).astype(np.float32)
    t_prep.write_exr_minimal(tmp_path / "t.exr", img, half=half)
    j_prep.write_exr_minimal(tmp_path / "j.exr", img, half=half)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(t_prep.read_exr(tmp_path / "t.exr"), want)
    np.testing.assert_array_equal(j_prep.read_exr(tmp_path / "t.exr"), want)
    with pytest.raises(ValueError):
        t_prep.read_exr_minimal(tmp_path / "t.exr", channel="G")


def test_convert_nespof_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    truth = rng.random((2, 6, 7, len(t_prep.NESPOF_WAVELENGTHS))).astype(np.float32) * 1.2 - 0.1
    scene = tmp_path / "scene"
    for b, wl in enumerate(t_prep.NESPOF_WAVELENGTHS):
        d = scene / "train" / str(wl)
        d.mkdir(parents=True)
        for k in range(2):
            t_prep.write_exr_minimal(d / f"frame_{k}_s0.exr", truth[k, :, :, b], half=True)
            t_prep.write_exr_minimal(d / f"frame_{k}_s1.exr", truth[k, :, :, b])
    assert t_prep.convert_nespof_scene(scene, tmp_path / "t") == 2
    assert j_prep.convert_nespof_scene(scene, tmp_path / "j") == 2
    for k in range(2):
        ours = np.load(tmp_path / "t" / "train" / f"r_{k}.npy")
        np.testing.assert_array_equal(ours, np.load(tmp_path / "j" / "train" / f"r_{k}.npy"))
        assert ours.shape == (6, 7, 21) and ours.min() >= 0.0 and ours.max() <= 1.0
        np.testing.assert_array_equal(
            read_png(tmp_path / "t" / "train" / f"r_{k}.png"),
            np.asarray(Image.open(tmp_path / "j" / "train" / f"r_{k}.png")))
    with pytest.raises(FileNotFoundError):
        t_prep.convert_nespof_scene(scene, tmp_path / "x", split="val")


# ----------------------------------------------------------------- explore
def test_cube_stats_and_band_image_match_jax(tmp_path):
    cube = np.random.default_rng(1).random((8, 8, 5)).astype(np.float32) * 1.4 - 0.2
    np.save(tmp_path / "c.npy", cube)
    ours, theirs = t_explore.cube_stats(tmp_path / "c.npy"), j_explore.cube_stats(tmp_path / "c.npy")
    assert ours["shape"] == theirs["shape"] == (8, 8, 5) and ours["dtype"] == theirs["dtype"]
    for k in ("min", "max", "mean", "band_means"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6)
    img = t_explore.band_image(tmp_path / "c.npy", 2, tmp_path / "t.png")
    j_img = j_explore.band_image(tmp_path / "c.npy", 2, tmp_path / "j.png")
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_wavelength_curve_matches_jax(tmp_path):
    wl = list(range(450, 651, 10))
    ours = t_explore.wavelength_rgb_curve(wl, tmp_path / "curve.png")
    np.testing.assert_array_equal(ours, j_explore.wavelength_rgb_curve(wl))
    assert ours.shape == (21, 3)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not (tmp_path / "curve.png").exists()
    else:
        assert (tmp_path / "curve.png").is_file()


def test_png_bytes_is_the_written_file(tmp_path):
    img = (np.random.default_rng(2).random((5, 7, 3)) * 255).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    assert png_bytes(img) == (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)


def _module_level_imports(node):
    """Import statements outside any function body."""
    import ast

    out = []
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(child, (ast.Import, ast.ImportFrom)):
            out.append(child)
        out += _module_level_imports(child)
    return out


def test_no_optional_package_is_imported_at_module_level():
    """The card's machine has no PyYAML, Pillow, imageio, tensorboard, wandb
    or matplotlib: the port imports them, where at all, inside functions."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    optional = {"yaml", "PIL", "imageio", "tensorboard", "wandb", "matplotlib", "OpenEXR",
                "Imath"}
    for path in sorted((root / "umhs_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        names = set()
        for n in _module_level_imports(ast.parse(path.read_text())):
            if isinstance(n, ast.Import):
                names |= {a.name.split(".")[0] for a in n.names}
            elif n.module and n.level == 0:
                names.add(n.module.split(".")[0])
        assert not names & optional, f"{path.name} imports {names & optional} at module level"
