"""The port's CLIs on the CPU (`--device cpu`): `python -m
umhs_torch.cli.train` on a 16^2 scene for 32 steps, then cli.eval, cli.render
and the viewer's HTTP surface on the run it wrote; select_output, the
camera-path cameras and the viewer's orbit camera held to umhs_tpu's; and
every CLI refusing to run without a card unless asked for the CPU."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.cli import render as j_render
from umhs_tpu.cli import viewer as j_viewer
from umhs_tpu.data.cameras import generate_camera_rays as j_rays
from umhs_torch.cli import eval as t_eval
from umhs_torch.cli import render as t_render
from umhs_torch.cli import split_device
from umhs_torch.cli import train as t_train
from umhs_torch.cli import viewer as t_viewer
from umhs_torch.data.cameras import generate_camera_rays as t_rays
from umhs_torch.data.png import read_png
from umhs_torch.data.synthetic import SyntheticSceneConfig, write_dataset

ROOT = Path(__file__).resolve().parent.parent
SCENE = SyntheticSceneConfig(num_views_train=4, num_views_eval=2, image_size=16, num_bands=8,
                             num_spheres=2)
STEPS = 32
TRAIN_FLAGS = [
    "--pipeline.num_classes", "2", "--pipeline.model.method", "rgb+spectral",
    "--pipeline.model.load_vca", "True", "--pipeline.model.pred_specular", "True",
    "--pipeline.model.grid-resolution", "16", "--pipeline.model.grid-levels", "1",
    "--pipeline.model.march-pool", "0", "--pipeline.model.hash-num-levels", "4",
    "--pipeline.model.log2-hashmap-size", "10", "--pipeline.model.max-res", "64",
    "--pipeline.model.num-candidates", "128", "--pipeline.model.max-samples-per-ray", "32",
    "--pipeline.model.cone-angle", "0.0", "--pipeline.model.stage-boundaries", "8,16",
    "--pipeline.model.eval-num-rays-per-chunk", "256", "--pipeline.model.pred_dino", "False",
    "--pipeline.datamanager.train-num-rays-per-batch", "256",
    "--pipeline.datamanager.eval-num-rays-per-batch", "128",
    "--max-num-iterations", str(STEPS), "--steps_per_save", str(STEPS), "--steps-per-log", "16",
    "--log-gradients", "True", "--mixed-precision", "False", "--experiment-name", "cli",
    "--vis", "console", "--machine.num-devices", "1",
]
CAMERA_PATH = {
    "render_height": 12, "render_width": 12, "fps": 2,
    "camera_path": [{"camera_to_world": [1, 0, 0, 0.1 * i, 0, 0, -1, -0.9, 0, 1, 0, 0, 0, 0, 0, 1],
                     "fov": 60.0 - 5 * i} for i in range(2)],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """`python -m umhs_torch.cli.train umhsnerf ... --device cpu` in a fresh
    process, in its own working directory (parsing writes vca.npy there)."""
    work = tmp_path_factory.mktemp("cli")
    root = write_dataset(work / "scene", SCENE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT)] + [os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "umhs_torch.cli.train", "umhsnerf", "--data", str(root),
         *TRAIN_FLAGS, "--device", "cpu"],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return SimpleNamespace(work=work, run_dir=work / "outputs" / "cli" / "umhsnerf",
                           stdout=proc.stdout)


def test_train_writes_the_run(run):
    run_dir = run.run_dir
    assert {"config.yml", "metrics.jsonl", "final_metrics.json", "umhs_models"} <= {
        p.name for p in run_dir.iterdir()}
    assert [p.name for p in (run_dir / "umhs_models").iterdir()] == [f"step-{STEPS:09d}"]
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [16, 32]
    assert {"step", "t", "loss/total", "psnr", "grad_norm/total", "grad_norm/hash_table",
            "grad_norm/endmembers"} <= set(records[0])
    final = json.loads((run_dir / "final_metrics.json").read_text())
    assert {"psnr", "psnr_spectral", "sam_spectral"} <= set(final["eval"])
    assert final["train"]["loss/total"] == records[-1]["loss/total"]
    assert "device=cpu" in run.stdout and "accepted-but-inert flags" in run.stdout


def test_eval_reproduces_the_final_metrics(run, monkeypatch):
    monkeypatch.chdir(run.work)
    result = t_eval.main(["--load-config", str(run.run_dir / "config.yml"),
                          "--output-path", "eval.json", "--device", "cpu"])
    final = json.loads((run.run_dir / "final_metrics.json").read_text())
    assert result["checkpoint_step"] == STEPS and result["experiment_name"] == "cli"
    assert result["results"] == final["eval"]
    assert json.loads((run.work / "eval.json").read_text()) == result


def test_render_writes_tiled_frames(run, monkeypatch):
    monkeypatch.chdir(run.work)
    (run.work / "path.json").write_text(json.dumps(CAMERA_PATH))
    names = ["rgb", "abundances_0", "wv_3", "seg_pred", "depth", "residual_1"]
    result = t_render.main(["camera-path", "--load-config", str(run.run_dir / "config.yml"),
                            "--camera-path-filename", "path.json",
                            "--output-path", "renders/out.mp4", "--device", "cpu",
                            "--rendered-output-names", *names])
    assert len(result.images) == 2 and len(result.frame_s) == 2
    assert result.images[0].shape == (12, 12 * len(names), 3)
    assert result.images[0].dtype == np.uint8
    if result.written.is_dir():  # PNG frames where imageio cannot write an mp4
        frames = sorted(result.written.glob("frame_*.png"))
        assert len(frames) == 2
        for frame, img in zip(frames, result.images):
            np.testing.assert_array_equal(read_png(frame), img)
    else:
        assert result.written == Path("renders/out.mp4") and result.written.is_file()


def test_viewer_http_surface(run, monkeypatch):
    monkeypatch.chdir(run.work)
    server = t_viewer.make_server(["--load-config", str(run.run_dir / "config.yml"),
                                   "--port", "0", "--resolution", "12", "--device", "cpu"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert b"umhs_torch viewer" in urllib.request.urlopen(base + "/", timeout=60).read()
        names = json.loads(urllib.request.urlopen(base + "/outputs", timeout=60).read())
        assert names[:4] == ["rgb", "depth", "accumulation", "seg_pred"]
        assert "abundances_1" in names and "residual_0" in names and "wv_0" in names
        for out in ("rgb", "depth", "abundances_0"):
            png = urllib.request.urlopen(
                f"{base}/render?theta=1.0&phi=0.4&radius=1.2&fov=50&output={out}",
                timeout=60).read()
            (run.work / "view.png").write_bytes(png)
            img = read_png(run.work / "view.png")
            assert img.shape == (12, 12, 3)
            want = server.state.render_view(1.0, 0.4, 1.2, 50.0, out)
            np.testing.assert_array_equal(img, want)
        for path, code in (("/render?output=nope", 500), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + path, timeout=60)
            assert err.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_every_cli_needs_the_card_unless_asked_for_the_cpu(run, monkeypatch):
    monkeypatch.chdir(run.work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = str(run.run_dir / "config.yml")
    calls = [
        lambda: t_train.main(["umhsnerf", "--data", "scene", *TRAIN_FLAGS]),
        lambda: t_eval.main(["--load-config", config]),
        lambda: t_render.main(["camera-path", "--load-config", config]),
        lambda: t_viewer.make_server(["--load-config", config, "--port", "0"]),
        lambda: t_train.main(["umhsnerf", "--device", "cuda"], device="cpu"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_split_device():
    assert split_device(["--a", "1", "--device", "cpu"]) == (["--a", "1"], torch.device("cpu"))
    assert split_device(["--device=cpu", "--a", "1"]) == (["--a", "1"], torch.device("cpu"))
    assert split_device(["--a", "1"], "cpu") == (["--a", "1"], torch.device("cpu"))
    with pytest.raises(ValueError):
        split_device(["--device"])


OUTPUT_NAMES = ["rgb", "seg_pred", "specular", "accumulation", "depth", "wv_0", "wv_5",
                "abundances_0", "abundances_2", "residual_3"]


@pytest.mark.parametrize("name", OUTPUT_NAMES + ["nope"])
def test_select_output_matches_jax(name):
    rng = np.random.default_rng(len(name))
    outputs = {k: rng.uniform(-0.2, 1.3, (6, 7, c)).astype(np.float32) for k, c in (
        ("rgb", 3), ("seg_pred", 3), ("specular", 8), ("accumulation", 1), ("depth", 1),
        ("spectral", 8), ("abundances", 3))}
    if name == "nope":
        for mod in (t_render, j_render):
            with pytest.raises(KeyError):
                mod.select_output(outputs, name)
        return
    got = t_render.select_output(outputs, name)
    assert got.shape == (6, 7, 3)
    np.testing.assert_array_equal(got, j_render.select_output(outputs, name))


def _rays_both(cam_np, h, w):
    t_cam = {k: torch.as_tensor(v) for k, v in cam_np.items()}
    j_cam = {k: jnp.asarray(v) for k, v in cam_np.items()}
    return t_rays(t_cam, 0, h, w), j_rays(j_cam, 0, h, w)


def test_camera_path_cameras_match_jax():
    frames, h, w = t_render.cameras_from_path_json(CAMERA_PATH)
    j_frames, jh, jw = j_render.cameras_from_path_json(CAMERA_PATH)
    assert (h, w) == (jh, jw) == (12, 12)
    assert t_render.cameras_from_path_json({"camera_path": []}) == ([], 256, 256)
    for fr, jf in zip(frames, j_frames):
        np.testing.assert_array_equal(fr["c2w"], jf["c2w"])
        assert fr["focal"] == jf["focal"]
        cam = t_render.camera_dict(fr["c2w"], fr["focal"], h, w, "cpu")
        t, j = _rays_both({k: v.numpy() for k, v in cam.items()}, h, w)
        for key in ("origins", "directions"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), rtol=0, atol=1e-6)


class _CaptureTrainer:
    """Stands in for a trainer: render_camera records the rays it is given."""

    def __init__(self, torch_side):
        self.rays, self.torch_side = None, torch_side
        self.device = torch.device("cpu")
        self.model = SimpleNamespace(config=SimpleNamespace(method="rgb", pred_specular=False),
                                     wavelengths=[], num_classes=2)
        self.model_config = self.model.config

    def render_camera(self, rays, hw):
        self.rays = rays
        zeros = np.zeros((*hw, 3), np.float32)
        return {"rgb": torch.from_numpy(zeros) if self.torch_side else jnp.asarray(zeros)}


@pytest.mark.parametrize("view", [(0.8, 0.5, 1.0, 50.0), (2.5, -0.3, 1.7, 30.0),
                                  (0.0, 1.4, 0.5, 80.0)])
def test_viewer_orbit_camera_matches_jax(view):
    t_tr, j_tr = _CaptureTrainer(True), _CaptureTrainer(False)
    t_img = t_viewer.ViewerState(t_tr, resolution=10).render_view(*view, "rgb")
    j_img = j_viewer.ViewerState(j_tr, resolution=10).render_view(*view, "rgb")
    np.testing.assert_array_equal(t_img, j_img)
    for key in ("origins", "directions"):
        np.testing.assert_allclose(t_tr.rays[key].numpy(), np.asarray(j_tr.rays[key]),
                                   rtol=0, atol=1e-6)
    assert t_viewer.ViewerState(t_tr).output_names() == j_viewer.ViewerState(j_tr).output_names()
