"""umhs_torch data: cameras and rays, the synthetic scene and VCA, against
umhs_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.data import cameras as j_cam
from umhs_tpu.data import synthetic as j_syn
from umhs_tpu.data import vca as j_vca
from umhs_torch.data import cameras as t_cam
from umhs_torch.data import synthetic as t_syn
from umhs_torch.data import vca as t_vca


def _cameras(mod, distortion):
    rng = np.random.default_rng(0)
    n = 3
    c2w = np.stack([t_syn._look_at(rng.normal(size=3) * 3.0, np.zeros(3))[:3] for _ in range(n)])
    kw = dict(camera_to_worlds=c2w.astype(np.float32), fx=np.full(n, 40.0), fy=np.full(n, 42.0),
              cx=np.full(n, 16.0), cy=np.full(n, 15.0), width=np.full(n, 32),
              height=np.full(n, 30))
    if distortion:
        kw["distortion_params"] = np.tile([0.05, -0.01, 0.002, 0.0, 0.001, -0.002], (n, 1))
    return mod.Cameras(**kw)


@pytest.mark.parametrize(
    "camera_type,distortion",
    [("PERSPECTIVE", False), ("OPENCV", True), ("OPENCV_FISHEYE", False),
     ("EQUIRECTANGULAR", False)],
)
def test_generate_rays_matches(camera_type, distortion):
    jd = _cameras(j_cam, distortion).to_device_dict()
    td = _cameras(t_cam, distortion).to_device_dict()
    assert sorted(jd) == sorted(td)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 3, 500).astype(np.int32)
    rows = rng.integers(0, 30, 500).astype(np.float32)
    cols = rng.integers(0, 32, 500).astype(np.float32)
    jr = j_cam.generate_rays(jd, jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(cols),
                             camera_type=camera_type)
    tr = t_cam.generate_rays(td, torch.from_numpy(idx), torch.from_numpy(rows),
                             torch.from_numpy(cols), camera_type=camera_type)
    for k in ("origins", "directions"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(tr["camera_indices"].numpy(), np.asarray(jr["camera_indices"]))


def test_generate_camera_rays_matches():
    jd, td = _cameras(j_cam, False).to_device_dict(), _cameras(t_cam, False).to_device_dict()
    jr = j_cam.generate_camera_rays(jd, 2, 30, 32)
    tr = t_cam.generate_camera_rays(td, 2, 30, 32)
    assert tr["origins"].shape == (30 * 32, 3)
    np.testing.assert_allclose(tr["directions"].numpy(), np.asarray(jr["directions"]),
                               rtol=1e-5, atol=2e-6)
    with pytest.raises(ValueError):
        t_cam.generate_rays(td, torch.zeros(1, dtype=torch.int32), torch.zeros(1),
                            torch.zeros(1), camera_type="ORTHO")


def test_synthetic_scene_matches():
    kw = dict(image_size=24, num_bands=12, num_spheres=5)
    jp, jc, ja = j_syn.render_views(j_syn.SyntheticSceneConfig(**kw), 3, 0.13)
    tp, tc, ta = t_syn.render_views(t_syn.SyntheticSceneConfig(**kw), 3, 0.13)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ta, ja)
    assert 0.05 < ta[..., 3].mean() < 0.95  # the spheres are in view


def test_bench_scene_is_benchs():
    s = t_syn.BENCH_SCENE
    assert (s.num_views_train, s.num_views_eval, s.image_size, s.num_bands, s.num_spheres) == (
        16, 2, 128, 128, 6)
    assert s.wavelengths[0] == 400.0 and s.wavelengths[-1] == 400.0 + 2.0 * 127


def test_scene_cameras_reproduce_the_scene_rays():
    cfg = t_syn.SyntheticSceneConfig(image_size=16, num_bands=4)
    poses, _, rgba = t_syn.render_views(cfg, 2, 0.0)
    cam = t_syn.scene_cameras(cfg, poses).to_device_dict()
    rays = t_cam.generate_camera_rays(cam, 1, 16, 16)
    # the traced alpha of each pixel from the port's own rays
    centers, radii, spectra = t_syn.make_spheres(cfg)
    _, alpha = t_syn._trace(rays["origins"].double().numpy(), rays["directions"].double().numpy(),
                            centers, radii, spectra)
    np.testing.assert_array_equal(alpha.reshape(16, 16), rgba[1, ..., 3])


@pytest.mark.parametrize("num_endmembers", [3, 6])
def test_vca_matches(num_endmembers):
    cfg = j_syn.SyntheticSceneConfig(image_size=24, num_bands=16, num_spheres=6)
    _, cubes, _ = j_syn.render_views(cfg, 1)
    np.testing.assert_array_equal(
        t_vca.vca_endmembers_from_cube(cubes[0], num_endmembers),
        j_vca.vca_endmembers_from_cube(cubes[0], num_endmembers))


def test_vca_rejects_bad_input():
    with pytest.raises(ValueError):
        t_vca.vca(np.zeros((4, 10, 2)), 2)
    with pytest.raises(ValueError):
        t_vca.vca(np.zeros((4, 10)), 5)
