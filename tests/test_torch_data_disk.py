"""Datasets on disk in umhs_torch against umhs_tpu on the CPU: the PNG reader
and writer against PIL, write_dataset, the dataparser (split modes,
orientation and centring, downscale folders, .ply points) and the dataset's
arrays with the vca.npy side effect."""

import json
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from umhs_tpu.data import dataparser as j_dp
from umhs_tpu.data import dataset as j_ds
from umhs_tpu.data import synthetic as j_syn
from umhs_tpu.native import parallel_load_cubes
from umhs_torch.data import dataparser as t_dp
from umhs_torch.data import dataset as t_ds
from umhs_torch.data import synthetic as t_syn
from umhs_torch.data.png import image_size, png_size, read_image, read_png, write_png

KW = dict(num_views_train=4, num_views_eval=2, image_size=12, num_bands=8, num_spheres=3)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return t_syn.write_dataset(tmp_path_factory.mktemp("scene"), t_syn.SyntheticSceneConfig(**KW))


# --------------------------------------------------------------------- PNG
def _image(mode, rng):
    h, w = 9, 13
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}.get(mode, 1)
    ramp = np.add.outer(np.arange(h), 3 * np.arange(w))[..., None] * (1 + np.arange(c))
    if mode == "I;16":
        return (ramp[..., 0] * 401 + rng.integers(0, 999, (h, w))).astype(np.uint16)
    noise = rng.integers(0, 40, (h, w, c))
    arr = ((ramp * 7 + noise) % 256).astype(np.uint8)
    return arr[..., 0] if c == 1 else arr


def _encode(arr, color, depth, filt):
    """A PNG whose every row uses filter `filt` (a test-side encoder)."""
    h, w = arr.shape[:2]
    raw = arr.astype(">u2").tobytes() if depth == 16 else arr.tobytes()
    stride = len(raw) // h
    bpp = max(1, stride // w)
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int64)
    out = []
    for y in range(h):
        cur, up = rows[y], rows[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if filt == 0:
            pred = np.zeros(stride, np.int64)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = up
        elif filt == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


MODES = {"L": (0, 8), "LA": (4, 8), "RGB": (2, 8), "RGBA": (6, 8), "I;16": (0, 16)}


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_matches_pil(tmp_path, mode):
    """PIL-written files (its own filter choice), then each of the five row
    filters on every row, read back as np.asarray(Image.open(...)) gives."""
    rng = np.random.default_rng(len(mode))
    arr = _image(mode, rng)
    path = tmp_path / "pil.png"
    Image.fromarray(arr).save(path)  # uint16 (H, W) saves as 16-bit gray
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.shape == want.shape and got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(got, want)
    assert png_size(path) == (arr.shape[1], arr.shape[0])
    color, depth = MODES[mode]
    for filt in range(5):
        path = tmp_path / f"f{filt}.png"
        path.write_bytes(_encode(arr, color, depth, filt))
        np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)), err_msg=filt)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pil_reads_the_written_png(tmp_path, mode):
    arr = _image(mode, np.random.default_rng(3))
    write_png(tmp_path / "x.png", arr)
    img = Image.open(tmp_path / "x.png")
    assert img.mode == mode
    np.testing.assert_array_equal(np.asarray(img), arr)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), arr)


def _encode_any(samples, color, depth, interlace=0, plte=None, trns=None):
    """A PNG of samples (h, w, c) at any colour type, bit depth and
    interlace, each row's filter its row index mod 5 (a test-side encoder)."""
    h, w, c = samples.shape
    bits = c * depth
    bpp = max(1, bits // 8)

    def rows_of(sub):
        sh, sw = sub.shape[:2]
        if depth == 16:
            raw = sub.astype(">u2").reshape(sh, -1).view(np.uint8)
        elif depth < 8:
            per = 8 // depth
            flat = sub.reshape(sh, -1).astype(np.uint8)
            flat = np.concatenate([flat, np.zeros((sh, (-flat.shape[1]) % per), np.uint8)], 1)
            shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
            raw = (flat.reshape(sh, -1, per) << shifts).sum(-1).astype(np.uint8)
        else:
            raw = sub.reshape(sh, -1).astype(np.uint8)
        out = []
        for y in range(sh):
            cur = raw[y].astype(np.int64)
            up = raw[y - 1].astype(np.int64) if y else np.zeros_like(cur)
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
            filt = y % 5
            pred = [np.zeros_like(cur), left, up, (left + up) // 2, None][filt]
            if filt == 4:
                pe = left + up - ul
                pa, pb, pc = abs(pe - left), abs(pe - up), abs(pe - ul)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            out.append(bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        return b"".join(out)

    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    data = b"".join(rows_of(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                    if samples[y0::dy, x0::dx].size)

    def chunk(kind, body):
        crc = struct.pack(">I", zlib.crc32(kind + body))
        return struct.pack(">I", len(body)) + kind + body + crc

    extra = (chunk(b"PLTE", plte) if plte is not None else b"") + (
        chunk(b"tRNS", trns) if trns is not None else b"")
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


# name -> (colour type, bit depth, channels, interlace, palette entries, tRNS)
FORMATS = {
    "gray1": (0, 1, 1, 0, 0, False), "gray2": (0, 2, 1, 0, 0, False),
    "gray4": (0, 4, 1, 0, 0, False),
    **{f"pal{d}{'_trns' if t else ''}": (3, d, 1, 0, min(1 << d, 200), t)
       for d in (1, 2, 4, 8) for t in (False, True)},
    "rgb16": (2, 16, 3, 0, 0, False), "rgba16": (6, 16, 4, 0, 0, False),
    "gray_alpha16": (4, 16, 2, 0, 0, False),
    "adam7_rgb": (2, 8, 3, 1, 0, False), "adam7_gray16": (0, 16, 1, 1, 0, False),
    "adam7_pal4": (3, 4, 1, 1, 16, False), "adam7_gray1": (0, 1, 1, 1, 0, False),
}


@pytest.mark.parametrize("name", list(FORMATS))
def test_png_formats_read_as_pil_reads_them(tmp_path, name):
    """Every other colour type, bit depth and interlace: read_png,
    read_image and the size functions against np.asarray(Image.open(p))
    and .size, on odd sizes (sub-byte rows end in padding bits; some Adam7
    passes are empty or one pixel wide)."""
    color, depth, c, interlace, entries, trns = FORMATS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    for h, w in ((11, 13), (1, 3), (7, 1)):
        top = entries if color == 3 else (1 << depth)
        samples = rng.integers(0, top, (h, w, c))
        plte = rng.integers(0, 256, 3 * entries).astype(np.uint8).tobytes() if entries else None
        alpha = rng.integers(0, 256, entries).astype(np.uint8).tobytes() if trns else None
        path = tmp_path / f"{name}_{h}x{w}.png"
        path.write_bytes(_encode_any(samples, color, depth, interlace, plte, alpha))
        with Image.open(path) as img:
            want, size = np.asarray(img), img.size
        for got in (read_png(path), read_image(path)):
            assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want)
        assert png_size(path) == image_size(path) == size == (w, h)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_read_as_pil_reads_it(tmp_path, mode):
    """A JPEG reads through Pillow (the same decoder as the JAX package's
    bits); its size comes from the SOF marker without it."""
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (9, 14, 3) if mode == "RGB" else (9, 14)).astype(np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(arr).save(path, quality=90)
    with Image.open(path) as img:
        want, size = np.asarray(img), img.size
    got = read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(path) == size == (14, 9)


def test_png_rejects_other_formats(tmp_path):
    """Bytes that are not an image, and arrays write_png does not write."""
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(tmp_path / "n.png")
    with pytest.raises(ValueError):
        png_size(tmp_path / "n.png")
    bad = _encode_any(np.zeros((2, 2, 3), np.int64), 2, 8)
    (tmp_path / "b.png").write_bytes(bad[:24] + bytes([4]) + bad[25:])  # RGB at 4 bits
    with pytest.raises(ValueError, match="not a valid PNG"):
        read_png(tmp_path / "b.png")
    for arr in (np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4), np.uint16)):
        with pytest.raises(ValueError):
            write_png(tmp_path / "x.png", arr)


# ------------------------------------------------------------ write_dataset
def test_write_dataset_matches_jax(tmp_path, scene_dir):
    jroot = j_syn.write_dataset(tmp_path / "j", j_syn.SyntheticSceneConfig(**KW))
    jmeta = json.loads((jroot / "transforms.json").read_text())
    tmeta = json.loads((scene_dir / "transforms.json").read_text())
    assert tmeta == jmeta
    for frame in jmeta["frames"]:
        np.testing.assert_array_equal(np.load(scene_dir / frame["hyperspectral_file_path"]),
                                      np.load(jroot / frame["hyperspectral_file_path"]))
        np.testing.assert_array_equal(np.asarray(Image.open(scene_dir / frame["file_path"])),
                                      np.asarray(Image.open(jroot / frame["file_path"])))


# -------------------------------------------------------------- dataparser
def _cameras_match(t, j):
    np.testing.assert_allclose(t.camera_to_worlds, j.camera_to_worlds, rtol=0, atol=1e-6)
    for k in ("fx", "fy", "cx", "cy", "width", "height", "distortion_params"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    assert t.camera_type == j.camera_type


def _parse_both(cfg_kw, split):
    jo = j_dp.UMHSDataParser(j_dp.DataParserConfig(**cfg_kw)).parse(split)
    to = t_dp.UMHSDataParser(t_dp.DataParserConfig(**cfg_kw)).parse(split)
    assert [str(p) for p in to.image_filenames] == [str(p) for p in jo.image_filenames]
    _cameras_match(to.cameras, jo.cameras)
    assert to.dataparser_scale == pytest.approx(jo.dataparser_scale, rel=1e-6)
    np.testing.assert_allclose(to.dataparser_transform, jo.dataparser_transform, rtol=0, atol=1e-6)
    assert to.scene_scale == jo.scene_scale
    for k, v in jo.metadata.items():
        tv = to.metadata[k]
        if isinstance(v, list):
            assert [str(x) for x in tv] == [str(x) for x in v], k
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tv, v, err_msg=k)
        else:
            assert tv == v, k
    return to, jo


@pytest.mark.parametrize("eval_mode", ["filename", "fraction", "interval", "all"])
@pytest.mark.parametrize("orient,center", [("up", "poses"), ("pca", "focus"), ("vertical", "none"),
                                           ("none", "poses")])
def test_dataparser_matches_jax(scene_dir, tmp_path, monkeypatch, eval_mode, orient, center):
    monkeypatch.chdir(tmp_path)
    kw = dict(data=scene_dir, eval_mode=eval_mode, orientation_method=orient,
              center_method=center, eval_interval=3, train_split_fraction=0.7, num_classes=3)
    for split in ("train", "val"):
        _parse_both(kw, split)


def test_dataparser_sidecars_downscale_and_points(scene_dir, tmp_path, monkeypatch):
    """Per-frame intrinsics and distortion, mask/seg/depth/dino paths, an
    images_2/ folder through downscale_factor=2, and a .ply point cloud."""
    monkeypatch.chdir(tmp_path)
    root = tmp_path / "scene"
    shutil.copytree(scene_dir, root)
    meta = json.loads((root / "transforms.json").read_text())
    (root / "images_2").mkdir()
    for i, fr in enumerate(meta["frames"]):
        for key in ("mask_path", "seg_file_path", "depth_file_path", "dino_file_path"):
            fr[key] = f"side/{i}_{key}.png"
        fr.update({"fl_x": 14.0 + i, "fl_y": 14.5, "cx": 6.0, "cy": 6.0, "w": 12, "h": 12,
                   "k1": 0.01 * i, "p2": -0.001})
        shutil.copy(root / fr["file_path"], root / "images_2" / f"{i}.png")
        fr["file_path"] = f"{fr['file_path'].split('/')[0]}/{i}.png"
    for k in ("fl_x", "fl_y", "cx", "cy", "w", "h"):
        meta.pop(k)
    pts = np.random.default_rng(0).normal(size=(7, 3))
    ply = ["ply", "format ascii 1.0", "element vertex 7", "property float x", "property float y",
           "property float z", "property uchar red", "property uchar green",
           "property uchar blue", "end_header"]
    ply += [" ".join(f"{v:.6f}" for v in p) + " 10 20 30" for p in pts]
    (root / "points.ply").write_text("\n".join(ply) + "\n")
    meta["ply_file_path"] = "points.ply"
    meta["applied_scale"] = 0.5
    (root / "transforms.json").write_text(json.dumps(meta))
    kw = dict(data=root, downscale_factor=2, eval_mode="fraction", load_3D_points=True)
    to, jo = _parse_both(kw, "train")
    assert to.image_filenames[0].parent.name == "images_2"
    assert len(to.mask_filenames) == len(to.image_filenames)
    np.testing.assert_allclose(to.metadata["points3D_xyz"], jo.metadata["points3D_xyz"], atol=1e-6)
    assert to.metadata["points3D_rgb"].tolist() == [[10, 20, 30]] * 7


def test_load_ply_binary_matches_jax(tmp_path):
    pts = np.random.default_rng(1).normal(size=(5, 3)).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\nproperty float x\n"
              "property float y\nproperty float z\nend_header\n").encode()
    (tmp_path / "p.ply").write_bytes(header + pts.tobytes())
    tf = np.concatenate([np.eye(3), np.ones((3, 1))], axis=1)
    t = t_dp.load_ply_points(tmp_path / "p.ply", tf, 0.5)
    j = j_dp.load_ply_points(tmp_path / "p.ply", tf, 0.5)
    np.testing.assert_array_equal(t["points3D_xyz"], j["points3D_xyz"])
    assert "points3D_rgb" not in t


# ----------------------------------------------------------------- dataset
def test_dataset_arrays_and_vca_match_jax(scene_dir, tmp_path, monkeypatch):
    """Images, cubes, masks and valid_indices, segmentation and DINO
    features, and the vca.npy each package writes (a stale one is deleted
    by the dataparser first)."""
    root = tmp_path / "scene"
    shutil.copytree(scene_dir, root)
    meta = json.loads((root / "transforms.json").read_text())
    rng = np.random.default_rng(4)
    for i, fr in enumerate(meta["frames"]):
        mask = (rng.uniform(size=(12, 12)) > 0.3).astype(np.uint8) * 255
        Image.fromarray(mask).save(root / f"m{i}.png")
        Image.fromarray(rng.integers(0, 3, (12, 12)).astype(np.uint8)).save(root / f"s{i}.png")
        torch.save(torch.from_numpy(rng.normal(size=(5, 12, 12)).astype(np.float32)),
                   root / f"d{i}.pt")
        fr.update({"mask_path": f"m{i}.png", "seg_file_path": f"s{i}.png",
                   "dino_file_path": f"d{i}.pt"})
    (root / "transforms.json").write_text(json.dumps(meta))
    out = {}
    for name, dp, ds in (("jax", j_dp, j_ds), ("torch", t_dp, t_ds)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        np.save("vca.npy", np.zeros((3, 8)))  # stale
        parsed = dp.UMHSDataParser(dp.DataParserConfig(data=root, num_classes=3)).parse("train")
        assert not (work / "vca.npy").exists()
        out[name] = ds.HyperspectralDataset(parsed)
        out[name + "_vca"] = np.load(work / "vca.npy")
    t, j = out["torch"], out["jax"]
    assert sorted(t.arrays()) == sorted(j.arrays()) == ["dino_feat", "hs_image", "image",
                                                       "seg_image"]
    for k, v in j.arrays().items():
        assert t.arrays()[k].dtype == v.dtype, k
        np.testing.assert_array_equal(t.arrays()[k], v, err_msg=k)
    np.testing.assert_array_equal(t.valid_indices(), j.valid_indices())
    assert len(t) == len(j) == 4
    np.testing.assert_array_equal(out["torch_vca"], out["jax_vca"])


def test_dataset_reads_jpeg_frames_bit_masks_and_palette_segs_as_jax(scene_dir, tmp_path,
                                                                       monkeypatch):
    """A scene whose frames are JPEGs past the auto-downscale resolution
    (with an images_2/ folder of smaller JPEGs), whose masks are 1-bit PNGs
    and whose segmentation maps are palette PNGs: the dataparser's
    downscale choice and the dataset's images, masks and seg_images equal
    the JAX package's on the same files."""
    root = tmp_path / "scene"
    shutil.copytree(scene_dir, root)
    meta = json.loads((root / "transforms.json").read_text())
    rng = np.random.default_rng(8)
    (root / "jpg").mkdir()
    (root / "images_2").mkdir()
    wide = t_dp.MAX_AUTO_RESOLUTION + 100
    for i, fr in enumerate(meta["frames"]):
        Image.fromarray(rng.integers(0, 256, (6, wide, 3)).astype(np.uint8)).save(
            root / "jpg" / f"{i}.jpg", quality=85)
        Image.fromarray(rng.integers(0, 256, (3, wide // 2)).astype(np.uint8)).save(
            root / "images_2" / f"{i}.jpg", quality=85)  # gray, read as (H, W) then RGB
        fr["file_path"] = f"jpg/{i}.jpg"
        Image.fromarray(rng.uniform(size=(12, 12)) > 0.4).save(root / f"m{i}.png")  # mode "1"
        seg = Image.new("P", (12, 12))
        seg.putdata(rng.integers(0, 3, 144).tolist())
        seg.putpalette([0, 0, 0, 200, 10, 10, 10, 200, 10])
        seg.save(root / f"s{i}.png")  # 3 colours: a 2-bit palette PNG
        fr.update({"mask_path": f"m{i}.png", "seg_file_path": f"s{i}.png"})
        # the sidecars of the downscaled frames (the dataparser's prefixes)
        for key, prefix in (("mask_path", "masks_2"), ("seg_file_path", "segs_2"),
                            ("hyperspectral_file_path", "hs_2")):
            (root / prefix).mkdir(exist_ok=True)
            shutil.copy(root / fr[key], root / prefix / Path(fr[key]).name)
    (root / "transforms.json").write_text(json.dumps(meta))
    with Image.open(root / "m0.png") as m, Image.open(root / "s0.png") as sg:
        assert (m.mode, sg.mode) == ("1", "P")
    out = {}
    for name, dp, ds in (("jax", j_dp, j_ds), ("torch", t_dp, t_ds)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        parser = dp.UMHSDataParser(dp.DataParserConfig(data=root, num_classes=3,
                                                         eval_mode="fraction"))
        parsed = parser.parse("train")
        out[name] = (parser.downscale_factor, ds.HyperspectralDataset(parsed, compute_vca=False))
    (t_df, t), (j_df, j) = out["torch"], out["jax"]
    assert t_df == j_df == 2
    assert t.images.shape == j.images.shape == (len(t), 3, wide // 2, 3)
    for k in ("images", "masks", "seg_images"):
        assert getattr(t, k).dtype == getattr(j, k).dtype, k
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    np.testing.assert_array_equal(t.valid_indices(), j.valid_indices())


def test_integer_cubes_are_scaled_and_clamped(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i, dt in enumerate((np.uint16, np.uint8, np.float32)):
        cube = (rng.uniform(-0.2, 1.2, (4, 5, 3)) if dt == np.float32
                else rng.integers(0, np.iinfo(dt).max, (4, 5, 3))).astype(dt)
        paths.append(tmp_path / f"{i}.npy")
        np.save(paths[-1], cube)
    got = t_ds.load_cubes(paths, (4, 5, 3))
    for g, p in zip(got, paths):  # loader.cpp's scaling: p[i] * (1.0f / max), in float32
        raw = np.load(p)
        want = raw.astype(np.float32)
        if np.issubdtype(raw.dtype, np.integer):
            want = want * (np.float32(1.0) / np.float32(np.iinfo(raw.dtype).max))
        np.testing.assert_array_equal(g, np.clip(want, 0.0, 1.0))
    # umhs_tpu's loader (native where g++ builds it) gives the same bits, and
    # so does the port's plain loop
    np.testing.assert_array_equal(got, parallel_load_cubes(paths, (4, 5, 3)))
    np.testing.assert_array_equal(got, t_ds.load_cubes(paths, (4, 5, 3), impl="plain"))
    assert got.min() >= 0.0 and got.max() <= 1.0
    with pytest.raises(ValueError):
        t_ds.load_cubes(paths, (4, 5, 2))
