"""umhs_torch.native, the port's copy of umhs_tpu's native cube loader, on
the CPU (it is host code: g++ builds it here as on the card's machine):
bit for bit against data/dataset.py's plain loop and umhs_tpu's
parallel_load_cubes, the stated routing rule, and no quiet fallback."""

from pathlib import Path

import numpy as np
import pytest

from umhs_tpu.native import parallel_load_cubes as jax_load
from umhs_torch import native
from umhs_torch.data import dataset as t_ds

SHAPE = (6, 5, 4)


def _cubes(tmp_path, dtype, n=3, seed=0, order="C"):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        dt = np.dtype(dtype)
        if dt.kind == "u":
            raw = rng.integers(0, np.iinfo(dt).max, SHAPE, endpoint=True).astype(dt)
        else:
            raw = rng.uniform(-0.3, 1.3, SHAPE).astype(dt)
        p = tmp_path / f"{dt.str.replace('<', 'le').replace('>', 'be').replace('|', '')}_{i}.npy"
        np.save(p, np.asfortranarray(raw) if order == "F" else raw)
        paths.append(p)
    return paths


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "|u1", "<u2"])
def test_native_equals_the_plain_loop_and_jax(tmp_path, dtype, monkeypatch):
    paths = _cubes(tmp_path, dtype)
    assert all(native.takes(native.read_npy_header(p)) for p in paths)
    calls = []
    real = native.parallel_load_cubes
    monkeypatch.setattr(native, "parallel_load_cubes",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    got = t_ds.load_cubes(paths, SHAPE)
    assert len(calls) == 1  # the native route
    plain = t_ds.load_cubes(paths, SHAPE, impl="plain")
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(jax_load(paths, SHAPE)))
    assert got.dtype == np.float32 and got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("case", ["<f2", ">f4", "fortran", "mixed"])
def test_other_files_take_the_plain_route(tmp_path, case, monkeypatch):
    """The rule: a call goes to the native loader only when every file is a
    v1/v2 .npy in C order with a <f4, <f8, |u1 or <u2 payload."""
    if case == "fortran":
        paths = _cubes(tmp_path, "<f4", order="F")
    elif case == "mixed":
        paths = _cubes(tmp_path, "<f4") + _cubes(tmp_path, "<f2", n=1, seed=1)
    else:
        paths = _cubes(tmp_path, case)
    assert not all(native.takes(native.read_npy_header(p)) for p in paths)
    monkeypatch.setattr(native, "parallel_load_cubes",
                        lambda *a, **k: pytest.fail("routed to the native loader"))
    got = t_ds.load_cubes(paths, SHAPE)
    want = np.stack([np.clip(np.load(p).astype(np.float32), 0.0, 1.0) for p in paths])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jax_load(paths, SHAPE)))


def test_the_loader_refuses_files_it_does_not_take(tmp_path):
    paths = _cubes(tmp_path, "<f2")
    with pytest.raises(ValueError, match="does not take"):
        native.parallel_load_cubes(paths, SHAPE)


def test_many_files_on_many_threads(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(32):
        paths.append(tmp_path / f"f{i}.npy")
        np.save(paths[-1], rng.random((8, 8, 3)).astype(np.float32))
    got = native.parallel_load_cubes(paths, (8, 8, 3), n_threads=8)
    np.testing.assert_array_equal(got, np.stack([np.load(p) for p in paths]))
    np.testing.assert_array_equal(got, jax_load(paths, (8, 8, 3), n_threads=8))


def test_no_clamp(tmp_path):
    p = tmp_path / "x.npy"
    np.save(p, np.array([[-1.0, 2.0, 0.5]], np.float32))
    np.testing.assert_array_equal(native.parallel_load_cubes([p], (1, 3), clamp01=False)[0],
                                  [[-1.0, 2.0, 0.5]])
    np.testing.assert_array_equal(native.parallel_load_cubes([p], (1, 3))[0], [[0.0, 1.0, 0.5]])
    np.testing.assert_array_equal(native.parallel_load_cubes([p], (1, 3), clamp01=False),
                                  jax_load([p], (1, 3), clamp01=False))


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_a_shape_mismatch_raises(tmp_path, impl):
    paths = _cubes(tmp_path, "<f4")
    with pytest.raises(ValueError, match="shape"):
        t_ds.load_cubes(paths, (6, 5, 3), impl=impl)
    with pytest.raises(ValueError, match="shape"):
        native.parallel_load_cubes(paths, (4, 5, 6))


def test_an_empty_call_gives_an_empty_stack():
    assert t_ds.load_cubes([], SHAPE).shape == (0, *SHAPE)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    broken = tmp_path / "loader.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis does not compile;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths = _cubes(tmp_path, "<f4")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_ds.load_cubes(paths, SHAPE)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not native.library_path().exists()


def test_a_failing_file_raises(tmp_path):
    """A header the loader takes over a payload cut short: its non-zero
    return raises, naming the file."""
    paths = _cubes(tmp_path, "<f4")
    data = paths[1].read_bytes()
    paths[1].write_bytes(data[:-8])
    with pytest.raises(RuntimeError, match=paths[1].name):
        t_ds.load_cubes(paths, SHAPE)


def test_the_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.suffix == ".so"
    native.build()  # idempotent once built
    assert native.build() is False and path.exists()
    other = tmp_path / "loader.cpp"
    other.write_text(native.SOURCE.read_text() + "\n// another build\n")
    monkeypatch.setattr(native, "SOURCE", other)
    assert native.library_path() != path and native.library_path().parent == native.BUILD_DIR


def test_the_source_is_umhs_tpu_s_loader():
    """Only the comment at the top differs (it names no paths)."""
    def body(path):
        lines = Path(path).read_text().splitlines()
        return lines[next(i for i, ln in enumerate(lines) if not ln.startswith("//")):]

    jax_src = Path(__file__).resolve().parents[1] / "umhs_tpu" / "native" / "loader.cpp"
    assert body(native.SOURCE) == body(jax_src)
