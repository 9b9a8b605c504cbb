"""The port's native byte swap (``io/_native.py`` with its own
``native/qkxtm_native.cpp``), on the CPU.

``decode_be`` / ``encode_be`` equal the numpy path bit for bit at both
precisions, on sizes below and above the threaded split and on odd
sizes; the library builds into the checkout's ``build/native/`` and
never beside its source; without ``g++`` the numpy path runs, and with
``g++`` a failed build or load raises; the port's LIME reader and
writer go through it and agree with the JAX package's reader.
"""

import numpy as np
import pytest

from quda_qkxtm_multigrid_tpu.io import lime as jlime

from quda_qkxtm_multigrid_tpu_torch.io import _native, lime

SIZES = [0, 1, 7, 1001, (1 << 17) + 3]    # 1 << 16 is the thread chunk


@pytest.fixture(scope="module")
def lib():
    lib = _native.get_lib()
    assert lib is not None, "g++ is on this machine: the library must load"
    return lib


def _values(n: int) -> np.ndarray:
    rng = np.random.default_rng(n + 11)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    v[: min(n, 4)] = [0.0, -0.0, np.inf, -1e-310][: min(n, 4)]
    return v


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("precision", [64, 32])
def test_decode_equals_numpy_bit_for_bit(lib, n, precision):
    be = ">f8" if precision == 64 else ">f4"
    with np.errstate(over="ignore"):
        buf = _values(n).astype(be).tobytes()
    got = _native.decode_be(buf, precision)
    want = np.frombuffer(buf, dtype=be).astype(np.float64)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("precision", [64, 32])
def test_encode_equals_numpy_bit_for_bit(lib, n, precision):
    v = _values(n)
    with np.errstate(over="ignore"):
        want = v.astype(">f8" if precision == 64 else ">f4").tobytes()
    assert _native.encode_be(v, precision) == want


def test_library_builds_under_build_not_beside_the_source(lib):
    so = _native.library_path()
    assert so.exists() and so.parent.name == "native"
    assert so.parent.parent.name == "build"
    src_dir = _native._SRC.parent
    assert not list(src_dir.glob("*.so"))


def test_numpy_path_without_gpp(monkeypatch, tmp_path):
    """No compiler and no built library: the numpy path, same bytes."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _native.get_lib() is None
    v = _values(1001)
    assert _native.decode_be(_native.encode_be(v, 64), 64).tobytes() \
        == v.tobytes()
    assert _native.encode_be(v, 32) == v.astype(">f4").tobytes()


@pytest.mark.parametrize("precision", [64, 32])
def test_lime_round_trip_through_the_swap_matches_jax(lib, tmp_path,
                                                      precision):
    rng = np.random.default_rng(5)
    shape = (4, 4, 2, 2, 2, 3, 3)
    full = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    path = str(tmp_path / "conf.lime")
    lime.write_ildg_gauge(path, full, precision=precision)
    back = lime.read_ildg_gauge(path)
    want = jlime.read_ildg_gauge(path)
    assert back.tobytes() == np.asarray(want).tobytes()
    if precision == 64:
        assert np.array_equal(back, full)


def _fresh_loader(monkeypatch, tmp_path, src=None):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    if src is not None:
        monkeypatch.setattr(_native, "_SRC", src)


def test_failed_build_raises_with_the_compiler_messages(lib, monkeypatch,
                                                        tmp_path):
    """With g++ present a source that does not compile raises (g++'s
    messages in the error), leaves no file behind, and is tried again
    on the next call: no quiet numpy path."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void be64_to_f64( {\n")
    _fresh_loader(monkeypatch, tmp_path, bad)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="broken.cpp") as e:
            _native.get_lib()
        assert "error" in str(e.value)
    assert not list((tmp_path / "native").iterdir())


def test_library_that_does_not_load_raises(lib, monkeypatch, tmp_path):
    """A built library that the loader cannot open raises."""
    _fresh_loader(monkeypatch, tmp_path)
    so = _native.library_path()
    so.parent.mkdir(parents=True)
    so.write_bytes(b"not a shared object")
    with pytest.raises(OSError):
        _native.get_lib()


@pytest.mark.parametrize("precision", [64, 32])
def test_bench_byte_swap_record(lib, precision):
    from quda_qkxtm_multigrid_tpu_torch.benchmarks import bench_byte_swap
    rec = bench_byte_swap((4, 4, 4, 8), reps=1)
    assert rec["reals"] == 4 * 18 * 4 * 4 * 4 * 8
    for op in ("decode", "encode"):
        row = rec[f"{op}{precision}"]
        assert row["bytes"] == rec["reals"] * precision // 8
        assert row["native_s"] > 0 and row["numpy_s"] > 0
