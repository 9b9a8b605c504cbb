"""Guards on the port's package: it imports neither JAX nor the JAX
package, importing it compiles nothing and imports no ``triton``, and
its CUDA build is configured for Hopper and fails loudly without
``nvcc``.
"""

import ast
import ctypes
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from quda_qkxtm_multigrid_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "quda_qkxtm_multigrid_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "time_kernels.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "quda_qkxtm_multigrid_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_jax_check_covers_the_sharded_path():
    """``parallel/`` (the ring, the halo exchange, the slab operator) and
    the ring tests' worker process are scanned like the rest of the
    port."""
    scanned = {p.relative_to(PKG).as_posix() for p in PORT_FILES
               if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/halo.py",
            "parallel/sharded.py"} <= scanned
    worker = ROOT / "tests" / "_torch_mesh_worker.py"
    assert not [m for m in _imported_modules(worker) if _forbidden(m)]


def test_import_compiles_nothing(tmp_path):
    """Import every module of the port with a fake ``nvcc`` first on the
    PATH: it must not run, no ``triton`` may be imported and no library
    may be loaded."""
    marker = tmp_path / "nvcc_was_called"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    fake.chmod(0o755)
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import quda_qkxtm_multigrid_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from quda_qkxtm_multigrid_tpu_torch import _build
        assert _build.load_library.cache_info().currsize == 0
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("triton", "jax", "quda_qkxtm_multigrid_tpu")]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PATH=f"{fake.parent}{os.pathsep}"
               f"{os.environ.get('PATH', '')}", CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15
    assert not marker.exists()


def test_build_targets_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for f in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert f in flags
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    assert {p.name for p in _build._sources()} >= {
        "dslash_ch.cu", "dslash_ch.cuh", "dslash_ch_msrc.cu",
        "dslash_ch_bf16.cu", "dslash_ch_local.cu"}


@pytest.mark.parametrize("name,n_args,n_ptrs", [
    ("qkx_dslash_ch_f32", 23, 6), ("qkx_dslash_ch_f64", 23, 6),
    ("qkx_dslash_ch_msrc_f32", 24, 6), ("qkx_dslash_ch_f32_g16", 23, 6),
    ("qkx_dslash_ch_f32_g16s16", 23, 6),
    ("qkx_dslash_ch_msrc_f32_g16", 24, 6),
    ("qkx_dslash_ch_local_f32", 25, 7), ("qkx_dslash_ch_local_f64", 25, 7),
    ("qkx_dslash_ch_local_f32_g16", 25, 7)])
def test_entry_points_pass_pointers_as_void_p(name, n_args, n_ptrs):
    argtypes = _build.ENTRY_POINTS[name]
    assert len(argtypes) == n_args
    assert argtypes[:n_ptrs] == [ctypes.c_void_p] * n_ptrs
    assert ctypes.c_void_p not in argtypes[n_ptrs:-1]
    assert argtypes[-1] is ctypes.c_void_p          # the stream


def test_source_hash_follows_sources(tmp_path, monkeypatch):
    for p in _build._sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h0 = _build.source_hash()
    with open(tmp_path / "dslash_ch.cuh", "a") as f:
        f.write("// edit\n")
    assert _build.source_hash() != h0
    assert _build.library_dir().name == f"qkx_kernels-{_build.source_hash()}"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: a missing compiler is an error, not a CPU path."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_msrc_kernel_refuses_other_devices():
    """No fallback: the multi-source wrapper runs its plain version only
    on the CPU and launches the kernel only on CUDA; any other device
    raises."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_msrc)
    geom = Geometry(4, 4, 4, 4)
    g = torch.empty((4, 96, 4, 8), device="meta")
    psi = torch.empty((2, 4, 24, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no dslash_ch_msrc for device"):
        dslash_ch_msrc(g, psi, 0, geom, recon12=True)


def test_local_kernels_refuse_other_devices():
    """The t-local hop's wrappers (K4, K5) likewise: plain version on
    the CPU, kernel on CUDA, anything else raises."""
    import torch
    from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
    from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
        dslash_ch_local, dslash_ch_overlap)
    geom = Geometry(4, 4, 4, 4)
    g = torch.empty((4, 96, 4, 8), device="meta")
    psi = torch.empty((4, 24, 4, 8), device="meta")
    face = torch.empty((1, 24, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no dslash_ch_local for device"):
        dslash_ch_local(g, psi, face, face, 0, geom, recon12=True)
    with pytest.raises(ValueError, match="no dslash_ch_overlap for device"):
        dslash_ch_overlap(g, psi, face, face, 0, geom, recon12=True)
