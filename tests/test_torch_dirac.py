"""The port's ``Dirac`` against the JAX package's ``Dirac`` (plain XLA
path, ``use_pallas=False``) on the same complex128 gauge field, for
twisted-clover, twisted-mass, clover and Wilson, with the port's hops
plain (``use_kernels=False``) and through the kernel wrapper
(``use_kernels=True``; on the CPU that runs the channel chain on
``dslash_ch_reference`` in float64).  Tolerance 1e-12 normwise relative.
"""

import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

from quda_qkxtm_multigrid_tpu import dirac as jd
from quda_qkxtm_multigrid_tpu import lattice as jlat
from quda_qkxtm_multigrid_tpu.utils import rng as jrng

from quda_qkxtm_multigrid_tpu_torch import dirac as td
from quda_qkxtm_multigrid_tpu_torch import lattice as tlat
from quda_qkxtm_multigrid_tpu_torch import convert
from quda_qkxtm_multigrid_tpu_torch.convert import spinor_to_numpy as N
from quda_qkxtm_multigrid_tpu_torch.ops import dslash_kernel as dk
from quda_qkxtm_multigrid_tpu_torch.ops.gamma import apply_gamma5

# the tests run on the CPU; the converters default to the card
dirac_from_numpy = functools.partial(convert.dirac_from_numpy, device="cpu")
T = functools.partial(convert.spinor_from_numpy, device="cpu")

torch.set_num_threads(1)

GJ = jlat.Geometry(4, 4, 4, 8)
GT = tlat.Geometry(4, 4, 4, 8)
RTOL = 1e-12

KINDS = {
    "twisted-clover": dict(kind="twisted-clover", kappa=0.115, mu=0.05,
                           csw=1.0),
    "twisted-mass": dict(kind="twisted-mass", kappa=0.12, mu=0.07,
                         flavor=-1),
    "clover": dict(kind="clover", kappa=0.12, csw=1.2, matpc_parity=1),
    "wilson": dict(kind="wilson", kappa=0.13),
    "twisted-clover-asym": dict(kind="twisted-clover", kappa=0.115,
                                mu=0.05, csw=1.0, asymmetric=True),
}


def rel(got, ref) -> float:
    got = N(got) if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.fixture(scope="module")
def flds():
    k1, k2 = jax.random.split(jax.random.PRNGKey(41))
    return (np.asarray(jrng.random_gauge(k1, GJ)),
            np.asarray(jrng.random_spinor(k2, GJ)))


_JAX_CACHE = {}


def _jax_results(flds, kind):
    """Every operator output of the JAX Dirac, computed once per kind."""
    if kind not in _JAX_CACHE:
        u, psi = flds
        d = jd.make_dirac(u, jd.DiracParams(**KINDS[kind]), GJ)
        pr = d.params.matpc_parity
        b = d.m(psi)
        _JAX_CACHE[kind] = {
            "m": d.m(psi), "mdag": d.m(psi, dagger=True),
            "matpc": d.matpc(psi[pr]),
            "matpc_dag": d.matpc(psi[pr], dagger=True),
            "matpc_dagm": d.matpc_dagm(psi[pr]),
            "prepare": d.prepare(b), "reconstruct": d.reconstruct(psi[pr], b),
            "dslash": d.dslash(psi[1], 0, dagger=True),
            "clover": None if d.clover is None else np.asarray(d.clover),
        }
    return _JAX_CACHE[kind]


PORT_OPS = {
    "m": lambda d, psi, b, pr: d.m(psi),
    "mdag": lambda d, psi, b, pr: d.mdag(psi),
    "matpc": lambda d, psi, b, pr: d.matpc(psi[pr]),
    "matpc_dag": lambda d, psi, b, pr: d.matpc(psi[pr], dagger=True),
    "matpc_dagm": lambda d, psi, b, pr: d.matpc_dagm(psi[pr]),
    "prepare": lambda d, psi, b, pr: d.prepare(b),
    "reconstruct": lambda d, psi, b, pr: d.reconstruct(psi[pr], b),
    "dslash": lambda d, psi, b, pr: d.dslash(psi[1], 0, dagger=True),
}


@pytest.mark.parametrize("op", list(PORT_OPS))
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_operator_matches_jax(flds, kind, use_kernels, op):
    ref = _jax_results(flds, kind)
    u, psi = flds
    params = td.DiracParams(**KINDS[kind], use_kernels=use_kernels)
    d = dirac_from_numpy(u, params, GT)
    pr = params.matpc_parity
    psi_t = T(psi)
    b = T(np.asarray(ref["m"]))
    got = PORT_OPS[op](d, psi_t, b, pr)
    assert got.dtype == torch.complex128
    assert rel(got, ref[op]) <= RTOL


def test_fused_chain_is_taken(flds):
    """With use_kernels the symmetric twisted/clover matpc runs the
    channel chain (and counts no launch on the CPU); the asymmetric
    form and Wilson do not have one."""
    u, _ = flds
    for kind, fused in (("twisted-clover", True), ("twisted-mass", True),
                        ("clover", True), ("wilson", False),
                        ("twisted-clover-asym", False)):
        d = dirac_from_numpy(u, td.DiracParams(**KINDS[kind],
                                               use_kernels=True), GT)
        assert d._has_fused_matpc is fused, kind
        plain = dirac_from_numpy(u, td.DiracParams(**KINDS[kind]), GT)
        assert not plain._has_fused_matpc and plain.u_doubled is None


@pytest.mark.parametrize("kind", ["twisted-clover", "twisted-mass"])
def test_fused_chain_float32(flds, kind):
    """The float32 channel chain (the CG's matvec) against JAX in c128."""
    u, psi = flds
    ref = _jax_results(flds, kind)["matpc_dagm"]
    d = dirac_from_numpy(u, td.DiracParams(**KINDS[kind], use_kernels=True),
                         GT)
    v = dk.to_channels(T(psi[0])).to(torch.float32)
    out = d._fused_matpc_dagm_ch(v)
    assert out.dtype == torch.float32
    assert rel(dk.from_channels(out, (4, 3)), ref) <= 1e-5


def test_clover_fields_match(flds):
    u, _ = flds
    ref = _jax_results(flds, "twisted-clover")["clover"]
    d = dirac_from_numpy(u, td.DiracParams(**KINDS["twisted-clover"]), GT)
    assert rel(d.clover, ref) <= RTOL


@pytest.mark.parametrize("dag", [False, True])
def test_ch_clover_apply_matches_jax(flds, dag):
    u, psi = flds
    d = jd.make_dirac(u, jd.DiracParams(**KINDS["clover"]), GJ)
    from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import _to_channels
    from quda_qkxtm_multigrid_tpu.ops.dslash_pallas5 import clover_channels
    v = np.asarray(_to_channels(psi[0]))
    ci = np.asarray(clover_channels(d.clover_inv, 0, False))
    ref = jd._ch_clover_apply(v, ci, dag=dag)
    assert rel(td._ch_clover_apply(T(v), T(ci), dag=dag), ref) <= 1e-6


def test_ch_twist_matches_jax(flds):
    psi = flds[1]
    from quda_qkxtm_multigrid_tpu.ops.dslash_pallas import _to_channels
    v = np.asarray(_to_channels(psi[0]))
    ref = jd._ch_twist(v, -0.3, 0.8)
    assert rel(td._ch_twist(T(v), -0.3, 0.8), ref) <= 1e-12


@pytest.mark.parametrize("kind", list(KINDS))
def test_flops_per_mat(flds, kind):
    u, _ = flds
    ref = jd.make_dirac(u, jd.DiracParams(**KINDS[kind]), GJ).flops_per_mat()
    got = dirac_from_numpy(u, td.DiracParams(**KINDS[kind]),
                           GT).flops_per_mat()
    assert got == ref


@pytest.mark.parametrize("bad", [
    dict(kind="staggered"), dict(kappa=0.0), dict(kappa=1.5),
    dict(kind="clover"), dict(kind="twisted-mass"), dict(flavor=0),
    dict(matpc_parity=2),
])
def test_params_validation(bad):
    with pytest.raises(ValueError):
        td.DiracParams(**bad)


def test_dirac_is_a_module_of_buffers(flds):
    u, psi = flds
    d = dirac_from_numpy(u, td.DiracParams(**KINDS["twisted-clover"],
                                           use_kernels=True), GT)
    names = {n for n, _ in d.named_buffers()}
    assert names == {"u", "clover", "clover_inv", "u_doubled"}
    assert isinstance(d, torch.nn.Module)
    psi_t = T(psi)
    assert torch.equal(d(psi_t), d.m(psi_t))
    d._operands(torch.float32)
    assert d._ch_cache
    d.to("cpu")             # .to() drops the channel operands it cached
    assert not d._ch_cache


def test_gamma5_hermiticity_and_schur(flds):
    """Port-only identities, as tests/test_clover.py checks them on the
    JAX side: γ5 M(μ) γ5 = M(−μ)† and the Schur prepare/reconstruct."""
    u, psi = flds
    params = td.DiracParams(**KINDS["twisted-clover"], use_kernels=True)
    d = dirac_from_numpy(u, params, GT)
    flip = dirac_from_numpy(u, dataclasses.replace(params, flavor=-1), GT)
    psi_t = T(psi)
    lhs = apply_gamma5(d.m(apply_gamma5(psi_t)))
    assert rel(lhs, N(flip.m(psi_t, dagger=True))) <= RTOL
    b = d.m(psi_t)
    assert rel(d.matpc(psi_t[0]), N(d.prepare(b))) <= RTOL
    assert rel(d.reconstruct(psi_t[0], b), psi) <= RTOL
