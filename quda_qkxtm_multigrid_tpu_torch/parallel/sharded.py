"""The rank's box of a Dirac operator: the counterpart of the JAX
package's ``parallel.mesh.shard_dirac`` and ``Dirac._fused_matpc_ch_shmap``
(``dirac.py:311-437``), on a t-ring or a (Gt, Gz, Gw) grid
(``parallel.mesh.LatticeMesh``).

``make_sharded_dirac`` builds the rank's box of the operator from the
rank's box of the gauge alone, exchanging one plane with each neighbour
wherever the build reads across a box face: the backward links of the
first t, z and y rows (the doubled gauge) and the neighbours of the
clover leaves (the field strength, the clover term and its inverse; a
leaf reaches one plane along each of two axes, its corner through two
single-axis exchanges), all through ``lattice.gather_neighbor(mesh=…)``.
Every other term is site-local, so the box holds the numbers of the
whole lattice's build on its sites, and no rank holds a field of the
whole lattice.  ``shard_dirac`` cuts the box out of an operator that the
caller built on the whole lattice.

A ``ShardedDirac`` is a ``Dirac`` on the local geometry (the box's)
whose hop ``dslash`` is K4 on the channel field and its faces, in the
field's precision (float64 for complex128: the counterpart of
``Dirac.dslash`` through K1 f64), so ``m``, ``matpc``, ``prepare`` and
``reconstruct`` are the full-lattice operator's on this box.  Every
parity-diagonal term is local.

The sharded fused chain is the unsharded one (``Dirac._fused_matpc_ch``,
that is ``dirac._ch_matpc``, and ``_fused_matpc_dagm_ch``) with
``halo_hop`` for its hop, a face exchange before each: on a t-ring K4,
which reads the received t faces in place,
or with ``overlap`` K5, whose interior runs while the faces,
spin-projected when T_loc > 2, are in flight; on a grid that splits z
or y, K4's box instances, which read the z and y faces too.  K4 takes
K1's second output, so M_pc†M_pc is four K4 hops, the dagger half's
leading A⁻¹† the second output of the forward half's last hop; K5 has
none, so its chain applies that A⁻¹† on its own (C6, through
``dirac._ch_clover_apply``).  ``matpc`` and ``matpc_dagm``
run the chain on complex fields in their precision (float64 for
complex128, on K4's float64 forms), on operands of that precision in
the bf16 operand tier too; ``matpc_ch`` and ``matpc_dagm_ch`` run it on
float32 channels and the tier's operands (bf16 there): the CG's
matvec.

The t boundary is read from the doubled links
(``ops.dslash_kernel.antiperiodic_t``): ``shard_dirac`` reads the whole
lattice's before the cut; ``make_sharded_dirac`` reads each box's rows
of global t = 0 and T−1 and takes the grid's maximum of the offsets, so
the ranks that hold the boundary tell every rank.  With the
antiperiodic boundary, the box's hops take the local rows of global
t = 0 and T−1 (``ShardedDirac.t_rows``) and restore the sign that
recon-12 drops there.
"""

from __future__ import annotations

import functools

import torch

from quda_qkxtm_multigrid_tpu_torch.dirac import Dirac, DiracParams
from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry
from quda_qkxtm_multigrid_tpu_torch.ops import clover as _cl
from quda_qkxtm_multigrid_tpu_torch.ops import dslash as _dsl
from quda_qkxtm_multigrid_tpu_torch.ops.dslash_kernel import (
    antiperiodic_t, dslash_ch_local, dslash_ch_overlap, from_channels,
    to_channels)
from quda_qkxtm_multigrid_tpu_torch.parallel.halo import (
    box_faces, start_t_faces, t_faces)
from quda_qkxtm_multigrid_tpu_torch.parallel.mesh import (
    TMesh, box_slab, local_geometry)
from quda_qkxtm_multigrid_tpu_torch.utils.profiling import op_entry


def halo_hop(mesh: TMesh, overlap: bool, g_ch, psi_ch, parity: int,
             geom: Geometry, dagger: bool = False, recon12: bool = False,
             twist=None, xpay_coef=None, x_ch=None, clover=None,
             cinv_ch=None, t_boundary=None, post_op=None):
    """One sharded hop with ``dslash_ch_local``'s arguments on the local
    box: the face exchange, then K4, or with ``overlap`` K5 with the
    exchange's wait between its interior and its edges (the faces
    spin-projected when T_loc > 2).  On a grid that splits z or y the
    exchange carries the z and y faces too and K4 reads them
    (``halo.box_faces``); ``overlap`` raises there.  ``t_boundary``:
    None (periodic), or the box's rows of global t = 0 and T−1
    (``ShardedDirac.t_rows``).  ``post_op``: K4's second output, as
    ``dslash_ch``'s (returns ``(out, out2)``); K5 has none and raises."""
    kw = dict(dagger=dagger, recon12=recon12, twist=twist,
              xpay_coef=xpay_coef, x_ch=x_ch, clover=clover, cinv_ch=cinv_ch,
              t_boundary=t_boundary)
    if mesh.box_split:
        if overlap:
            raise ValueError(f"overlap=True (K5) splits t faces only: grid "
                             f"{mesh.grid} splits z or y")
        face_m, face_p, zw = box_faces(psi_ch, mesh, geom.Xh)
        return dslash_ch_local(g_ch, psi_ch, face_m, face_p, parity, geom,
                               zw_faces=zw, post_op=post_op, **kw)
    if not overlap:
        return dslash_ch_local(g_ch, psi_ch, *t_faces(psi_ch, mesh), parity,
                               geom, post_op=post_op, **kw)
    if post_op is not None:
        raise ValueError("overlap=True (K5) has no second output: its "
                         "chain runs the dagger half's A⁻¹† plain")
    project = geom.T > 2
    ex = start_t_faces(psi_ch, mesh, project=project, dagger=dagger)
    return dslash_ch_overlap(g_ch, psi_ch, ex.face_m, ex.face_p, parity,
                             geom, faces_projected=project, wait=ex.wait,
                             **kw)


class ShardedDirac(Dirac):
    """This rank's box of an operator on ``mesh`` (module docstring):
    the fields of a ``Dirac`` on the local geometry, and the whole
    lattice's ``global_geom``."""

    def __init__(self, u, params, geom: Geometry, mesh: TMesh,
                 global_geom: Geometry, clover=None, clover_inv=None,
                 u_doubled=None, antiperiodic: bool = False):
        super().__init__(u, params, geom, clover=clover,
                         clover_inv=clover_inv, u_doubled=u_doubled)
        self.mesh = mesh
        self.global_geom = global_geom
        self._antiperiodic = antiperiodic   # the whole lattice's boundary

    @property
    def t_rows(self) -> tuple:
        """The local rows of global t = 0 and T−1 (outside [0, T_loc)
        on a rank that holds neither)."""
        return _t_rows(self.mesh, self.global_geom)

    def _hop_kw(self) -> dict:
        """The gauge keywords of every halo hop: recon-12, and the rows
        whose t links carry the boundary's sign (None if periodic)."""
        return dict(recon12=True,
                    t_boundary=self.t_rows if self.antiperiodic else None)

    @property
    def _has_fused_matpc(self) -> bool:
        # the unsharded chain (K1, and K2 on a batch) would wrap inside
        # the box; the sharded chain's own routing is has_sharded_chain
        return False

    @property
    def has_sharded_chain(self) -> bool:
        """Whether the sharded fused chain applies (``matpc``,
        ``matpc_dagm``, ``matpc_ch``, ``matpc_dagm_ch``): the conditions
        of the unsharded fused chain (use_kernels, symmetric Schur form,
        a twisted or clover kind)."""
        return Dirac._has_fused_matpc.fget(self)

    def _require_chain(self):
        if not self.has_sharded_chain:
            raise ValueError("the sharded chain needs use_kernels, the "
                             "symmetric Schur form and a twisted or clover "
                             "kind")

    def _halo(self, overlap: bool = False):
        """The chain's hop: ``halo_hop`` on this operator's mesh."""
        return functools.partial(halo_hop, self.mesh, overlap)

    def dslash(self, psi_opp: torch.Tensor, parity: int,
               dagger: bool = False) -> torch.Tensor:
        psi_ch = to_channels(psi_opp)
        ops = self._operands(psi_ch.dtype, exact=True)
        out = halo_hop(self.mesh, False, ops["g"][parity], psi_ch, parity,
                       self.geom, dagger, **self._hop_kw())
        return from_channels(out, (4, 3))

    @op_entry("op.matpc")
    def matpc(self, psi_p: torch.Tensor, dagger: bool = False):
        """M_pc (or M_pc†) of a complex field on this box: on the sharded
        chain two halo hops with their epilogues (the dagger half after
        its leading A⁻¹† or twist), in the field's precision on operands
        of that precision; otherwise ``Dirac``'s composition of
        ``dslash`` and the plain A⁻¹."""
        if not self.has_sharded_chain:
            return super().matpc(psi_p, dagger)
        out = self._fused_matpc_ch(to_channels(psi_p), dagger,
                                   hop=self._halo(), exact=True)
        return from_channels(out, (4, 3))

    @op_entry("op.matpc", applies=2)
    def matpc_dagm(self, psi_p: torch.Tensor) -> torch.Tensor:
        """M_pc†M_pc of a complex field on this box: on the sharded chain
        four K4 hops, no plain A⁻¹† (``matpc``'s precision and
        operands); otherwise ``matpc`` twice."""
        if not self.has_sharded_chain:
            return super().matpc_dagm(psi_p)
        out = self._fused_matpc_dagm_ch(to_channels(psi_p),
                                        hop=self._halo(), exact=True)
        return from_channels(out, (4, 3))

    def matpc_ch(self, psi_ch: torch.Tensor, dagger: bool = False,
                 overlap: bool = False) -> torch.Tensor:
        """The sharded fused matpc (or matpc†) on this box's channel
        field [T_loc, 24, Z_loc, W_loc] and the tier's operands, the JAX
        package's chain: two halo hops (K4, or K5 with ``overlap`` on a
        t-ring), the dagger half after a stand-alone A⁻¹† (C6) or twist."""
        self._require_chain()
        return self._fused_matpc_ch(psi_ch, dagger, hop=self._halo(overlap))

    def matpc_dagm_ch(self, psi_ch: torch.Tensor,
                      overlap: bool = False) -> torch.Tensor:
        """The sharded fused matpc†·matpc on this box's channel field and
        the tier's operands, the sharded CG's matvec: four K4 hops, the
        dagger half's leading A⁻¹† the second output of the forward
        half's last hop (``Dirac._fused_matpc_dagm_ch``); with
        ``overlap`` K5, which has no second output: ``matpc_ch`` twice,
        the dagger half after a stand-alone A⁻¹† (C6)."""
        if overlap:
            return self.matpc_ch(self.matpc_ch(psi_ch, False, True), True,
                                 True)
        self._require_chain()
        return self._fused_matpc_dagm_ch(psi_ch, hop=self._halo())

    def flops_per_mat(self) -> int:
        """Analytic flops of one application of the whole lattice's
        operator (every rank)."""
        return super().flops_per_mat() * self.mesh.size


def _t_rows(mesh: TMesh, geom: Geometry) -> tuple:
    """The local rows of global t = 0 and T−1 of this rank's box of a
    lattice ``geom``."""
    t0, _ = mesh.t_range(geom.T)
    return (-t0, geom.T - 1 - t0)


def make_sharded_dirac(u_slab: torch.Tensor, params: DiracParams,
                       geom: Geometry, mesh: TMesh,
                       antiperiodic=None) -> ShardedDirac:
    """This rank's box of the operator of a gauge field on the whole
    lattice ``geom``, built from the rank's box of the links ``u_slab``
    [4, 2, 3, 3, T_loc, Z_loc, W_loc] alone (module docstring), on the
    mesh's device: the clover term and its (twisted) inverse for a
    clover kind, the doubled gauge always (the halo hop reads it), and
    the t boundary read over the grid unless ``antiperiodic`` gives
    it."""
    gl = local_geometry(geom, mesh)
    if tuple(u_slab.shape[-3:]) != gl.lat_shape:
        raise ValueError(f"u_slab has the lattice axes "
                         f"{tuple(u_slab.shape[-3:])}: this rank's box has "
                         f"{gl.lat_shape}")
    u = u_slab.to(mesh.device)
    clover = clover_inv = None
    if params.has_clover:
        clover, clover_inv = _cl.make_clover_pair(u, gl, params, mesh)
    ud = _dsl.double_gauge(u, gl, mesh)
    if antiperiodic is None:
        antiperiodic = antiperiodic_t(ud, _t_rows(mesh, geom), mesh.allmax)
    return ShardedDirac(u, params, gl, mesh, geom, clover=clover,
                        clover_inv=clover_inv, u_doubled=ud,
                        antiperiodic=antiperiodic)


def shard_dirac(dirac: Dirac, mesh: TMesh) -> ShardedDirac:
    """This rank's box of an operator that the caller built on the whole
    lattice, on the mesh's device (module docstring).  The doubled gauge
    is built on the whole lattice first where the operator has none, and
    the t boundary read from it."""
    geom = dirac.geom
    gl = local_geometry(geom, mesh)
    ud = dirac.u_doubled
    if ud is None:
        ud = _dsl.double_gauge(dirac.u, geom)
    antiperiodic = antiperiodic_t(ud)

    def cut(t):
        return None if t is None else box_slab(t, mesh)
    return ShardedDirac(cut(dirac.u), dirac.params, gl, mesh, geom,
                        clover=cut(dirac.clover),
                        clover_inv=cut(dirac.clover_inv), u_doubled=cut(ud),
                        antiperiodic=antiperiodic)


def local_block(dirac: ShardedDirac) -> Dirac:
    """The Schwarz block operator of this rank: a plain ``Dirac`` on the
    box's geometry and links, with the t, z and y wraps *inside* the box
    (the JAX package's shard-local ``Dirac`` of ``parallel/schwarz.py``,
    whose local geometry is the shard's).  The gauge is re-doubled on
    the box (with ``use_kernels``, for K1 on the local geometry); the
    box's clover and A⁻¹ are kept as they are.

    The block's t wrap link is the box's last forward t link: it carries
    the antiperiodic boundary's −1 on the ranks that hold global
    t = T−1 and no sign elsewhere.  Recon-12 drops that sign, so the
    block is told its boundary (``antiperiodic`` on those ranks only,
    read from the whole lattice's links through ``dirac.t_rows``), and
    K1 restores it on the last local row, where it lies."""
    geom = dirac.geom
    ud = (_dsl.double_gauge(dirac.u, geom) if dirac.params.use_kernels
          else None)
    block = Dirac(dirac.u, dirac.params, geom, clover=dirac.clover,
                  clover_inv=dirac.clover_inv, u_doubled=ud)
    block._antiperiodic = (dirac.antiperiodic
                           and dirac.t_rows[1] == geom.T - 1)
    return block
