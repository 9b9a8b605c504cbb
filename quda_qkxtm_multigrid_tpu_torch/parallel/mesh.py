"""The process grid (Gt, Gz, Gw) and the boxes of fields on it.

The counterpart of the JAX package's ``parallel/mesh.py`` on
``torch.distributed``: a ``LatticeMesh`` is a grid of Gt·Gz·Gw ranks,
one process each, that splits T, Z and Y (the merged axis W = Y·X/2
splits by whole y rows; x is never split, as in the JAX package and
the reference).  Rank r has the grid coordinates of the JAX package's
device order, ``np.arange(n).reshape(grid)``: r = (it·Gz + iz)·Gw + iw,
and holds the box [T/Gt, Z/Gz, (Y/Gw)·X/2] of every field at
(it·T_loc, iz·Z_loc, iw·Y_loc).  A t-ring is the grid (nt, 1, 1), and
``TMesh`` is the same class under its earlier name.

Every local extent must be even: the box's origin is then even in t, z
and y, so the checkerboard phase of every local site is the global one.
An axis of size 1 is not split (its hops wrap inside the rank).

The process group runs on NCCL for cards and on gloo for the CPU; even
a ring of one rank on a card has its NCCL group, so the reductions take
the path of a multi-card run.  A caller may run card fields over gloo
by asking for it (``init_ring(..., backend="gloo")``): several ranks on
one card, which NCCL refuses.  Such a mesh is ``staged``: its halo
messages and reductions are copied through host memory.

The caller starts the processes (``torchrun --nproc-per-node N``, or
its own spawn) and either initialises the default process group itself
and calls ``make_lattice_mesh``, or calls ``init_ring``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry

AXES = ("t", "z", "w")


@dataclasses.dataclass(frozen=True)
class LatticeMesh:
    """A grid (``nt``, ``nz``, ``nw``) of ranks; this process is ``rank``,
    its fields live on ``device``.  ``group`` is the process group (None:
    the default group); ``spatial_group`` the group of the Gz·Gw ranks
    that share this rank's t rows (None when Gz·Gw = 1); ``staged``: card
    fields on a gloo group, every message copied through the host."""

    nt: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    nz: int = 1
    nw: int = 1
    staged: bool = False
    spatial_group: Optional[object] = None

    @property
    def grid(self) -> tuple:
        return (self.nt, self.nz, self.nw)

    @property
    def size(self) -> int:
        return self.nt * self.nz * self.nw

    @property
    def coords(self) -> tuple:
        """(it, iz, iw) of this rank."""
        return (self.rank // (self.nz * self.nw),
                (self.rank // self.nw) % self.nz, self.rank % self.nw)

    @property
    def box_split(self) -> bool:
        """Whether z or y is split (the box path, not a t-ring)."""
        return self.nz > 1 or self.nw > 1

    def rank_of(self, it: int, iz: int, iw: int) -> int:
        """The rank at grid coordinates (each taken modulo its axis)."""
        return ((it % self.nt) * self.nz + iz % self.nz) * self.nw \
            + iw % self.nw

    def neighbours(self, axis: int) -> tuple:
        """(the rank one step back, the rank one step forward) along grid
        axis ``axis`` (0 t, 1 z, 2 w)."""
        c = list(self.coords)
        out = []
        for step in (-1, 1):
            n = list(c)
            n[axis] += step
            out.append(self.rank_of(*n))
        return tuple(out)

    @property
    def prev(self) -> int:
        """The rank of the t−1 neighbour box."""
        return self.neighbours(0)[0]

    @property
    def next(self) -> int:
        """The rank of the t+1 neighbour box."""
        return self.neighbours(0)[1]

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A message as it goes to the collective library: contiguous,
        on the host for a staged mesh."""
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def from_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A received message on this rank's device."""
        return t.to(self.device) if self.staged else t

    def allreduce(self, value: torch.Tensor) -> torch.Tensor:
        """The sum over every rank of a tensor of any shape (a new
        tensor).  A complex one is summed as its real pairs: the
        reductions of the collective libraries are not relied on for
        complex types."""
        v = self.to_wire(value.detach().clone())
        if v.is_complex():
            pairs = torch.view_as_real(v).contiguous()
            dist.all_reduce(pairs, op=dist.ReduceOp.SUM, group=self.group)
            return self.from_wire(torch.view_as_complex(pairs))
        v = v.reshape(-1)
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=self.group)
        return self.from_wire(v.reshape(value.shape))

    def allmax(self, value: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over every rank of a real tensor (a new
        tensor; ``value`` itself on a mesh of one)."""
        if self.size == 1:
            return value
        v = self.to_wire(value.detach().clone())
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return self.from_wire(v)

    def _allgather(self, x: torch.Tensor, group, n: int) -> list:
        v = self.to_wire(x)
        if v.is_complex():
            v = torch.view_as_real(v)
        parts = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(parts, v, group=group)
        if x.is_complex():
            parts = [torch.view_as_complex(p) for p in parts]
        return [self.from_wire(p) for p in parts]

    def allgather_box(self, x: torch.Tensor, axes: Sequence) -> torch.Tensor:
        """Every rank's block ``x`` joined by its grid coordinates (the same
        on every rank): along tensor axis ``axes[0]`` by it, ``axes[1]``
        by iz and ``axes[2]`` by iw.  An axis may be None only where the
        grid does not split it.  The whole lattice's field from the
        boxes (axes (−3, −2, −1) of a canonical field: the y blocks are
        whole rows of the merged axis), or the coarse residual [2, nvec,
        Tc, Zc, Yc, Xc] of the replicated coarse solve (axes (2, 3, 4)).
        ``x`` itself on a mesh of one (no copy).  ``LatticeMesh.gathers``
        counts the calls."""
        LatticeMesh.gathers += 1
        for a, n in zip(axes, self.grid):
            if a is None and n > 1:
                raise ValueError(f"allgather_box: grid {self.grid} splits "
                                 f"an axis that {tuple(axes)} does not "
                                 "name")
        if self.size == 1:
            return x
        parts = self._allgather(x, self.group, self.size)
        return _join(parts, self.grid, axes)

    def allgather_t(self, x: torch.Tensor, axis: int = -3) -> torch.Tensor:
        """``allgather_box`` on a t-ring: every rank's ``x`` joined along
        its t axis ``axis`` in rank order; raises on a z or y split."""
        return self.allgather_box(x, (axis, None, None))

    def allgather_spatial(self, x: torch.Tensor,
                          axes: Sequence) -> torch.Tensor:
        """The blocks of the Gz·Gw ranks that share this rank's t rows
        joined along ``axes`` = (z axis, y axis) by (iz, iw): the whole
        spatial volume of this rank's t rows, never the whole lattice.
        ``x`` itself when neither z nor y is split."""
        if not self.box_split:
            return x
        if self.spatial_group is None:
            raise ValueError("this mesh has no spatial group: make it with "
                             "make_lattice_mesh")
        n = self.nz * self.nw
        parts = self._allgather(x, self.spatial_group, n)
        return _join(parts, (1, self.nz, self.nw), (None,) + tuple(axes))

    def join_t(self, c: torch.Tensor, axis: int,
               partial: bool = False) -> torch.Tensor:
        """This rank's t rows of a value, along tensor axis ``axis``,
        joined whole along t on every rank.  On a t-ring the all-gather.
        On a box every rank writes its rows into zeros and one
        ``allreduce`` joins them: with ``partial`` the ranks of a t row
        hold parts of a sum (a box's momentum projection), which the
        reduction adds; without, they hold the value alike, and only the
        rank at (iz, iw) = (0, 0) writes it (a sum of one value and
        zeros: exact)."""
        if not self.box_split:
            return self.allgather_t(c, axis)
        axis = axis % c.dim()
        rows = c.shape[axis]
        shape = list(c.shape)
        shape[axis] = rows * self.nt
        whole = torch.zeros(shape, dtype=c.dtype, device=c.device)
        it, iz, iw = self.coords
        if partial or (iz == 0 and iw == 0):
            whole.narrow(axis, it * rows, rows).copy_(c)
        return self.allreduce(whole)

    def box_range(self, axis: int, extent: int) -> tuple:
        """(first, count) of this rank's part of a lattice axis of the
        whole lattice's ``extent`` (a fine or a coarse T, Z or Y) along
        grid axis ``axis`` (0 t, 1 z, 2 y)."""
        n = self.grid[axis]
        if extent % n:
            raise ValueError(f"{AXES[axis]} extent {extent} is not "
                             f"divisible by the grid's {n}")
        k = extent // n
        return self.coords[axis] * k, k

    def t_range(self, t_extent: int) -> tuple:
        """(first, count) of this rank's rows of a t axis of the whole
        lattice's extent ``t_extent`` (a fine T or a coarse Tc)."""
        return self.box_range(0, t_extent)


LatticeMesh.gathers = 0   # calls of allgather_box, for the benchmarks' records
TMesh = LatticeMesh


def _join(parts: list, grid: tuple, axes: Sequence) -> torch.Tensor:
    """The blocks ``parts`` in rank order on ``grid`` joined along
    ``axes`` (w fastest, then z, then t)."""
    nt, nz, nw = grid
    rows = []
    for it in range(nt):
        planes = []
        for iz in range(nz):
            row = parts[(it * nz + iz) * nw:(it * nz + iz + 1) * nw]
            planes.append(row[0] if nw == 1 else torch.cat(row, axes[2]))
        rows.append(planes[0] if nz == 1 else torch.cat(planes, axes[1]))
    return rows[0] if nt == 1 else torch.cat(rows, axes[0])


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _grid(grid) -> tuple:
    if isinstance(grid, int):
        grid = (grid, 1, 1)
    grid = tuple(int(g) for g in grid)
    if len(grid) != 3 or min(grid) < 1:
        raise ValueError(f"grid {grid} is not (Gt, Gz, Gw)")
    return grid


def make_lattice_mesh(grid: Sequence[int] = (1, 1, 1), device="cuda",
                      group=None,
                      backend: Optional[str] = None) -> LatticeMesh:
    """The mesh of ``grid`` = (Gt, Gz, Gw) over the initialised process
    group ``group`` (None: the default one), whose size must be
    Gt·Gz·Gw.  The group's backend must be ``backend``: by default NCCL
    for a card ``device`` and gloo for the CPU; ``backend="gloo"`` with a
    card makes a staged mesh (module docstring).  With a z or y split,
    every rank makes the Gt spatial groups here, together."""
    grid = _grid(grid)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the "
                           "ranks with torchrun or call init_ring")
    device = torch.device(device)
    want = backend or _backend(device)
    have = dist.get_backend(group)
    if have != want:
        raise ValueError(f"a {device.type} mesh needs the {want} backend, "
                         f"not {have}")
    size = dist.get_world_size(group)
    if size != math.prod(grid):
        raise ValueError(f"grid {grid} needs {math.prod(grid)} ranks, the "
                         f"group has {size}")
    nt, nz, nw = grid
    rank = dist.get_rank(group)
    spatial = None
    if nz * nw > 1:
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(size)))
        for it in range(nt):
            members = ranks[it * nz * nw:(it + 1) * nz * nw]
            g = dist.new_group(members, backend=want)
            if it == rank // (nz * nw):
                spatial = g
    return LatticeMesh(nt=nt, rank=rank, device=device, group=group, nz=nz,
                       nw=nw, staged=want == "gloo" and device.type == "cuda",
                       spatial_group=spatial)


def init_ring(grid, rank: int, init_method: str, device="cuda",
              backend: Optional[str] = None) -> LatticeMesh:
    """Initialise the default process group of the grid's ranks (``grid``
    = (Gt, Gz, Gw), or nt for a t-ring; ``init_method`` e.g.
    "tcp://localhost:<port>" or "file://<path>"; NCCL on a card, gloo on
    the CPU, unless ``backend`` asks for gloo on a card) and return its
    mesh.  A card ``device`` with an index becomes this process's
    current card."""
    grid = _grid(grid)
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend or _backend(device),
                            init_method=init_method,
                            world_size=math.prod(grid), rank=rank)
    return make_lattice_mesh(grid, device, backend=backend)


def _local(n: int, parts: int, name: str) -> int:
    if n % parts:
        raise ValueError(f"{name}={n} is not divisible by the grid's "
                         f"{parts}")
    loc = n // parts
    if loc % 2:
        raise ValueError(f"local {name} extent {loc} must be even (the "
                         "box's origin must be even)")
    return loc


def local_t(T: int, mesh: LatticeMesh) -> int:
    """T_loc of a lattice of extent ``T`` on ``mesh``; raises unless Gt
    divides T into even slabs."""
    if T % mesh.nt:
        raise ValueError(f"T={T} is not divisible by nt={mesh.nt}")
    return _local(T, mesh.nt, "T")


def local_geometry(geom: Geometry, mesh: LatticeMesh) -> Geometry:
    """The geometry of this rank's box of a lattice ``geom``: (X,
    Y/Gw, Z/Gz, T/Gt), every local extent even."""
    return Geometry(geom.X, _local(geom.Y, mesh.nw, "Y"),
                    _local(geom.Z, mesh.nz, "Z"), local_t(geom.T, mesh))


def box_slab(field: torch.Tensor, mesh: LatticeMesh) -> torch.Tensor:
    """This rank's box of a canonical field (trailing [T, Z, W]), on the
    mesh's device: its t rows, z planes and y rows (W/Gw consecutive
    entries of the merged axis).  The whole field on a mesh of one (no
    copy).  ``local_geometry`` checks that the extents are even."""
    t_loc = local_t(field.shape[-3], mesh)
    box = field.narrow(-3, mesh.coords[0] * t_loc, t_loc)
    for axis, dim in ((1, -2), (2, -1)):
        if mesh.grid[axis] > 1:
            box = box.narrow(dim, *mesh.box_range(axis, field.shape[dim]))
    return box.contiguous().to(mesh.device)


t_slab = box_slab


def shard_spinor(psi: torch.Tensor, mesh: LatticeMesh) -> torch.Tensor:
    """This rank's box of a spinor [..., 2, 4, 3, T, Z, W]."""
    return box_slab(psi, mesh)


def shard_gauge(u: torch.Tensor, mesh: LatticeMesh) -> torch.Tensor:
    """This rank's box of a gauge field [4, 2, 3, 3, T, Z, W]."""
    return box_slab(u, mesh)
