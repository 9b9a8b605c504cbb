"""Random fields from an explicit ``torch.Generator``.

Same distributions as the JAX package's ``utils/rng.py``: Gaussian
complex entries, SU(3) links by Gram-Schmidt on rows 0 and 1 with
row 2 = conj(r0 × r1), and Z4 noise {1, i, −1, −i}.  The bits differ from JAX's; the parity tests
make their inputs with numpy instead.  The generator must live on the
device the field is made on.
"""

from __future__ import annotations

import torch

from quda_qkxtm_multigrid_tpu_torch.lattice import Geometry


def normal_complex(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Complex Gaussian entries of ``shape`` (real parts drawn first,
    then imaginary), on the generator's device."""
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    re = torch.randn(shape, generator=gen, dtype=rdt, device=gen.device)
    im = torch.randn(shape, generator=gen, dtype=rdt, device=gen.device)
    return torch.complex(re, im).to(dtype)


def random_spinor(gen: torch.Generator, geom: Geometry,
                  dtype=torch.complex128, batch_shape=()) -> torch.Tensor:
    """Gaussian random colour-spinor field [*batch_shape, 2, 4, 3, T, Z,
    W], drawn as one batch."""
    return normal_complex(gen, tuple(batch_shape) + (2, 4, 3)
                           + geom.lat_shape, dtype)


def su3_project_leading(a: torch.Tensor) -> torch.Tensor:
    """Project [3, 3, ...] (leading row, col axes) onto SU(3): Gram-Schmidt
    on rows 0 and 1, row 2 = conj(r0 × r1), so det = +1."""
    r0 = a[0] / torch.linalg.vector_norm(a[0], dim=0)
    r1 = a[1] - (r0.conj() * a[1]).sum(dim=0) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=0)
    r2 = torch.stack([r0[1] * r1[2] - r0[2] * r1[1],
                      r0[2] * r1[0] - r0[0] * r1[2],
                      r0[0] * r1[1] - r0[1] * r1[0]]).conj()
    return torch.stack([r0, r1, r2])


def random_su3(gen: torch.Generator, batch_shape,
               dtype=torch.complex128) -> torch.Tensor:
    """Random SU(3) matrices [3, 3, *batch_shape]."""
    return su3_project_leading(
        normal_complex(gen, (3, 3) + tuple(batch_shape), dtype))


def random_gauge(gen: torch.Generator, geom: Geometry,
                 dtype=torch.complex128) -> torch.Tensor:
    """Random SU(3) gauge field [4, 2, 3, 3, T, Z, W]."""
    u = random_su3(gen, (4, 2) + geom.lat_shape, dtype)
    return u.movedim((0, 1), (2, 3)).contiguous()


def unit_gauge(geom: Geometry, dtype=torch.complex128,
               device="cuda") -> torch.Tensor:
    """The unit gauge [4, 2, 3, 3, T, Z, W] (on the card unless
    ``device`` says otherwise)."""
    eye = torch.eye(3, dtype=dtype, device=device).reshape(1, 1, 3, 3, 1, 1,
                                                          1)
    return eye.expand((4, 2, 3, 3) + geom.lat_shape).contiguous()


def z4_source(gen: torch.Generator, geom: Geometry,
              dtype=torch.complex128) -> torch.Tensor:
    """Z4 stochastic volume source [2, 4, 3, T, Z, W], entries in
    {1, i, −1, −i} (the reference's Z4 generator), on the generator's
    device."""
    k = torch.randint(0, 4, (2, 4, 3) + geom.lat_shape, generator=gen,
                      device=gen.device)
    table = torch.tensor([1, 1j, -1, -1j], dtype=dtype, device=gen.device)
    return table[k]
