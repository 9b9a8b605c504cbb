"""PyTorch + CUDA port of quda_qkxtm_multigrid_tpu for one NVIDIA H100.

The package keeps the JAX package's module names, public function names
and canonical field layouts (see ``lattice.py``), so every function has
a counterpart of the same name and fields cross between the two packages
through numpy with no reindexing:

    spinor  [2, 4, 3, T, Z, W]
    gauge   [4, 2, 3, 3, T, Z, W]
    clover  [2, 2, 6, 6, T, Z, W]

Plain tensor code is PyTorch.  The Wilson-hop kernels that the JAX
package writes in Pallas (``ops/dslash_pallas5.py``) are hand-written
CUDA here: the single-source hop (``csrc/dslash_ch.cu``) and its
multi-source form (``csrc/dslash_ch_msrc.cu``), built by ``_build.py``
at first use.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on
a CUDA tensor it launches the kernel or raises.

The package imports ``torch`` and numpy only, never ``jax``.
"""
