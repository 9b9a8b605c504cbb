// Multi-source fused Wilson hop on the planar-channel layout (CUDA C++
// for sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel K2,
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py::dslash_ch_pallas5_msrc
// and its slab form dslash_ch_pallas5_msrc_slab (both reached through
// dslash_ch_msrc_auto).  The slab is a TPU VMEM tiling of the same
// computation, so this one kernel replaces both.
//
// What it computes: K1's hop and epilogues (dslash_ch.cu) for each of n
// sources that share one gauge field and one clover inverse:
//   psi, x, out  [n, T, 24, Z, W] float, source s at offset s*T*24*Z*W;
//   g [T, 96|144, Z, W] and cinv [T, 144, Z, W] shared by every source.
// Epilogues: twist or chiral clover (fwd / dag), then xpay.  There is no
// second output (the TPU kernel has none either).
//
// Bound: device-memory bytes, as K1.  Per source and output site the
// bare hop needs psi in and out (192 B) plus 384 B of recon-12 gauge, and
// the clover epilogue 576 B more.  The TPU kernel keeps one t-plane's
// gauge and clover in VMEM while it walks the sources (grid (T, n),
// source innermost).  Here each thread still owns one output site of one
// source and runs K1's device function (dslash_site) unchanged, so a
// source's result is bitwise K1's; the block index puts the n sources of
// one (t, z, w-block) tile next to each other in launch order (source
// innermost in blockIdx.x), so the gauge and clover lines that the first
// source's blocks pull from HBM are still in the 50 MB L2 when the other
// sources' blocks read them.  The sources are not looped inside a thread:
// K1 already holds 120-126 registers per thread and n more accumulators
// would spill.  Staging the shared operands in shared memory is later
// work.
//
// Host side: a plain C interface for ctypes, as dslash_ch.cu.  Every
// pointer is a device pointer (cinv and x may be null where their
// epilogue is off); the stream is PyTorch's current stream.  Returns
// cudaGetLastError() after the launch (0 on success).  The kernel
// (dslash_ch_msrc_kernel) and its launcher are in dslash_ch.cuh; its
// bf16 operand tier (K2d) is in dslash_ch_bf16.cu.

#include "dslash_ch.cuh"

extern "C" int qkx_dslash_ch_msrc_f32(const void* psi, const void* g,
                                      const void* cinv, const void* x,
                                      void* out, int n, int T, int Z, int W,
                                      int Xh, int parity, int dagger,
                                      int recon12, int twist, double ta,
                                      double tb, int clover, int xpay,
                                      double xc, void* stream) {
  return qkx::launch_dslash_msrc<float, float, float, float, float, float>(
      psi, g, cinv, x, out, n, T, Z, W, Xh, parity, dagger, recon12, twist,
      ta, tb, clover, xpay, xc, stream);
}
