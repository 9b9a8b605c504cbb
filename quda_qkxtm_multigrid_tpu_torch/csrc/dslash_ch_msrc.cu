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
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include "dslash_ch.cuh"

namespace {

constexpr int kThreads = 128;

// Grid (ceil(W / blockDim.x) * n, Z, T): blockIdx.x = w_block * n + source.
template <typename R, bool DAG, bool RECON12>
__global__ void __launch_bounds__(kThreads)
    dslash_ch_msrc_kernel(const qkx::DslashArgs<R> a, int n) {
  const int s = blockIdx.x % n;
  const int w = (blockIdx.x / n) * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  const int64_t per_source = (int64_t)a.T * 24 * a.Z * a.W;
  qkx::dslash_site<R, DAG, RECON12>(a, (int)blockIdx.z, (int)blockIdx.y, w,
                                    s * per_source);
}

}  // namespace

extern "C" int qkx_dslash_ch_msrc_f32(const void* psi, const void* g,
                                      const void* cinv, const void* x,
                                      void* out, int n, int T, int Z, int W,
                                      int Xh, int parity, int dagger,
                                      int recon12, int twist, double ta,
                                      double tb, int clover, int xpay,
                                      double xc, void* stream) {
  using R = float;
  qkx::DslashArgs<R> a;
  a.psi = static_cast<const R*>(psi);
  a.g = static_cast<const R*>(g);
  a.cinv = static_cast<const R*>(cinv);
  a.x = static_cast<const R*>(x);
  a.out = static_cast<R*>(out);
  a.out2 = nullptr;
  a.T = T;
  a.Z = Z;
  a.W = W;
  a.Xh = Xh;
  a.parity = parity;
  a.twist = twist;
  a.ta = static_cast<R>(ta);
  a.tb = static_cast<R>(tb);
  a.clover = clover;
  a.xpay = xpay;
  a.xc = static_cast<R>(xc);
  a.post = 0;
  a.pa = R(0);
  a.pb = R(0);
  const dim3 block(kThreads);
  const dim3 grid(((W + kThreads - 1) / kThreads) * n, Z, T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dagger) {
    if (recon12) dslash_ch_msrc_kernel<R, true, true><<<grid, block, 0, s>>>(a, n);
    else dslash_ch_msrc_kernel<R, true, false><<<grid, block, 0, s>>>(a, n);
  } else {
    if (recon12) dslash_ch_msrc_kernel<R, false, true><<<grid, block, 0, s>>>(a, n);
    else dslash_ch_msrc_kernel<R, false, false><<<grid, block, 0, s>>>(a, n);
  }
  return static_cast<int>(cudaGetLastError());
}
