// The bf16 spinor storage form of the fused Wilson hop (CUDA C++ for
// sm_90a): kernel K1e.
//
// Replaces the JAX package's Pallas TPU kernel K1 / K1-slab with
// out_dtype=jnp.bfloat16, quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:
// dslash_ch_pallas5 / dslash_ch_pallas5_slab (the bf16 output planes of
// their pallas_call, and the bf16 psi / x planes that _kernel_v5._mk and
// the x loader widen).  In the JAX package this is the bf16-spinor
// storage tier of CompactDirac.matpc_ch(out_dtype=...) /
// matpc_dagm_ch(storage_dtype=...) (compact.py) and of
// benchmarks.bench_bf16_spinor: the QUDA-half spinor analogue without a
// norm array (bf16 keeps float's exponent).
//
// What it computes: exactly K1's hop and epilogues (dslash_ch.cu), from
// the same device function (dslash_ch.cuh), with a bf16 recon-12 gauge, a
// float clover inverse, and bf16 planes for some of psi, x and the
// outputs.  Every load widens to float (exact), the arithmetic is float,
// and each output value is rounded once, at the store, to the nearest
// bf16 (ties to even, __float2bfloat16_rn, as XLA's convert in the TPU
// kernel's store()).  Four instances, recon-12 only, every epilogue:
//
//   entry point                     psi   x     A^-1  out   used by (compact.py)
//   qkx_dslash_ch_f32_g16c32_o16    f32   f32   f32   bf16  matpc_ch(out_dtype=bf16), first hop
//   qkx_dslash_ch_f32_g16c32_s16o16 bf16  f32   f32   bf16  its second hop (x = psi); the bare
//                                                           bf16-spinor hop of bench_bf16_spinor
//   qkx_dslash_ch_f32_g16c32_x16    f32   bf16  f32   f32   matpc_ch(bf16 t, dagger): last hop
//   qkx_dslash_ch_f32_g16c32_s16    bf16  f32   f32   f32   the twisted-mass dagger hop after
//                                                           the plain twist of a bf16 t
//
// (the dagger hop after the plain A^-1-dagger of the clover chain reads
// float planes: qkx_dslash_ch_f32_g16c32 in dslash_ch_bf16.cu).
//
// Bound: device-memory bytes, as K1.  Per output site the bare hop reads
// 192 B of bf16 gauge and writes and reads 48 B of bf16 spinor: 288 B
// against K1d's 384.  Inside the compact matpc^dag matpc chain the float
// A^-1 (576 B a hop, three hops) dominates: 3,984 B a site with bf16
// spinor storage (3,264 in the four kernels, 720 in the plain A^-1-dagger
// between them) against 4,224 with float storage.  The arithmetic is
// K1's (~1,300-1,900 flop a site), far below the H100's balance point.
// The design is K1's: one thread per output site, neighbouring threads on
// neighbouring w, so the two-byte loads and stores stay coalesced.
// Nothing is staged in shared memory yet.
//
// Host side: a plain C interface for ctypes with the argument list of
// dslash_ch.cu.  An instance built for recon-12 only returns
// cudaErrorInvalidValue for any other gauge form without launching.
// Returns cudaGetLastError() after the launch (0 on success).

#include "dslash_ch.cuh"

using bf16 = __nv_bfloat16;

#define QKX_K1E_ENTRY(NAME, S, X, O)                                        \
  extern "C" int NAME(const void* psi, const void* g, const void* cinv,     \
                      const void* x, void* out, void* out2, int T, int Z,   \
                      int W, int Xh, int parity, int dagger, int recon12,   \
                      int twist, double ta, double tb, int clover,          \
                      int xpay, double xc, int post, double pa, double pb,  \
                      void* stream) {                                       \
    return qkx::launch_dslash_r12<float, bf16, float, S, X, O>(             \
        psi, g, cinv, x, out, out2, T, Z, W, Xh, parity, dagger, recon12,   \
        twist, ta, tb, clover, xpay, xc, post, pa, pb, stream);             \
  }

QKX_K1E_ENTRY(qkx_dslash_ch_f32_g16c32_o16, float, float, bf16)
QKX_K1E_ENTRY(qkx_dslash_ch_f32_g16c32_s16o16, bf16, float, bf16)
QKX_K1E_ENTRY(qkx_dslash_ch_f32_g16c32_x16, float, bf16, float)
QKX_K1E_ENTRY(qkx_dslash_ch_f32_g16c32_s16, bf16, float, float)
