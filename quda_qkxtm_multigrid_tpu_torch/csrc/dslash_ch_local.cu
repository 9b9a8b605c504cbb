// The t-local fused Wilson hop of the t-sharded solve (CUDA C++ for
// sm_90a): kernels K4 and K5.
//
// Replaces the JAX package's Pallas TPU kernels
// quda_qkxtm_multigrid_tpu/ops/dslash_pallas5.py:
//   K4  dslash_ch_pallas5_local (pallas_call :768): K1 on a t-extended
//       local block [T_loc+2, 24, Z, W] whose rows 0 and T_loc+1 are the
//       halo planes of the t-1 and t+1 ranks; output [T_loc, 24, Z, W].
//       Here the block is not built: the slab [T_loc, 24, Z, W] and the
//       two received planes are read where they lie, in one launch;
//   K5  dslash_ch_pallas5_overlap_local (pallas_calls :842 and :902):
//       an interior launch over rows 1..T_loc-2, which needs no face and
//       runs while the faces are in flight, then one launch for the two
//       edge rows, which read the received faces: 24 channels, or the 12
//       of a 2-spinor that the sender projected with 1 +- g_4 (the
//       reference's lib/dslash_policy.cuh interior / exterior split and
//       its spin-projected ghost pack).
// Both reach them through Dirac._fused_matpc_ch_shmap (invert(mesh=...)).
//
// What it computes: K1's hop and epilogues (dslash_ch.cu: twist or chiral
// clover A / A^dag, then xpay; K4 also the second output), from the same
// device function dslash_site with TMODE 1, 2 or 3: t does not wrap, and the t
// neighbour of an output row is a row of psi or, for rows -1 and T, a
// face plane: 24 channels (TMODE 2, K4 and unprojected edges: a pointer
// swap, the load code is K1's) or 12 (TMODE 3, projected edges: the
// kernel loads the 2-spinor instead of projecting a neighbour; the same
// numbers, so K5 equals K4 bit for bit).  TMODE 1, no faces at all, is
// K5's interior.  Every output row keeps its true local t, so the
// checkerboard phase is the global one (T_loc is even: the slab's origin
// is even).  z, w and the x/y packing are K1's.
//
// Two sets of entry points onto the same kernels, recon-12 only (each
// kernel built for dagger or not, in the three t modes):
//   K5's, which take the output rows and the faces' channels, and no
//   second output:
//     qkx_dslash_ch_local_f32      float everything: the sharded matpc
//                                  chain;
//     qkx_dslash_ch_local_f64      double, bare hop;
//     qkx_dslash_ch_local_f32_g16  bf16 gauge and clover inverse, float
//                                  psi, x, out and faces: the chain in
//                                  the bf16 operand tier (K1d's types);
//   K4's, one launch over every row with the 24-channel faces (TMODE 2)
//   and K1's second output (out2: post 1 A^dag of the clover inverse,
//   computed from the A^-1 already in registers; 2 the twist (pa, pb);
//   post 0 none), every epilogue in double too: the hops of the sharded
//   chain, whose matpc^dag matpc is four of them and no plain A^-1^dag,
//   as K1's (dslash_ch.cu):
//     qkx_dslash_ch_local_post_f32, qkx_dslash_ch_local_post_f64,
//     qkx_dslash_ch_local_post_f32_g16.
// The kernels take every epilogue as run-time arguments, so both sets
// launch the same device code with the same registers.  K5 has no second
// output (its chain keeps the plain leading A^-1^dag).
//
// Bound: device-memory bytes, as K1 (576 B a site for the float bare
// hop: gauge 384, psi 96, out 96; the two faces add 2 / T_loc of psi's
// bytes).  One thread per output site, neighbouring threads on
// neighbouring w; a launch covers rows t0, t0 + tstep, ... so K5's two
// edge rows (t0 = 0, tstep = T_loc - 1) take one launch.  The exchange
// itself is NCCL's, on its own stream, outside the kernel.
//
// The antiperiodic t boundary (dslash_ch.cuh): bit kAntiperiodicT of
// parity, and t_first / t_last, the local rows of global rows 0 and T-1.
//
// Host side: a plain C interface for ctypes (no PyTorch headers).  Every
// pointer is a device pointer, or null where the epilogue or the face is
// off; the stream is PyTorch's current stream.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching for another gauge form.

#include "dslash_ch.cuh"

using bf16 = __nv_bfloat16;

extern "C" int qkx_dslash_ch_local_f32(
    const void* psi, const void* g, const void* cinv, const void* x,
    void* out, const void* face_m, const void* face_p, int face_ch, int T,
    int Z, int W, int Xh, int parity, int t0, int tstep, int nrows,
    int t_first, int t_last, int dagger, int recon12, int twist, double ta,
    double tb, int clover, int xpay, double xc, void* stream) {
  return qkx::launch_dslash_local<float, float, float, float, float, float>(
      psi, g, cinv, x, out, nullptr, face_m, face_p, face_ch, T, Z, W, Xh,
      parity, t0, tstep, nrows, t_first, t_last, dagger, recon12, twist, ta,
      tb, clover, xpay, xc, 0, 0.0, 0.0, stream);
}

extern "C" int qkx_dslash_ch_local_f64(
    const void* psi, const void* g, const void* cinv, const void* x,
    void* out, const void* face_m, const void* face_p, int face_ch, int T,
    int Z, int W, int Xh, int parity, int t0, int tstep, int nrows,
    int t_first, int t_last, int dagger, int recon12, int twist, double ta,
    double tb, int clover, int xpay, double xc, void* stream) {
  return qkx::launch_dslash_local<double, double, double, double, double,
                                  double>(
      psi, g, cinv, x, out, nullptr, face_m, face_p, face_ch, T, Z, W, Xh,
      parity, t0, tstep, nrows, t_first, t_last, dagger, recon12, twist, ta,
      tb, clover, xpay, xc, 0, 0.0, 0.0, stream);
}

extern "C" int qkx_dslash_ch_local_f32_g16(
    const void* psi, const void* g, const void* cinv, const void* x,
    void* out, const void* face_m, const void* face_p, int face_ch, int T,
    int Z, int W, int Xh, int parity, int t0, int tstep, int nrows,
    int t_first, int t_last, int dagger, int recon12, int twist, double ta,
    double tb, int clover, int xpay, double xc, void* stream) {
  return qkx::launch_dslash_local<float, bf16, bf16, float, float, float>(
      psi, g, cinv, x, out, nullptr, face_m, face_p, face_ch, T, Z, W, Xh,
      parity, t0, tstep, nrows, t_first, t_last, dagger, recon12, twist, ta,
      tb, clover, xpay, xc, 0, 0.0, 0.0, stream);
}

#define QKX_LOCAL_POST_ENTRY(NAME, R, G, C, S)                                \
  extern "C" int NAME(                                                        \
      const void* psi, const void* g, const void* cinv, const void* x,        \
      void* out, void* out2, const void* face_m, const void* face_p, int T,   \
      int Z, int W, int Xh, int parity, int t_first, int t_last, int dagger,  \
      int recon12, int twist, double ta, double tb, int clover, int xpay,     \
      double xc, int post, double pa, double pb, void* stream) {              \
    if (face_m == nullptr || face_p == nullptr)                               \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    return qkx::launch_dslash_local<R, G, C, S, S, S>(                        \
        psi, g, cinv, x, out, out2, face_m, face_p, 24, T, Z, W, Xh, parity,  \
        0, 1, T, t_first, t_last, dagger, recon12, twist, ta, tb, clover,     \
        xpay, xc, post, pa, pb, stream);                                      \
  }

QKX_LOCAL_POST_ENTRY(qkx_dslash_ch_local_post_f32, float, float, float, float)
QKX_LOCAL_POST_ENTRY(qkx_dslash_ch_local_post_f64, double, double, double,
                     double)
QKX_LOCAL_POST_ENTRY(qkx_dslash_ch_local_post_f32_g16, float, bf16, bf16,
                     float)
