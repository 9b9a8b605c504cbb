// The chiral 6x6 clover apply on the planar-channel layout (CUDA C++ for
// sm_90a).
//
// Replaces no Pallas kernel: the JAX package applies these blocks as an
// XLA pass, quda_qkxtm_multigrid_tpu/dirac.py::_ch_clover_apply (the
// 6x6 contraction unrolled into elementwise multiply-adds).  On the card
// the port's plain version of it (dirac._ch_clover_plain) widens the
// whole operand, builds a complex matrix field, permutes both operands
// into batch-major copies for a batched 6x6 gemv and stacks the result
// back into channels: ~25 GB of traffic for one 48^3x96 parity whose
// operands are 2.55 GB.  This kernel takes every A, A^-1 and A^-1-dagger
// apply on channel spinors (ops/dslash_kernel.clover_ch): the compact
// operator's full operator, prepare and reconstruct, and the leading
// A^-1-dagger of a dagger Schur chain that has no second output to take
// it from.
//
// What it computes, at every site of one parity and for each of n
// sources: out = M v (dag = 0) or M^dag v (dag = 1) on the two chiral
// 6-blocks, M at channel ((h*6+r)*6+c)*2 + ri of the operand
// [T, 144, Z, W] (dslash_ch.cuh's chiral_apply, term for term), then,
// where twist_a != 0, out += i a g5 v (g5 = +1 on block 0, -1 on block 1;
// the twisted term of A + i a g5).  v and out are [n, T, 24, Z, W].
// Five instances (entry point, operand, v, arithmetic and out):
//   qkx_clover_ch_f32_c16     bf16    float  float   the bf16 tier's A, its
//                                                    A^-1 with cinv_bf16
//   qkx_clover_ch_f32_c16s16  bf16    bf16   float   the same on the bf16
//                                                    spinor storage
//   qkx_clover_ch_f32         float   float  float   the bf16 tier's A^-1,
//                                                    the float32 tier
//   qkx_clover_ch_f32_s16     float   bf16   float   A^-1-dagger on the bf16
//                                                    spinor storage
//   qkx_clover_ch_f64         double  double double  the float64 tier
// Every load widens to the arithmetic type (bf16 -> float is exact) and
// every store is one rounding from it, as the hops' (dslash_ch.cuh).
//
// Bound: device-memory bytes.  A site reads 144 operand reals and 24
// spinor reals and writes 24: 480 B with a bf16 operand and float
// spinors, 768 B in float, 1,536 B in double, for 288 real multiply-adds
// (~0.6-1.2 flop/B against the H100's ~20).  So the kernel streams: one
// thread per V consecutive sites of a (t, z) row, W innermost, so that
// neighbouring threads read neighbouring addresses of every channel
// plane, and each channel a vector load of V values.  V = 4 for bf16
// and float operands (8 and 16 B), V = 1 for double: measured at 48^3x96
// on an H100, V = 8 on bf16 took 172 registers and lost 12 % in dag, and
// V = 2 on double was 1 % slower than V = 1.  Nothing is staged in
// shared memory: no operand value is read by two sites.  Where the plane
// size Z*W or an address does not allow the vector (a tensor that starts
// mid-vector), the launch takes V = 1, which is chiral_apply itself.
// The n sources of one tile are consecutive blocks, so the operand tile
// that the first of them brings from device memory the others find in
// L2.
//
// Host side: a plain C interface for ctypes (no PyTorch headers).  Every
// pointer is a device pointer; the stream is PyTorch's current stream.
// The launch neither synchronises nor allocates.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching for an empty shape.

#include "dslash_ch.cuh"

using bf16 = __nv_bfloat16;

namespace qkx {

// V consecutive stored reals, loaded and stored as one vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename R, typename T, int V>
__device__ __forceinline__ void load_v(const T* p, R (&o)[V]) {
  const Pack<T, V> k = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = static_cast<R>(ld(&k.x[j]));
}

template <typename O, typename R, int V>
__device__ __forceinline__ void store_v(O* p, const R (&o)[V]) {
  Pack<O, V> k;
#pragma unroll
  for (int j = 0; j < V; ++j) st(&k.x[j], o[j]);
  *reinterpret_cast<Pack<O, V>*>(p) = k;
}

// Block b holds source b % n of the sites [(b / n) * kThreads * V, ...)
// of the parity, flattened over (t, z, w); sites = T * zw.
template <typename R, typename C, typename S, int V, bool DAG>
__global__ void __launch_bounds__(kThreads)
    clover6_ch_kernel(const C* __restrict__ m, const S* __restrict__ v,
                      R* __restrict__ out, int64_t zw, int64_t sites, int n,
                      R twist_a) {
  const int64_t b = blockIdx.x;
  const int64_t src = b % n;
  const int64_t s0 = ((b / n) * kThreads + threadIdx.x) * V;
  if (s0 >= sites) return;
  const int64_t t = s0 / zw, site = s0 - t * zw;
  const C* ms = m + t * 144 * zw + site;
  const int64_t off = (src * (sites / zw) + t) * 24 * zw + site;
  const S* vs = v + off;
  R* os = out + off;
  if constexpr (V == 1) {
    Cplx<R> in[12], res[12];
#pragma unroll
    for (int kk = 0; kk < 12; ++kk) in[kk] = load_c<R>(vs, 2 * kk, zw);
    chiral_apply<R>(ms, zw, DAG, in, res);
#pragma unroll
    for (int kk = 0; kk < 12; ++kk) {
      if (twist_a != R(0)) {
        const R ag = kk < 6 ? twist_a : -twist_a;
        res[kk] = cadd(res[kk], Cplx<R>{-ag * in[kk].im, ag * in[kk].re});
      }
      store_c(os, 2 * kk, zw, res[kk]);
    }
  } else {
    // one chiral block at a time: its 6 spinor values of V sites live in
    // registers while its 36 matrix entries stream past
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      R vr[6][V], vi[6][V];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        load_v<R>(vs + (int64_t)(2 * (h * 6 + c)) * zw, vr[c]);
        load_v<R>(vs + (int64_t)(2 * (h * 6 + c) + 1) * zw, vi[c]);
      }
      const R ag = h == 0 ? twist_a : -twist_a;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        R sr[V], si[V];
#pragma unroll
        for (int j = 0; j < V; ++j) sr[j] = si[j] = R(0);
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const int row = DAG ? c : r, col = DAG ? r : c;
          const int ch = ((h * 6 + row) * 6 + col) * 2;
          R er[V], ei[V];
          load_v<R>(ms + (int64_t)ch * zw, er);
          load_v<R>(ms + (int64_t)(ch + 1) * zw, ei);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const Cplx<R> e = {er[j], ei[j]}, x = {vr[c][j], vi[c][j]};
            const Cplx<R> p = DAG ? cjmul(e, x) : cmul(e, x);
            sr[j] += p.re;
            si[j] += p.im;
          }
        }
        if (twist_a != R(0)) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            sr[j] += -ag * vi[r][j];
            si[j] += ag * vr[r][j];
          }
        }
        store_v(os + (int64_t)(2 * (h * 6 + r)) * zw, sr);
        store_v(os + (int64_t)(2 * (h * 6 + r) + 1) * zw, si);
      }
    }
  }
}

template <typename R, typename C, typename S, int V>
void launch_clover6_instance(const C* m, const S* v, R* out, int64_t zw,
                             int64_t sites, int n, int dag, R twist_a,
                             cudaStream_t s) {
  const int64_t tiles = (sites / V + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(tiles * n)), block(kThreads);
  if (dag)
    clover6_ch_kernel<R, C, S, V, true><<<grid, block, 0, s>>>(
        m, v, out, zw, sites, n, twist_a);
  else
    clover6_ch_kernel<R, C, S, V, false><<<grid, block, 0, s>>>(
        m, v, out, zw, sites, n, twist_a);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename R, typename C, typename S>
int launch_clover6(const void* m, const void* v, void* out, int n, int T,
                   int Z, int W, int dag, double twist_a, void* stream) {
  constexpr int V = sizeof(C) == 8 ? 1 : 4;
  const int64_t zw = (int64_t)Z * W, sites = (int64_t)T * zw;
  if (n < 1 || sites < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* mc = static_cast<const C*>(m);
  const auto* vc = static_cast<const S*>(v);
  auto* oc = static_cast<R*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zw % V == 0 && aligned(m, sizeof(C) * V) &&
      aligned(v, sizeof(S) * V) && aligned(out, sizeof(R) * V))
    launch_clover6_instance<R, C, S, V>(mc, vc, oc, zw, sites, n, dag,
                                        static_cast<R>(twist_a), s);
  else
    launch_clover6_instance<R, C, S, 1>(mc, vc, oc, zw, sites, n, dag,
                                        static_cast<R>(twist_a), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qkx

#define QKX_CLOVER_ENTRY(NAME, R, C, S)                                      \
  extern "C" int NAME(const void* m, const void* v, void* out, int n, int T, \
                      int Z, int W, int dag, double twist_a, void* stream) { \
    return qkx::launch_clover6<R, C, S>(m, v, out, n, T, Z, W, dag,          \
                                        twist_a, stream);                    \
  }

QKX_CLOVER_ENTRY(qkx_clover_ch_f32_c16, float, bf16, float)
QKX_CLOVER_ENTRY(qkx_clover_ch_f32_c16s16, float, bf16, bf16)
QKX_CLOVER_ENTRY(qkx_clover_ch_f32, float, float, float)
QKX_CLOVER_ENTRY(qkx_clover_ch_f32_s16, float, float, bf16)
QKX_CLOVER_ENTRY(qkx_clover_ch_f64, double, double, double)
