// The fifth-dimension passes of the Moebius domain-wall operator on the
// planar-channel layout (kernel M5; CUDA C++ for sm_90a).
//
// Replaces no Pallas kernel: the JAX package applies these passes as XLA
// einsums (quda_qkxtm_multigrid_tpu/ops/domain_wall.py: mdw_dslash4_pre,
// mdw_dslash5_inv, each a contraction over s), and the port's plain
// versions are torch.einsum calls with permuted copies of the whole 5D
// field around a batched product (ops/domain_wall.mobius5_plain).  A
// matpc has ~10 such passes on the plain path; with this kernel it has 3
// launches (ops/domain_wall.MobiusDirac.matpc_ch).
//
// What it computes, for a field of one parity on channels [Ls, T, 24, Z,
// W] (real, float32): out(s) = sum_s' A_chi[s, s'] v(s') (+ a x(s)),
// chi = 0 for channels 0-11 (spins 0-1) and 1 for channels 12-23 (spins
// 2-3), A a real [2, Ls, Ls] matrix that the host builds once per
// operator in float64 (mobius5_matrices: D4pre, D4pre D5~^-1,
// kappa2 D5~^-1 and their adjoints).  out may not alias v or x.
//
// Bound: device-memory bytes.  A 4D half-site reads Ls x 96 B and writes
// Ls x 96 B, plus Ls x 96 B more with x: at 48^3x24, Ls 24, 6.12 GB a
// launch (9.17 GB with x), 1.83 ms at 3.35 TB/s.  The arithmetic is Ls^2
// multiply-adds for 2 Ls reals, 3 a byte at Ls = 24, under the card's
// float32 rate.  So each thread owns V = 4 consecutive (channel, z, w)
// positions of one (t) row: it loads the Ls x V values of its positions
// once (one 16-byte vector a slice, neighbouring threads on neighbouring
// addresses), keeps them in registers, and writes each out(s) once.  The
// matrix lives in shared memory, padded to LS (the template's Ls, a
// multiple of 4) with zeros and read as float4s that every thread of a
// warp shares (a broadcast).  Where Z*W or an address does not allow the
// vector, the launch takes V = 1.
//
// Host side: a plain C interface for ctypes (no PyTorch headers).  Every
// pointer is a device pointer; the stream is PyTorch's current stream.
// The launch neither synchronises nor allocates.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching for an empty shape or Ls > 32.

#include <cuda_runtime.h>

#include <cstdint>

namespace qkx_m5 {

constexpr int kThreads = 256;

template <int V>
struct alignas(4 * V) Vec {
  float x[V];
};

// Block b covers positions [b * kThreads * V, ...) of one s-plane of
// ``plane`` = T * 24 * zw reals.
template <int LS, int V, bool XPAY>
__global__ void __launch_bounds__(kThreads)
    mobius5_ch_kernel(const float* __restrict__ mat,
                      const float* __restrict__ v,
                      const float* __restrict__ x, float* __restrict__ out,
                      int ls, int64_t plane, int64_t zw, float a) {
  __shared__ __align__(16) float sm[2 * LS * LS];
  for (int k = threadIdx.x; k < 2 * LS * LS; k += kThreads) {
    const int h = k / (LS * LS), r = (k / LS) % LS, c = k % LS;
    sm[k] = (r < ls && c < ls) ? mat[(h * ls + r) * ls + c] : 0.f;
  }
  __syncthreads();
  const int64_t i0 =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) * (int64_t)V;
  if (i0 >= plane) return;
  // zw % V == 0: the V positions share one channel, so one chirality
  const int h = (int)((i0 / zw) % 24) / 12;
  const float* A = sm + h * LS * LS;
  float in[LS][V];
#pragma unroll
  for (int s = 0; s < LS; ++s) {
    if (s < ls) {
      const Vec<V> k = *reinterpret_cast<const Vec<V>*>(v + s * plane + i0);
#pragma unroll
      for (int j = 0; j < V; ++j) in[s][j] = k.x[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) in[s][j] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < LS; ++s) {
    if (s >= ls) break;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int r = 0; r < LS; r += 4) {
      const float4 m = *reinterpret_cast<const float4*>(A + s * LS + r);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] = fmaf(m.x, in[r][j], acc[j]);
        acc[j] = fmaf(m.y, in[r + 1][j], acc[j]);
        acc[j] = fmaf(m.z, in[r + 2][j], acc[j]);
        acc[j] = fmaf(m.w, in[r + 3][j], acc[j]);
      }
    }
    if constexpr (XPAY) {
      const Vec<V> k = *reinterpret_cast<const Vec<V>*>(x + s * plane + i0);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(a, k.x[j], acc[j]);
    }
    Vec<V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.x[j] = acc[j];
    *reinterpret_cast<Vec<V>*>(out + s * plane + i0) = o;
  }
}

template <int LS, int V>
void launch_ls(const float* mat, const float* v, const float* x, float* out,
               int ls, int64_t plane, int64_t zw, float a, cudaStream_t st) {
  const int64_t blocks = (plane / V + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (x != nullptr)
    mobius5_ch_kernel<LS, V, true>
        <<<grid, block, 0, st>>>(mat, v, x, out, ls, plane, zw, a);
  else
    mobius5_ch_kernel<LS, V, false>
        <<<grid, block, 0, st>>>(mat, v, x, out, ls, plane, zw, a);
}

template <int V>
void launch_v(const float* mat, const float* v, const float* x, float* out,
              int ls, int64_t plane, int64_t zw, float a, cudaStream_t st) {
  if (ls <= 8)
    launch_ls<8, V>(mat, v, x, out, ls, plane, zw, a, st);
  else if (ls <= 16)
    launch_ls<16, V>(mat, v, x, out, ls, plane, zw, a, st);
  else if (ls <= 24)
    launch_ls<24, V>(mat, v, x, out, ls, plane, zw, a, st);
  else
    launch_ls<32, V>(mat, v, x, out, ls, plane, zw, a, st);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace qkx_m5

// (mat [2, ls, ls], v [ls, rows, zw], x (or null) and out like v, ls,
//  rows = T * 24, zw = Z * W, a, stream)
extern "C" int qkx_mobius5_ch_f32(const void* mat, const void* v,
                                  const void* x, void* out, int ls, int rows,
                                  int zw, double a, void* stream) {
  using namespace qkx_m5;
  if (ls < 1 || ls > 32 || rows < 1 || zw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t plane = (int64_t)rows * zw;
  const auto* m = static_cast<const float*>(mat);
  const auto* vv = static_cast<const float*>(v);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zw % 4 == 0 && aligned(v, 16) && aligned(out, 16) &&
      (x == nullptr || aligned(x, 16)))
    launch_v<4>(m, vv, xx, o, ls, plane, zw, static_cast<float>(a), st);
  else
    launch_v<1>(m, vv, xx, o, ls, plane, zw, static_cast<float>(a), st);
  return static_cast<int>(cudaGetLastError());
}
