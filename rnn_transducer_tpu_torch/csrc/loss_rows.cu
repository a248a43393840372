// Two-pass RNN-T loss over materialised logits: score extraction and the
// gradient assembly, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/rnnt_loss_pallas.py `extract_lp`
// (kernel `_extract_kernel`) and `assemble_grad` (kernel `_grad_kernel`).
//
// Computes, for every lattice row r = (b, t, u) of V logits x (f32 or bf16,
// read as f32), with base = log(sum_v exp(x[v])) and lab = labels[b, u]
// (none at u = U):
//   extract_lp:    lp_blank[r] = x[blank] - base
//                  lp_y[r]     = x[lab] - base    (-1e30 at u = U)
//   assemble_grad: grad[r, v]  = p[v] occ[r] - [v = blank] g_blank[r]
//                                - [v = lab] g_y[r],  p[v] = exp(x[v] - base)
// with grad written in the logits' type. Where lab == blank both terms are
// subtracted. A label outside [0, V) counts as none.
//
// Layout: logits (B, T, U1, V), labels (B, U) int32, the per-row arrays
// (B, T, U1) f32. Any V: rows are read with 16-byte vector loads when V
// and the pointers allow it, element by element otherwise; no padding.
//
// Design: one warp per row, eight rows per block. A lane walks its share of
// the row with an online max and sum of exponentials (rescaling its sum
// when the max grows), and the warp joins the 32 pairs with shuffles. The
// blank and label logits are read once more by lane 0 after the sum.
// assemble_grad reads the row a second time to write the gradient, from L1
// or L2 (4 KB per row in f32), so the logits cross device memory about once
// each way.
//
// What bounds it on the H100: device memory. At B=32, T'=200, U1=81,
// V=1024 the f32 logits are 2.12 GB: extract_lp reads them once (0.63 ms at
// 3.35 TB/s), assemble_grad reads them and writes as much again (1.27 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLowest = -3.0e38f;  // start of a running max
constexpr int kWarps = 8;            // rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename X>
__device__ __forceinline__ X from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Values per 16-byte vector.
template <typename X>
struct Vec {
  static constexpr int n = 16 / (int)sizeof(X);
};

__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&o)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Fold value x into the running (m, s): s = sum exp(x_i - m).
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  if (x > m) {
    s *= expf(m - x);
    m = x;
  }
  s += expf(x - m);
}

// log(sum_v exp(row[v])) over the whole warp; every lane gets the result.
template <typename X>
__device__ __forceinline__ float row_logsumexp(const X* __restrict__ row,
                                               int V, bool vec, int lane) {
  constexpr int kV = Vec<X>::n;
  float m = kLowest;
  float s = 0.0f;
  if (vec) {
#pragma unroll 2
    for (int i = lane * kV; i < V; i += 32 * kV) {
      float x[kV];
      load_vec(row + i, x);
      float cm = x[0];
#pragma unroll
      for (int k = 1; k < kV; ++k) cm = fmaxf(cm, x[k]);
      if (cm > m) {
        s *= expf(m - cm);
        m = cm;
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) s += expf(x[k] - m);
    }
  } else {
    for (int i = lane; i < V; i += 32) online_add(to_float(row[i]), m, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    const float mx = fmaxf(m, m2);
    s = s * expf(m - mx) + s2 * expf(m2 - mx);
    m = mx;
  }
  return m + logf(s);
}

// The label of row r (b, t, u), or -1 at u = U or outside [0, V).
__device__ __forceinline__ int row_label(const int* __restrict__ labels,
                                         size_t r, int T, int U1, int V) {
  const int u = (int)(r % U1);
  if (u == U1 - 1) return -1;
  const size_t b = r / ((size_t)T * U1);
  const int lab = labels[b * (U1 - 1) + u];
  return (lab >= 0 && lab < V) ? lab : -1;
}

template <typename X>
__global__ void __launch_bounds__(kWarps * 32)
extract_lp_kernel(const X* __restrict__ logits, const int* __restrict__ labels,
                  float* __restrict__ lp_blank, float* __restrict__ lp_y,
                  size_t rows, int T, int U1, int V, int blank, bool vec) {
  const int lane = threadIdx.x % 32;
  const size_t r = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const X* row = logits + r * V;
  const float base = row_logsumexp(row, V, vec, lane);
  if (lane == 0) {
    const int lab = row_label(labels, r, T, U1, V);
    lp_blank[r] = to_float(row[blank]) - base;
    lp_y[r] = lab >= 0 ? to_float(row[lab]) - base : kNegInf;
  }
}

template <typename X>
__global__ void __launch_bounds__(kWarps * 32)
assemble_grad_kernel(const X* __restrict__ logits,
                     const int* __restrict__ labels,
                     const float* __restrict__ occ,
                     const float* __restrict__ g_blank,
                     const float* __restrict__ g_y, X* __restrict__ grad,
                     size_t rows, int T, int U1, int V, int blank, bool vec) {
  constexpr int kV = Vec<X>::n;
  const int lane = threadIdx.x % 32;
  const size_t r = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const X* row = logits + r * V;
  X* out = grad + r * V;
  const float base = row_logsumexp(row, V, vec, lane);
  const int lab = row_label(labels, r, T, U1, V);
  const float o = occ[r];
  const float gb = g_blank[r];
  const float gy = g_y[r];
  if (vec) {
#pragma unroll 2
    for (int i = lane * kV; i < V; i += 32 * kV) {
      float x[kV];
      load_vec(row + i, x);
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        float g = expf(x[k] - base) * o;
        if (i + k == blank) g -= gb;
        if (i + k == lab) g -= gy;
        x[k] = g;
      }
      store_vec(out + i, x);
    }
  } else {
    for (int i = lane; i < V; i += 32) {
      float g = expf(to_float(row[i]) - base) * o;
      if (i == blank) g -= gb;
      if (i == lab) g -= gy;
      out[i] = from_float<X>(g);
    }
  }
}

// Vector loads need V a multiple of the vector and 16-byte aligned rows.
template <typename X>
bool can_vectorise(int V, const void* a, const void* b) {
  return V % Vec<X>::n == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

dim3 grid_for(size_t rows) {
  return dim3((unsigned)((rows + kWarps - 1) / kWarps));
}

template <typename X>
int run_extract(const void* logits, const void* labels, void* lp_blank,
                void* lp_y, size_t rows, int T, int U1, int V, int blank,
                cudaStream_t s) {
  extract_lp_kernel<X><<<grid_for(rows), kWarps * 32, 0, s>>>(
      static_cast<const X*>(logits), static_cast<const int*>(labels),
      static_cast<float*>(lp_blank), static_cast<float*>(lp_y), rows, T, U1,
      V, blank, can_vectorise<X>(V, logits, logits));
  return (int)cudaGetLastError();
}

template <typename X>
int run_grad(const void* logits, const void* labels, const void* occ,
             const void* g_blank, const void* g_y, void* grad, size_t rows,
             int T, int U1, int V, int blank, cudaStream_t s) {
  assemble_grad_kernel<X><<<grid_for(rows), kWarps * 32, 0, s>>>(
      static_cast<const X*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(occ), static_cast<const float*>(g_blank),
      static_cast<const float*>(g_y), static_cast<X*>(grad), rows, T, U1, V,
      blank, can_vectorise<X>(V, logits, grad));
  return (int)cudaGetLastError();
}

}  // namespace

// lp_blank and lp_y (B, T, U1) f32 from logits (B, T, U1, V), f32 or bf16
// (logits_is_bf16), in one pass. Returns 0 or the launch's cudaError_t.
extern "C" int extract_lp(const void* logits, int logits_is_bf16,
                          const void* labels, void* lp_blank, void* lp_y,
                          int B, int T, int U1, int V, int blank, int device,
                          void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t rows = (size_t)B * T * U1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_is_bf16) {
    return run_extract<__nv_bfloat16>(logits, labels, lp_blank, lp_y, rows, T,
                                      U1, V, blank, s);
  }
  return run_extract<float>(logits, labels, lp_blank, lp_y, rows, T, U1, V,
                            blank, s);
}

// grad (B, T, U1, V) in the logits' type from the logits and the per-row
// occ, g_blank and g_y (B, T, U1) f32, in one pass.
extern "C" int assemble_grad(const void* logits, int logits_is_bf16,
                             const void* labels, const void* occ,
                             const void* g_blank, const void* g_y, void* grad,
                             int B, int T, int U1, int V, int blank,
                             int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t rows = (size_t)B * T * U1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_is_bf16) {
    return run_grad<__nv_bfloat16>(logits, labels, occ, g_blank, g_y, grad,
                                   rows, T, U1, V, blank, s);
  }
  return run_grad<float>(logits, labels, occ, g_blank, g_y, grad, rows, T, U1,
                         V, blank, s);
}
