// LSTM recurrence, inference forward, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/lstm_pallas.py `_lstm_core_fwd` (v1,
// batch-major, kernel `_fwd_kernel`) and `_lstm_core_fwd_v2` (v2,
// time-major, kernel `_fwd_kernel_v2`) on the primal path of `_lstm_core`
// (with_acts=False: no gate activations are saved).
//
// Computes, for t = 0 .. T-1, with gate order i, f, g, o:
//   gates = x_proj[:, t] + round(h_{t-1}) @ W_hh      (fp32 accumulate)
//   c_t   = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)  (fp32)
//   h_t   = sigmoid(o) * tanh(c_t)                       (fp32)
// where round() is the cast of h to the compute dtype of W_hh (bf16 or
// f32), as `h.astype(cdtype)` in the JAX kernel. Every row runs all T steps;
// pad rows compute values that stay in the pad region, as in JAX.
//
// Layout: x_proj (B, T, 4H) f32, W_hh (H, 4H) bf16 or f32, h0/c0 (B, H) f32
// -> hs (B, T, H) f32 and c (B, H) f32 (the final cell state). h_{t-1} is
// read back from hs[:, t-1] (or h0), so no step writes what it reads and
// no ping-pong buffer is needed.
//
// Design: the host entry point launches one step kernel per t on the
// caller's stream. A block owns kUnits hidden units j (one per lane) and
// kRows batch rows; its kSlices warps split the k (= H) reduction. Each
// thread computes all four gates of its unit, so the gate math fuses into
// the step with no exchange between blocks. Thread j reads W_hh[k, g*H + j],
// coalesced across the warp. h_{t-1} is staged in shared memory and read as
// a broadcast.
//
// What bounds it on the H100: every step rereads all of W_hh (2 MB in bf16
// at H = 512) from L2 with only H/kUnits * ceil(B/kRows) blocks (16 at the
// serving shape B = 8, H = 512) in flight, and the T steps run one after
// another as separate launches, so launch latency is paid T times.
//
// Later (ROADMAP K4): one persistent kernel for the whole sequence with
// W_hh split across the SMs' shared memory (2 MB / 132 SMs ~ 16 KB each),
// h exchanged every step through a grid barrier or a thread-block cluster,
// and the gate product on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kUnits = 32;   // hidden units per block: one per lane
constexpr int kSlices = 8;   // warps per block, each sums a slice of k
constexpr int kRows = 8;     // batch rows per block
constexpr int kThreads = kUnits * kSlices;
static_assert(kRows * kUnits == kThreads,
              "the gate epilogue maps one (row, unit) pair to each thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// h rounded to the compute dtype (round to nearest even), kept as float.
template <typename W>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ x_proj, const W* __restrict__ w_hh,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* __restrict__ hs, float* __restrict__ c, int B, int T,
                 int H, int t) {
  extern __shared__ float smem[];
  float* h_s = smem;                  // [kRows][H]: h_{t-1}, rounded
  float* part = smem + kRows * H;     // [kSlices][kRows][4][kUnits]
  const int lane = threadIdx.x % kUnits;
  const int slice = threadIdx.x / kUnits;
  const int j = blockIdx.x * kUnits + lane;
  const int b0 = blockIdx.y * kRows;
  const size_t H4 = 4 * (size_t)H;

  for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
    const int r = idx / H;
    const int k = idx - r * H;
    const int b = b0 + r;
    float v = 0.0f;
    if (b < B) {
      v = (t == 0) ? h0[(size_t)b * H + k]
                   : hs[((size_t)b * T + (t - 1)) * H + k];
    }
    h_s[idx] = round_to<W>(v);
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  }
  if (j < H) {
    const int per = (H + kSlices - 1) / kSlices;
    const int k0 = slice * per;
    const int k1 = min(H, k0 + per);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const W* wk = w_hh + (size_t)k * H4 + j;
      const float w0 = to_float(wk[0]);
      const float w1 = to_float(wk[H]);
      const float w2 = to_float(wk[2 * H]);
      const float w3 = to_float(wk[3 * H]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = h_s[r * H + k];
        acc[r][0] = fmaf(hv, w0, acc[r][0]);
        acc[r][1] = fmaf(hv, w1, acc[r][1]);
        acc[r][2] = fmaf(hv, w2, acc[r][2]);
        acc[r][3] = fmaf(hv, w3, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      part[((slice * kRows + r) * 4 + g) * kUnits + lane] = acc[r][g];
    }
  }
  __syncthreads();

  // Epilogue: thread (slice, lane) finishes row `slice` of unit j.
  const int r = slice;
  const int b = b0 + r;
  if (j >= H || b >= B) return;
  float s[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v = 0.0f;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) {
      v += part[((sl * kRows + r) * 4 + g) * kUnits + lane];
    }
    s[g] = v;
  }
  const float* xp = x_proj + ((size_t)b * T + t) * H4 + j;
  const float gi = sigmoid(xp[0] + s[0]);
  const float gf = sigmoid(xp[H] + s[1]);
  const float gg = tanhf(xp[2 * H] + s[2]);
  const float go = sigmoid(xp[3 * H] + s[3]);
  const size_t bj = (size_t)b * H + j;
  const float c_prev = (t == 0) ? c0[bj] : c[bj];
  const float c_new = gf * c_prev + gi * gg;
  c[bj] = c_new;
  hs[((size_t)b * T + t) * H + j] = go * tanhf(c_new);
}

template <typename W>
int run_layer(const void* x_proj, const void* w_hh, const void* h0,
              const void* c0, void* hs, void* c, int B, int T, int H,
              cudaStream_t stream) {
  const size_t smem =
      ((size_t)kRows * H + (size_t)kSlices * kRows * 4 * kUnits) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<W><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x_proj), static_cast<const W*>(w_hh),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(hs), static_cast<float*>(c), B, T, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// One call runs one layer: T step launches on `stream`. Returns 0, or the
// first cudaError_t a launch reported. `w_is_bf16` selects the W_hh type.
extern "C" int lstm_fwd(const void* x_proj, const void* w_hh, int w_is_bf16,
                        const void* h0, const void* c0, void* hs, void* c,
                        int B, int T, int H, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_layer<__nv_bfloat16>(x_proj, w_hh, h0, c0, hs, c, B, T, H, s);
  }
  return run_layer<float>(x_proj, w_hh, h0, c0, hs, c, B, T, H, s);
}

extern "C" const char* lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
