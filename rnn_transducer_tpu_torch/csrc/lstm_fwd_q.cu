// W8A8 LSTM recurrence, forward (inference), for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/lstm_pallas.py `_lstm_core_fwd_v2_q`
// (kernel `_fwd_kernel_v2_q`), the int8 serving core that
// `lstm_layer_pallas` runs for an int8 QTensor W_hh.
//
// Computes, for t = 0 .. T-1, with gate order i, f, g, o, for each batch
// tile of BT rows (BT from the JAX package's `_tile_bt_v2`, chosen by the
// wrapper; it decides which rows share one scale and so the result):
//   amax  = max(max |h_{t-1}| over the BT x H tile, 1e-6)
//   hq    = round_half_even(h_{t-1} * (127 / amax))        int8
//   acc   = hq @ Wq                                        int32, exact
//   gates = x_proj[:, t] + float(acc) * (scale * (amax / 127))
//   c_t   = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)    (fp32)
//   h_t   = sigmoid(o) * tanh(c_t)                         (fp32)
// The float operations keep the JAX kernel's order: 127 / amax before the
// product, scale * (amax / 127) before the product with acc, and no
// contraction into fused multiply-adds (the __f*_rn intrinsics), so the
// kernel matches its plain version up to the rounding of expf / tanhf.
//
// Layout: x_proj (B, T, 4H) f32 or bf16, Wq (H, 4H) int8, scale (4H) f32,
// h0/c0 (B, H) f32 -> hs (B, T, H) f32 and c (B, H) f32, the final cell
// state (serving reads hs and c_T only). h_{t-1} is read back from
// hs[:, t-1] (or h0).
//
// Design: a pack kernel first rewrites Wq as (H/4, 4H) int32 words, each
// holding Wq[4k .. 4k+3, n], so that one __dp4a takes four k of one
// column. Then one step kernel per t, as csrc/lstm_fwd.cu: a block owns
// kUnits hidden units (one per lane) of kRows batch rows, its kSlices warps
// split the k reduction, and each thread sums all four gates of its unit
// in int32. The step's amax is re-reduced by every block from the BT x H
// tile of h_{t-1} in global memory (16 KB at B = 8, H = 512), so no launch
// depends on a reduction written by another block of the same launch, and
// a max is the same in any order.
//
// What bounds it on the H100: as K4-fwd, the T steps run one after another
// as separate launches, and each step rereads all of the packed Wq (1 MB
// at H = 512, half of bf16) from L2 with 16 blocks in flight at the
// serving shape B = 8. Launch latency, paid T times, dominates; a
// persistent kernel is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

// wp[k4 * H4 + n] = bytes Wq[4 k4 + 0 .. 3, n], byte 0 in the low bits.
__global__ void pack_wq_kernel(const int8_t* __restrict__ wq,
                               int* __restrict__ wp, int H, int H4) {
  const size_t n_words = (size_t)(H / 4) * H4;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < n_words; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t k4 = idx / H4;
    const size_t n = idx - k4 * H4;
    const uint32_t b0 = (uint8_t)wq[(4 * k4 + 0) * H4 + n];
    const uint32_t b1 = (uint8_t)wq[(4 * k4 + 1) * H4 + n];
    const uint32_t b2 = (uint8_t)wq[(4 * k4 + 2) * H4 + n];
    const uint32_t b3 = (uint8_t)wq[(4 * k4 + 3) * H4 + n];
    wp[idx] = (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
lstm_q_step_kernel(const X* __restrict__ x_proj, const int* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ h0, const float* __restrict__ c0,
                   float* __restrict__ hs, float* __restrict__ c, int B,
                   int T, int H, int BT, int t) {
  extern __shared__ int smem[];
  int* part = smem;                                // [kSlices][kRows][4][kUnits]
  int8_t* hq = reinterpret_cast<int8_t*>(part + kSlices * kRows * 4 * kUnits);
  __shared__ float warp_max[kSlices];
  const int lane = threadIdx.x % kUnits;
  const int slice = threadIdx.x / kUnits;
  const int j = blockIdx.x * kUnits + lane;
  const int b0 = blockIdx.y * kRows;
  const int H4 = 4 * H;

  // h_{t-1} of row b, unit k
  auto h_prev = [&](int b, int k) -> float {
    return (t == 0) ? h0[(size_t)b * H + k]
                    : hs[((size_t)b * T + (t - 1)) * H + k];
  };

  // amax over this block's batch tile (kRows divides BT, or BT = B < kRows)
  const int tile0 = (b0 / BT) * BT;
  float m = 0.0f;
  for (int idx = threadIdx.x; idx < BT * H; idx += kThreads) {
    const int r = idx / H;
    m = fmaxf(m, fabsf(h_prev(tile0 + r, idx - r * H)));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) warp_max[slice] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int s = 1; s < kSlices; ++s) amax = fmaxf(amax, warp_max[s]);
  amax = fmaxf(amax, 1e-6f);
  const float inv = __fdiv_rn(127.0f, amax);

  // this block's rows, quantized; rows past B are zero
  for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
    const int r = idx / H;
    const int b = b0 + r;
    int q = 0;
    if (b < B) q = __float2int_rn(__fmul_rn(h_prev(b, idx - r * H), inv));
    hq[idx] = (int8_t)q;
  }
  __syncthreads();

  int acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0;
  }
  if (j < H) {
    const int K4 = H / 4;
    const int per = (K4 + kSlices - 1) / kSlices;
    const int k0 = slice * per;
    const int k1 = min(K4, k0 + per);
    const int* hq_w = reinterpret_cast<const int*>(hq);
#pragma unroll 2
    for (int k4 = k0; k4 < k1; ++k4) {
      const int* wk = wp + (size_t)k4 * H4 + j;
      const int w0 = wk[0];
      const int w1 = wk[H];
      const int w2 = wk[2 * H];
      const int w3 = wk[3 * H];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int hv = hq_w[r * K4 + k4];
        acc[r][0] = __dp4a(hv, w0, acc[r][0]);
        acc[r][1] = __dp4a(hv, w1, acc[r][1]);
        acc[r][2] = __dp4a(hv, w2, acc[r][2]);
        acc[r][3] = __dp4a(hv, w3, acc[r][3]);
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
  const float step = __fdiv_rn(amax, 127.0f);
  const X* xp = x_proj + ((size_t)b * T + t) * H4 + j;
  float pre[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int s = 0;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) {
      s += part[((sl * kRows + r) * 4 + g) * kUnits + lane];
    }
    const float sg = __fmul_rn(scale[g * H + j], step);
    pre[g] = __fadd_rn(to_float(xp[g * H]), __fmul_rn(__int2float_rn(s), sg));
  }
  const float gi = sigmoid(pre[0]);
  const float gf = sigmoid(pre[1]);
  const float gg = tanhf(pre[2]);
  const float go = sigmoid(pre[3]);
  const size_t bj = (size_t)b * H + j;
  const float c_prev = (t == 0) ? c0[bj] : c[bj];
  const float c_new = __fadd_rn(__fmul_rn(gf, c_prev), __fmul_rn(gi, gg));
  c[bj] = c_new;
  hs[((size_t)b * T + t) * H + j] = __fmul_rn(go, tanhf(c_new));
}

template <typename X>
int run_layer(const void* x_proj, const int* wp, const float* scale,
              const float* h0, const float* c0, float* hs, float* c, int B,
              int T, int H, int BT, cudaStream_t stream) {
  const size_t smem =
      (size_t)kSlices * kRows * 4 * kUnits * sizeof(int) + (size_t)kRows * H;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_q_step_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = 0; t < T; ++t) {
    lstm_q_step_kernel<X><<<grid, kThreads, smem, stream>>>(
        static_cast<const X*>(x_proj), wp, scale, h0, c0, hs, c, B, T, H, BT,
        t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// One call runs one layer: the pack kernel, then T step launches on
// `stream`. `w_packed` is (H/4, 4H) int32 scratch from the caller. BT must
// divide B and be a multiple of 8 or equal to B (< 8); H % 4 == 0. Returns
// 0, or the first cudaError_t a launch reported.
extern "C" int lstm_fwd_q(const void* x_proj, int x_is_bf16, const void* wq,
                          const void* scale, const void* h0, const void* c0,
                          void* w_packed, void* hs, void* c, int B, int T,
                          int H, int BT, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (H % 4 != 0 || BT <= 0 || B % BT != 0 || (BT % kRows != 0 && BT != B)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_words = (size_t)(H / 4) * 4 * H;
  const int blocks = (int)((n_words + 255) / 256 < 1024 ? (n_words + 255) / 256
                                                         : 1024);
  int* wp = static_cast<int*>(w_packed);
  pack_wq_kernel<<<blocks, 256, 0, s>>>(static_cast<const int8_t*>(wq), wp, H,
                                        4 * H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* sc = static_cast<const float*>(scale);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  if (x_is_bf16) {
    return run_layer<__nv_bfloat16>(x_proj, wp, sc, h0f, c0f,
                                    static_cast<float*>(hs),
                                    static_cast<float*>(c), B, T, H, BT, s);
  }
  return run_layer<float>(x_proj, wp, sc, h0f, c0f, static_cast<float*>(hs),
                          static_cast<float*>(c), B, T, H, BT, s);
}
