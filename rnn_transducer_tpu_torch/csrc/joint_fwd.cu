// Fused joint network + log-softmax scores, forward, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/rnnt_joint_fused.py `joint_lp_fwd`
// (kernel `_fwd_kernel`, tile builder `_joint_tile`), and with it the
// experimental schedules of tools/exp_fwd_pipe.py, which compute the same.
//
// Computes, for every lattice cell (b, t, u):
//   z        = round(tanh(f[b, t] + g[b, u]))              (J values)
//   logits   = z . W + bias                                 (fp32 accumulate)
//   base     = log(sum_v exp(logits[v]))
//   lp_blank = logits[blank] - base
//   lp_y     = logits[labels[b, u]] - base  (u < U),  -1e30 at u = U
// where round() is the cast to W's type (bf16 or f32), as
// `z.astype(cdtype)` in the JAX kernel. The (B, T, U+1, V) logits are never
// written: only lp_blank, lp_y and base, each (B, T, U+1) f32.
//
// Layout: f (B, T, J) f32, g (B, U+1, J) f32, labels (B, U) int32,
// W (J, V) bf16 or f32, bias (V) f32. No padding of U+1, V or T.
//
// Design: a block owns kBM consecutive cells (t, u) of one utterance
// (the cells of an utterance are flattened t-major, so a block spans
// parts of a few frames). It builds round(z) for its cells once, in shared
// memory, then walks V in chunks of kBN columns. An online max /
// sum-of-exp runs across the chunks (a half-warp shares each row), and the
// blank and label columns are picked up as their chunk passes. Two ways to
// take a chunk's logits:
//   * W in bf16 (the training path): on the tensor cores, mma.sync
//     m16n8k16 with fp32 accumulate (mma_bf16.cuh), W streamed through
//     shared memory kMK rows at a time, transposed; the chunk is parked in
//     shared memory for the epilogue. Needs J % 16 == 0.
//   * W in f32 (the parity runs), or J % 16 != 0: CUDA-core FMAs, each
//     thread a 4 x 8 tile, z kept k-major in W's type (rows padded by 16
//     bytes against bank conflicts), W streamed kBK rows at a time.
//
// What bounds it on the H100: the output product, 2 * cells * J * V flops
// (275 GFLOP at libri100's B=32, T'=200, U+1=41, J=512, V=1024; 0.28 ms at
// the 989 TFLOP/s bf16 dense peak). The mma.sync path issues from shared
// memory with one W tile in flight and no TMA or wgmma pipeline, and every
// block rereads W (1 MB in bf16) from L2, 64 cells per read; the f32 path
// runs on the CUDA cores (67 TFLOP/s f32 peak). The next steps are wgmma
// with a TMA ring for W and more cells per W read (ROADMAP K1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;      // cells per block
constexpr int kBN = 128;     // V columns per chunk
constexpr int kBK = 32;      // rows of W staged per step
constexpr int kThreads = 256;
constexpr float kNegInf = -1.0e30f;

template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values from shared memory (16-byte or 8-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

template <typename W>
__host__ __device__ constexpr int zs_stride() {
  return kBM + 16 / (int)sizeof(W);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
joint_fwd_kernel(const float* __restrict__ f, const float* __restrict__ g,
                 const int* __restrict__ labels, const W* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ lp_blank,
                 float* __restrict__ lp_y, float* __restrict__ base_out,
                 int T, int U1, int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ZS = zs_stride<W>();
  W* zs = reinterpret_cast<W*>(smem_raw);              // [J][ZS]
  W* ws = zs + (size_t)J * ZS;                          // [kBK][kBN]
  float* sel_b = reinterpret_cast<float*>(ws + kBK * kBN);  // [kBM]
  float* sel_y = sel_b + kBM;                          // [kBM]
  int* lab_s = reinterpret_cast<int*>(sel_y + kBM);    // [kBM]

  const int b = blockIdx.y;
  const int TU = T * U1;
  const int U = U1 - 1;
  const int c0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx*8 .. tx*8+7 of a chunk
  const int ty = tid / 16;   // rows ty*4 .. ty*4+3

  // z for the block's cells: each warp reads 32 consecutive k of one cell.
  const int j_pad = (J + 31) / 32 * 32;
  for (int idx = tid; idx < kBM * j_pad; idx += kThreads) {
    const int k = (idx % 32) + 32 * (idx / (32 * kBM));
    const int r = (idx / 32) % kBM;
    if (k >= J) continue;
    const int c = c0 + r;
    float v = 0.0f;
    if (c < TU) {
      const int t = c / U1;
      const int u = c - t * U1;
      v = tanhf(f[((size_t)b * T + t) * J + k] + g[((size_t)b * U1 + u) * J + k]);
    }
    zs[(size_t)k * ZS + r] = from_float<W>(v);
  }
  for (int r = tid; r < kBM; r += kThreads) {
    const int c = c0 + r;
    const int u = (c < TU) ? c % U1 : U;
    lab_s[r] = (u < U) ? labels[(size_t)b * U + u] : -1;
    sel_b[r] = 0.0f;
    sel_y[r] = 0.0f;
  }

  float m_run[4], s_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
  }
  __syncthreads();

  for (int v0 = 0; v0 < V; v0 += kBN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
    }
    for (int k0 = 0; k0 < J; k0 += kBK) {
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        const int kk = idx / kBN;
        const int n = idx - kk * kBN;
        const int k = k0 + kk;
        const int v = v0 + n;
        ws[idx] = (k < J && v < V) ? w[(size_t)k * V + v] : from_float<W>(0.0f);
      }
      __syncthreads();
      const int kmax = min(kBK, J - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float z4[4], wa[4], wb[4];
        load4(zs + (size_t)(k0 + kk) * ZS + ty * 4, z4);
        load4(ws + kk * kBN + tx * 8, wa);
        load4(ws + kk * kBN + tx * 8 + 4, wb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][c] = fmaf(z4[i], wa[c], acc[i][c]);
            acc[i][c + 4] = fmaf(z4[i], wb[c], acc[i][c + 4]);
          }
        }
      }
      __syncthreads();
    }
    // Online log-sum-exp over this chunk; pick up blank and label columns.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float x[8];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int v = v0 + tx * 8 + c;
        x[c] = (v < V) ? acc[i][c] + bias[v] : -CUDART_INF_F;
        mloc = fmaxf(mloc, x[c]);
        if (v == blank) sel_b[r] = x[c];
        if (v == lab_s[r]) sel_y[r] = x[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      }
      const float m_new = fmaxf(m_run[i], mloc);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) s += expf(x[c] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      s_run[i] = s_run[i] * expf(m_run[i] - m_new) + s;
      m_run[i] = m_new;
    }
  }
  __syncthreads();

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int c = c0 + r;
      if (c >= TU) continue;
      const float bse = m_run[i] + logf(s_run[i]);
      const size_t o = (size_t)b * TU + c;
      base_out[o] = bse;
      lp_blank[o] = sel_b[r] - bse;
      lp_y[o] = (lab_s[r] >= 0) ? sel_y[r] - bse : kNegInf;
    }
  }
}

// With W in bf16 the product runs on the tensor cores (mma_bf16.cuh):
// the same block of kBM cells builds round(z) once, takes each kBN-column
// chunk of logits with mma.sync into registers, parks it in shared memory
// and runs the same online log-sum-exp epilogue. Needs J % 16 == 0.
static_assert(kBM == joint_mma::kMR && kBN == joint_mma::kMV
                  && kThreads == joint_mma::kMmaThreads,
              "the tensor-core path shares the FMA path's tiles");
constexpr int kLGP = kBN + 4;  // pitch of the f32 logits chunk

size_t mma_fwd_bytes(int J) {
  return (size_t)kBM * joint_mma::pitch_j(J) * 2
         + (size_t)kBN * joint_mma::kWTP * 2 + (size_t)kBM * kLGP * 4
         + 5 * kBM * 4;
}

__global__ void __launch_bounds__(kThreads)
joint_fwd_mma_kernel(const float* __restrict__ f, const float* __restrict__ g,
                     const int* __restrict__ labels,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ lp_blank, float* __restrict__ lp_y,
                     float* __restrict__ base_out, int T, int U1, int J,
                     int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int JP = joint_mma::pitch_j(J);
  __nv_bfloat16* zA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wt = zA + (size_t)kBM * JP;
  float* lg = reinterpret_cast<float*>(wt + kBN * joint_mma::kWTP);
  float* sel_b = lg + kBM * kLGP;
  float* sel_y = sel_b + kBM;
  int* lab_s = reinterpret_cast<int*>(sel_y + kBM);
  int* fo_s = lab_s + kBM;
  int* go_s = fo_s + kBM;

  const int b = blockIdx.y;
  const int TU = T * U1;
  const int U = U1 - 1;
  const int c0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int tx = tid % 16;   // epilogue: columns tx*8 .. tx*8+7
  const int ty = tid / 16;   // epilogue: rows ty*4 .. ty*4+3

  for (int r = tid; r < kBM; r += kThreads) {
    const int c = c0 + r;
    const int t = c / U1;
    const int u = c - t * U1;
    lab_s[r] = (c < TU && u < U) ? labels[(size_t)b * U + u] : -1;
    fo_s[r] = (c < TU) ? b * T + t : -1;
    go_s[r] = (c < TU) ? b * U1 + u : -1;
    sel_b[r] = 0.0f;
    sel_y[r] = 0.0f;
  }
  __syncthreads();
  joint_mma::build_z_rows(zA, JP, f, g, fo_s, go_s, J,
                          joint_mma::round_up(J, 16));

  float m_run[4], s_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
  }
  const int wm = warp / 4;
  const int wn = warp % 4;
  for (int v0 = 0; v0 < V; v0 += kBN) {
    float acc[2][4][4];
    joint_mma::logits_chunk(acc, zA, JP, wt, w, v0, J, V);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 32 + mi * 16 + gq + ((e >= 2) ? 8 : 0);
          const int col = wn * 32 + ni * 8 + 2 * q + (e & 1);
          lg[r * kLGP + col] = acc[mi][ni][e];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float x[8];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int v = v0 + tx * 8 + c;
        x[c] = (v < V) ? lg[r * kLGP + tx * 8 + c] + bias[v] : -CUDART_INF_F;
        mloc = fmaxf(mloc, x[c]);
        if (v == blank) sel_b[r] = x[c];
        if (v == lab_s[r]) sel_y[r] = x[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      }
      const float m_new = fmaxf(m_run[i], mloc);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) sum += expf(x[c] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      s_run[i] = s_run[i] * expf(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
  }
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int c = c0 + r;
      if (c >= TU) continue;
      const float bse = m_run[i] + logf(s_run[i]);
      const size_t o = (size_t)b * TU + c;
      base_out[o] = bse;
      lp_blank[o] = sel_b[r] - bse;
      lp_y[o] = (lab_s[r] >= 0) ? sel_y[r] - bse : kNegInf;
    }
  }
}

template <typename W>
int run_fwd(const void* f, const void* g, const void* labels, const void* w,
            const void* bias, void* lp_blank, void* lp_y, void* base, int B,
            int T, int U1, int J, int V, int blank, cudaStream_t stream) {
  const dim3 grid((T * U1 + kBM - 1) / kBM, B);
  if constexpr (std::is_same_v<W, __nv_bfloat16>) {
    if (J % 16 == 0) {
      const size_t smem = mma_fwd_bytes(J);
      const cudaError_t e = cudaFuncSetAttribute(
          joint_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      joint_fwd_mma_kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(f), static_cast<const float*>(g),
          static_cast<const int*>(labels),
          static_cast<const __nv_bfloat16*>(w),
          static_cast<const float*>(bias), static_cast<float*>(lp_blank),
          static_cast<float*>(lp_y), static_cast<float*>(base), T, U1, J, V,
          blank);
      return (int)cudaGetLastError();
    }
  }
  const size_t smem = (size_t)J * zs_stride<W>() * sizeof(W)
                      + (size_t)kBK * kBN * sizeof(W)
                      + 3 * kBM * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      joint_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  joint_fwd_kernel<W><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const int*>(labels), static_cast<const W*>(w),
      static_cast<const float*>(bias), static_cast<float*>(lp_blank),
      static_cast<float*>(lp_y), static_cast<float*>(base), T, U1, J, V,
      blank);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`. Returns 0, or the cudaError_t of the launch.
extern "C" int joint_fwd(const void* f, const void* g, const void* labels,
                         const void* w, int w_is_bf16, const void* bias,
                         void* lp_blank, void* lp_y, void* base, int B, int T,
                         int U1, int J, int V, int blank, int device,
                         void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_fwd<__nv_bfloat16>(f, g, labels, w, bias, lp_blank, lp_y, base,
                                  B, T, U1, J, V, blank, s);
  }
  return run_fwd<float>(f, g, labels, w, bias, lp_blank, lp_y, base, B, T, U1,
                        J, V, blank, s);
}
