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
// Design. With W in bf16, J % 16 == 0 and V even (the training path), two
// launches on the forward's ring of wt_ring.cuh, which the band joint's
// forward (band_fused.cu, K6-fwd) shares:
//   joint_fwd_wt_kernel writes wt = W^T once a call, (V rounded up to 64,
//     pitch_j(J)) bf16, so that 64 columns of W are one contiguous run;
//   joint_fwd_ring_kernel runs wt_ring::fwd_body over the N = B T (U+1)
//     cells, flattened t-major (joint_rows.cuh's JointMap, which the
//     backward shares), with the row policy JointRowsF below: a block owns
//     64 consecutive cells (a block may span frames and utterances),
//     builds their round(z) once into shared memory, and walks V in
//     chunks of 64 columns, which thread 0 issues from wt into a two-slot
//     ring by TMA bulk copies (the next chunk in flight under this one's
//     products); per chunk the logits on mma.sync (`chunk_logits`, the
//     same code as K2-A's ring, so the logits are K2-A's bit for bit) and
//     an online max / sum of exp and the blank's and the label's logit in
//     registers; after the last chunk the 4 lanes of a row and the two
//     column halves combine in a fixed order. One block barrier a chunk.
// With W in f32 (the parity runs), or other shapes: joint_fwd_kernel on
// the CUDA cores, grid (cell blocks of kBM, B), each thread a 4 x 8 tile,
// z kept k-major in W's type (rows padded by 16 bytes against bank
// conflicts), W staged kBK rows at a time, the log-sum-exp a half-warp a
// row over chunks of kBN columns.
//
// What bounds it on the H100: the logits product, 2 N J V flops (275
// GFLOP at libri100's B=32, T'=200, U+1=41, J=512, V=1024; 0.28 ms at the
// 989 TFLOP/s bf16 dense peak). The ring reads W once a call (the W^T
// pass) and each block streams its chunks from L2 by TMA, with no barrier
// between a copy and the products but the slot's; what is left is
// mma.sync from shared memory, 64 rows a block, one block an SM (4,100
// blocks, 32 waves at libri100). The f32 form runs on the CUDA cores (67
// TFLOP/s f32 peak). The next steps, for every user of the ring: A
// fragments in registers, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "joint_rows.cuh"
#include "wt_ring.cuh"

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

template <typename W>
int run_fwd(const void* f, const void* g, const void* labels, const void* w,
            const void* bias, void* lp_blank, void* lp_y, void* base, int B,
            int T, int U1, int J, int V, int blank, cudaStream_t stream) {
  const dim3 grid((T * U1 + kBM - 1) / kBM, B);
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

// The tensor-core form: two launches on the forward's ring of wt_ring.cuh.

using bf16 = __nv_bfloat16;
static_assert(kThreads == wt_ring::kThreads, "one block shape");

// The forward's cells: z from JointMap's f and g rows, the cell's label
// (-1 at u = U); lp_blank, lp_y and base stored at the cell. fwd_body
// hands over -base as lp_y for a label outside [0, V); a negative label
// (every cell at u = U) has no emit arc, and its lp_y is -1e30, as the
// TPU kernel's `jnp.where(lab >= 0, sel - base, NEG_INF)`.
struct JointRowsF {
  const int* __restrict__ labels;
  float* __restrict__ lp_blank;
  float* __restrict__ lp_y;
  float* __restrict__ base;
  JointMap map;
  __device__ long long f_row(long long r) const { return map.f_row(r); }
  __device__ long long g_row(long long r) const { return map.g_row(r); }
  __device__ int label(long long r) const { return map.label(labels, r); }
  __device__ void store(long long row, float lpb, float lpy,
                        float bse) const {
    lp_blank[row] = lpb;
    lp_y[row] = label(row) >= 0 ? lpy : kNegInf;
    base[row] = bse;
  }
};

__global__ void __launch_bounds__(kThreads)
joint_fwd_wt_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt, int J,
                    int V, int JP) {
  wt_ring::build_wt(w, wt, J, V, JP);
}

__global__ void __launch_bounds__(kThreads, 1)
joint_fwd_ring_kernel(const float* __restrict__ f,
                      const float* __restrict__ g,
                      const int* __restrict__ labels,
                      const bf16* __restrict__ wt,
                      const float* __restrict__ bias,
                      float* __restrict__ lp_blank, float* __restrict__ lp_y,
                      float* __restrict__ base, long long N, int T, int U1,
                      int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const JointRowsF rows{labels, lp_blank, lp_y, base,
                        JointMap{(long long)T * U1, U1}};
  wt_ring::fwd_body(smem_raw, f, g, rows, wt, bias, N, J, V, blank);
}

}  // namespace

// The CUDA-core form (f32 W, or bf16 W of a shape the ring does not take),
// one launch on `stream`. Returns 0, or the cudaError_t of the launch.
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

// The tensor-core form (W bf16, J % 16 == 0, V even), as two entry points
// so that a caller can time them apart. Both take the layout of
// ops/rnnt_band_fused.fwd_layout (wt's rows; the ring block's shared
// bytes) and return cudaErrorInvalidValue, launching nothing, for one that
// is not the kernel's.
//
// One launch: wt (wt_rows, pitch_j(J)) bf16 = W^T, wt_rows = V rounded up
// to 64, zero past V rows and J columns.
extern "C" int joint_fwd_wt(const void* w, void* wt, int J, int V,
                            long long wt_rows, long long smem_bytes,
                            int device, void* stream) {
  if (!wt_ring::fwd_layout_ok(J, V, wt_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  return wt_ring::launch_wt(joint_fwd_wt_kernel, static_cast<const bf16*>(w),
                            static_cast<bf16*>(wt), J, V, wt_rows, device,
                            static_cast<cudaStream_t>(stream));
}

// One launch: the ring kernel, one block a run of 64 cells with
// smem_bytes (wt_ring::fwd_ring_bytes(J)) of shared memory, writes
// lp_blank, lp_y and base, each (B, T, U1) f32, from wt.
extern "C" int joint_fwd_ring(const void* f, const void* g,
                              const void* labels, const void* wt,
                              const void* bias, void* lp_blank, void* lp_y,
                              void* base, int B, int T, int U1, int J, int V,
                              int blank, long long wt_rows,
                              long long smem_bytes, int device,
                              void* stream) {
  const long long N = (long long)B * T * U1;
  if (N < 1 || !wt_ring::fwd_layout_ok(J, V, wt_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = wt_ring::fwd_ring_bytes(J);
  const cudaError_t e1 = cudaFuncSetAttribute(
      joint_fwd_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e1 != cudaSuccess) return (int)e1;
  joint_fwd_ring_kernel<<<(unsigned)((N + wt_ring::kMR - 1) / wt_ring::kMR),
                          kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<const int*>(labels), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(lp_blank),
      static_cast<float*>(lp_y), static_cast<float*>(base), N, T, U1, J, V,
      blank);
  return (int)cudaGetLastError();
}
