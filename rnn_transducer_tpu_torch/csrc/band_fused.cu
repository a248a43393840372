// Fused band joint + log-probs of the pruned RNN-T loss (K6), forward and
// both backward kernels, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/rnnt_band_fused.py `band_lp_fwd`
// (kernel `_fwd_kernel`), `band_lp_bwd_a` (`_bwd_a_kernel`) and
// `band_lp_bwd_b` (`_bwd_b_kernel`).
//
// The band has N = B * T * S rows, row r = (b * T + t) * S + s, one per
// cell (t, u = s_begin[t] + s) of the pruned lattice. Each row has its own
// predictor activation g_w[r] (gathered by the caller) and its own label
// lab_w[r]. For every row:
//   z        = tanh(f[b, t] + g_w[r])                     (J values, f32)
//   logits   = round(z) . W + bias                        (fp32 accumulate)
//   base     = max + log(sum_v exp(logits[v] - max))
//   lp_blank = logits[blank] - base,  lp_y = logits[lab_w[r]] - base
// (lp_y is -base when lab_w[r] is outside [0, V), as the TPU kernel's
// iota compare gives; the caller masks the rows past the labels). With the
// loss cotangents cb = dL/d lp_blank and cy = dL/d lp_y:
//   dlogits  = (cb + cy) (-p) + cb [v = blank] + cy [v = lab_w[r]],
//              p = exp(logits - base)
//   dz       = round(dlogits) . W^T * (1 - z^2)
//   dg_w[r]  = dz,  df[b, t] = sum_s dz,
//   dW       = sum_r round(z)^T round(dlogits),  db = sum_r dlogits.
// round() is the cast to W's type (bf16 or f32), as `astype(cdtype)` in
// the JAX kernels. The (N, V) logits never reach device memory.
//
// Layout: f (B, T, J) f32, g_w (B, T, S, J) f32, lab_w (B, T, S) int32,
// W (J, V) bf16 or f32, bias (V) f32, base / cb / cy (B, T, S) f32. No
// padding of S, V or T.
//
// Design. The TPU kernels keep W whole in VMEM (8.4 MB in bf16 at
// V = 8192) and, in kernel A, the dlogits of a whole tile; a Hopper block
// has 227 KB of shared memory. So the forward and kernel A share the ring
// of wt_ring.cuh: a first launch writes wt = W^T (V rounded up to 64,
// pitch_j(J)) bf16 once a call, so that 64 columns of W are one
// contiguous run; the second owns 64 rows a block: round(z) built once
// into shared memory, the rows' labels (A: sidecars) loaded once, then V
// in chunks of 64 columns, which thread 0 stages from wt into a two-slot
// ring with TMA bulk copies (the next chunk's in flight under this
// chunk's products), and per chunk the logits on the tensor cores (B
// fragments straight from the slot, `wt_ring::chunk_logits` for both).
//   fwd  the row policy BandRowsF below (f row r / S, g_w row r, lab_w[r];
//        lp_blank, lp_y and base stored at row r). Each thread keeps an
//        online max / sum of exp of its two rows over its 8 columns a
//        chunk and the blank's and the label's logit where it holds them,
//        in registers; after the last chunk the lanes of a row combine by
//        shuffles and the two column halves through shared memory, in a
//        fixed order. One block barrier a chunk.
//   A    the row policy BandRowsA below (BandRows' sidecars and dlogit,
//        and an epilogue that writes dg_w = dz (1 - z^2)). Per chunk,
//        after the logits, round(dlogits) into a (64, 64) bf16 tile, and
//        dz += round(dlogits) . W[:, chunk]^T with W's fragments from the
//        same slot by ldmatrix.trans; dz (64, J) f32 stays in registers
//        (warp w: j = 64 w ..). The epilogue writes dg_w from them;
//        df = sum_s dg_w is a third, ordered pass.
//   B    two launches on the ring of zb_ring.cuh, which the fused
//        joint's kernel B (joint_bwd.cu) shares, with the band's row
//        policy (lab_w, base, cb, cy and `dlogit` below). The first
//        writes zb = round(z) (N, J) bf16 once a call. The second owns
//        kVT = 64 V columns a block and walks
//        the rows in chunks of 64, which thread 0 stages from zb into a
//        two-slot ring in shared memory with TMA bulk copies, the next
//        chunk's copy in flight under this chunk's products. W[:, tile]^T
//        stays in shared memory and dW[:, tile] (J, 64) f32 in registers;
//        per chunk the logits of the tile and dW += round(z)^T
//        round(dlogits) on the tensor cores, z^T read from the ring by
//        ldmatrix.trans, db summed in row order; each chunk's sidecars
//        come through shared memory, loaded under the last chunk's
//        products. The grid is one wave
//        (ops/rnnt_band_fused.bwd_b_plan: 128 tiles x 1 split at V =
//        8192, 16 x 8 at V = 1024) whose blocks walk the same chunks in
//        the same order, so the chunks come from L2 and zb crosses HBM
//        about once. Row splits leave ordered partials, summed in split
//        order. No float atomics: two runs give the same bits.
// The tensor-core forms need W in bf16, J % 16 == 0 and V even; W in f32
// (the parity runs) and other shapes take CUDA-core forms of the same
// three kernels (B's with 32 columns a block and row_splits(V) splits).
//
// What bounds it on the H100: its products, 2 N J V flops each; the
// forward has one, A and B two each (the logits again, and dz or dW).
// At the pruned training shape (B=32, T'=200, S=8, J=512, V=8192, bf16)
// that is 0.43 ms for the forward and 0.87 ms for each backward kernel
// at 989 TFLOP/s. Each ring block reads all of wt from L2 (800 blocks,
// 6.8 GB at V = 8192). Measured on an NVIDIA H100 80GB HBM3, 700.00 W,
// by bench_band_bwd_b.py and chip_smoke.py, in turns with the earlier
// designs:
//   fwd  2.56 ms (12.0 with W staged by thread loads, 32 rows of J at a
//        time between two block barriers, and the logits through shared
//        memory behind a third; 0.39 at V = 1024, 1.65 before): the W^T
//        pass 0.02 ms, the ring kernel 2.54-2.57. A line through its time
//        at V = 64, 256, 1024 and 8192 gives 2.75 us a chunk a block and
//        ~10 us a block outside the chunk loop; 800 blocks in 7 waves of
//        132, one block an SM (202,512 bytes of shared memory).
//   A    4.10 ms (27.6-27.9 with dz in shared memory and W read from L2
//        per 64 rows; 0.68 at V = 1024, 3.95-3.97 before): the W^T pass
//        0.02 ms, the ring kernel and df's sum 4.09. A line through its
//        time at V = 64, 256, 1024 and 8192 gives 4.35 us a chunk a block
//        and 27 us a block outside the chunk loop (sidecars, round(z),
//        the epilogue, df's sum: each block's share of reading g_w twice
//        and writing dg_w, ~0.3 GB in all); 800 blocks run in 7 waves of
//        132, the last of 8. The logits, the dlogits and the dz product
//        run one after another between two block barriers a chunk, one
//        block of 8 warps an SM (not split by phase).
//   B    3.76 ms main kernel + 0.06 zb pass (0.51 + 0.06 at V = 1024):
//        4.7 us a chunk, with the same three phases between barriers.
// The next steps, for A and B alike, are wgmma with the stationary
// operand and the ring slot as shared-memory descriptors (each read
// once), warps that overlap one chunk's second product with the next
// chunk's logits, and for A a persistent grid that overlaps a block's
// epilogue with its next rows' z.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"
#include "wt_ring.cuh"
#include "zb_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;
using joint_mma::kMR;
using joint_mma::pitch_j;

constexpr int kThreads = 256;
constexpr int kMaxJ = 512;
static_assert(kThreads == joint_mma::kMmaThreads, "one block shape");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename W>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<W>(v));
}

// dlogits of one row and column from its logit x (bias added), in the
// order of the JAX kernels: (cb + cy) * (-p), then + cb, then + cy.
__device__ __forceinline__ float dlogit(float x, int v, int blank, int lab,
                                        float base, float cb, float cy) {
  float d = (cb + cy) * (-expf(x - base));
  if (v == blank) d += cb;
  if (v == lab) d += cy;
  return d;
}

// ------------------------------- forward ---------------------------------

constexpr int kBM = 64;   // rows per block (CUDA-core forward)
constexpr int kBN = 128;  // V columns per chunk
constexpr int kBK = 32;   // rows of W staged per step

template <typename W>
__host__ __device__ constexpr int zs_stride() {
  return kBM + 16 / (int)sizeof(W);
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

// The online log-sum-exp epilogue of one chunk of logits x[i][c] (rows
// ty*4 + i, columns v0 + tx*8 + c) of the CUDA-core forward.
__device__ __forceinline__ void lse_chunk(float (&x)[4][8], int v0, int tx,
                                          int ty, int V, int blank,
                                          const int* lab_s, float* sel_b,
                                          float* sel_y, float (&m_run)[4],
                                          float (&s_run)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float mloc = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int v = v0 + tx * 8 + c;
      if (v >= V) x[i][c] = -CUDART_INF_F;
      mloc = fmaxf(mloc, x[i][c]);
      if (v < V && v == blank) sel_b[r] = x[i][c];
      if (v < V && v == lab_s[r]) sel_y[r] = x[i][c];
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) {
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
    }
    const float m_new = fmaxf(m_run[i], mloc);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) sum += expf(x[i][c] - m_new);
#pragma unroll
    for (int off = 8; off > 0; off /= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    s_run[i] = s_run[i] * expf(m_run[i] - m_new) + sum;
    m_run[i] = m_new;
  }
}

__device__ __forceinline__ void write_lp(int tx, int ty, long long r0,
                                         long long N, const float* sel_b,
                                         const float* sel_y,
                                         const float (&m_run)[4],
                                         const float (&s_run)[4],
                                         float* lp_blank, float* lp_y,
                                         float* base_out) {
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const long long row = r0 + r;
    if (row >= N) continue;
    const float bse = m_run[i] + logf(s_run[i]);
    base_out[row] = bse;
    lp_blank[row] = sel_b[r] - bse;
    lp_y[row] = sel_y[r] - bse;
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
band_fwd_kernel(const float* __restrict__ f, const float* __restrict__ gw,
                const int* __restrict__ lab_w, const W* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ lp_blank,
                float* __restrict__ lp_y, float* __restrict__ base_out,
                long long N, int S, int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ZS = zs_stride<W>();
  W* zs = reinterpret_cast<W*>(smem_raw);                   // [J][ZS]
  W* ws = zs + (size_t)J * ZS;                               // [kBK][kBN]
  float* sel_b = reinterpret_cast<float*>(ws + kBK * kBN);  // [kBM]
  float* sel_y = sel_b + kBM;                                // [kBM]
  int* lab_s = reinterpret_cast<int*>(sel_y + kBM);         // [kBM]

  const long long r0 = (long long)blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*8 .. tx*8+7 of a chunk
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3

  // z of the block's rows: each warp reads 32 consecutive k of one row.
  const int j_pad = (J + 31) / 32 * 32;
  for (int idx = tid; idx < kBM * j_pad; idx += kThreads) {
    const int k = (idx % 32) + 32 * (idx / (32 * kBM));
    const int r = (idx / 32) % kBM;
    if (k >= J) continue;
    const long long row = r0 + r;
    float v = 0.0f;
    if (row < N) {
      v = tanhf(f[(row / S) * J + k] + gw[row * J + k]);
    }
    zs[(size_t)k * ZS + r] = from_float<W>(v);
  }
  for (int r = tid; r < kBM; r += kThreads) {
    lab_s[r] = (r0 + r < N) ? lab_w[r0 + r] : -1;
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
    float x[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int v = v0 + tx * 8 + c;
        x[i][c] = (v < V) ? acc[i][c] + bias[v] : 0.0f;
      }
    }
    lse_chunk(x, v0, tx, ty, V, blank, lab_s, sel_b, sel_y, m_run, s_run);
  }
  __syncthreads();
  write_lp(tx, ty, r0, N, sel_b, sel_y, m_run, s_run, lp_blank, lp_y,
           base_out);
}

// ------------------------- backward A: dg_w, df ---------------------------

// CUDA-core form: kRA rows per block, V in chunks of kCA columns; z, dz
// and W[:, chunk] in shared memory as f32 (z and W rounded to W's type).
constexpr int kRA = 16;
constexpr int kCA = 32;
constexpr int kWAP = kCA + 1;  // padded row of the staged W chunk

size_t smem_a(int J) {
  return ((size_t)2 * kRA * J + (size_t)J * kWAP + kRA * kCA + 3 * kRA)
             * sizeof(float)
         + (size_t)2 * kRA * sizeof(int);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
band_bwd_a_kernel(const float* __restrict__ f, const float* __restrict__ gw,
                  const int* __restrict__ lab_w, const W* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ base, const float* __restrict__ cb,
                  const float* __restrict__ cy, float* __restrict__ dgw,
                  long long N, int S, int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zf = reinterpret_cast<float*>(smem_raw);  // [kRA][J] round(z)
  float* dz = zf + (size_t)kRA * J;                // [kRA][J]
  float* wsf = dz + (size_t)kRA * J;               // [J][kWAP]
  float* dl = wsf + (size_t)J * kWAP;              // [kRA][kCA]
  float* base_s = dl + kRA * kCA;
  float* cb_s = base_s + kRA;
  float* cy_s = cb_s + kRA;
  int* lab_s = reinterpret_cast<int*>(cy_s + kRA);
  int* ok_s = lab_s + kRA;

  const long long r0 = (long long)blockIdx.x * kRA;
  const int tid = threadIdx.x;
  for (int r = tid; r < kRA; r += kThreads) {
    const long long row = r0 + r;
    const bool ok = row < N;
    ok_s[r] = ok;
    lab_s[r] = ok ? lab_w[row] : -1;
    base_s[r] = ok ? base[row] : 0.0f;
    cb_s[r] = ok ? cb[row] : 0.0f;
    cy_s[r] = ok ? cy[row] : 0.0f;
  }
  for (int idx = tid; idx < kRA * J; idx += kThreads) {
    const int r = idx / J;
    const int k = idx - r * J;
    const long long row = r0 + r;
    float z = 0.0f;
    if (row < N) z = round_to<W>(tanhf(f[(row / S) * J + k] + gw[row * J + k]));
    zf[idx] = z;
    dz[idx] = 0.0f;
  }
  for (int v0 = 0; v0 < V; v0 += kCA) {
    __syncthreads();  // the last chunk is done with wsf and dl
    for (int idx = tid; idx < J * kCA; idx += kThreads) {
      const int k = idx / kCA;
      const int c = idx - k * kCA;
      wsf[k * kWAP + c] = (v0 + c < V) ? to_float(w[(size_t)k * V + v0 + c]) : 0.0f;
    }
    __syncthreads();
    for (int idx = tid; idx < kRA * kCA; idx += kThreads) {
      const int r = idx / kCA;
      const int c = idx - r * kCA;
      const int v = v0 + c;
      float d = 0.0f;
      if (ok_s[r] && v < V) {
        float acc = 0.0f;
        for (int k = 0; k < J; ++k) acc = fmaf(zf[r * J + k], wsf[k * kWAP + c], acc);
        d = dlogit(acc + bias[v], v, blank, lab_s[r], base_s[r], cb_s[r],
                   cy_s[r]);
      }
      dl[idx] = round_to<W>(d);
    }
    __syncthreads();
    const int cmax = min(kCA, V - v0);
    for (int idx = tid; idx < kRA * J; idx += kThreads) {
      const int r = idx / J;
      const int k = idx - r * J;
      float acc = 0.0f;
      for (int c = 0; c < cmax; ++c) acc = fmaf(dl[r * kCA + c], wsf[k * kWAP + c], acc);
      dz[idx] += acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kRA * J; idx += kThreads) {
    const int r = idx / J;
    const int k = idx - r * J;
    const long long row = r0 + r;
    if (row >= N) continue;
    const float z = tanhf(f[(row / S) * J + k] + gw[row * J + k]);
    dgw[row * J + k] = dz[idx] * (1.0f - z * z);
  }
}

// ------------------------- backward B: dW, db ----------------------------

constexpr int kBMB = 64;  // rows per chunk
constexpr int kBNB = 32;  // V columns per block
constexpr int kKPerThread = kMaxJ / 32;

template <typename W>
__host__ __device__ constexpr int padded(int n) {
  return n + 4 / (int)sizeof(W);
}

template <typename W>
size_t smem_b(int J) {
  return (size_t)J * kBNB * sizeof(W) + (size_t)kBMB * padded<W>(J) * sizeof(W)
         + ((size_t)kBMB * kBNB + 7 * kBMB) * sizeof(float);
}

// The row bookkeeping of a chunk of kernel B: label, base, cotangents, f
// row and g_w row (-1 past the split).
__device__ __forceinline__ void load_rows_b(long long c0, int rows, int S,
                                            const int* lab_w,
                                            const float* base,
                                            const float* cb, const float* cy,
                                            int* lab_s, float* base_s,
                                            float* cb_s, float* cy_s,
                                            int* fo_s, int* go_s) {
  for (int r = threadIdx.x; r < kBMB; r += kThreads) {
    if (r < rows) {
      const long long row = c0 + r;
      lab_s[r] = lab_w[row];
      base_s[r] = base[row];
      cb_s[r] = cb[row];
      cy_s[r] = cy[row];
      fo_s[r] = (int)(row / S);
      go_s[r] = (int)row;
    } else {
      lab_s[r] = fo_s[r] = go_s[r] = -1;
      base_s[r] = cb_s[r] = cy_s[r] = 0.0f;
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
band_bwd_b_kernel(const float* __restrict__ f, const float* __restrict__ gw,
                  const int* __restrict__ lab_w, const W* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ base, const float* __restrict__ cb,
                  const float* __restrict__ cy, float* __restrict__ dw_part,
                  float* __restrict__ db_part, long long N, int S, int J,
                  int V, int blank, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ZR = padded<W>(J);
  W* wsb = reinterpret_cast<W*>(smem_raw);                          // [J][kBNB]
  W* zr = wsb + (size_t)J * kBNB;                                   // [kBMB][ZR]
  float* dl_s = reinterpret_cast<float*>(zr + (size_t)kBMB * ZR);  // [kBMB][kBNB]
  float* base_s = dl_s + kBMB * kBNB;
  float* cb_s = base_s + kBMB;
  float* cy_s = cb_s + kBMB;
  int* lab_s = reinterpret_cast<int*>(cy_s + kBMB);
  int* fo_s = lab_s + kBMB;
  int* go_s = fo_s + kBMB;

  const int v0 = blockIdx.x * kBNB;
  const int split = blockIdx.y;
  const long long per = (N + n_split - 1) / n_split;
  const long long r_begin = split * per;
  const long long r_end = min(N, r_begin + per);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 8;  // logits rows 2ty, 2ty+1
  const int tx = tid % 8;  // logits columns tx*4 .. tx*4+3

  for (int idx = tid; idx < J * kBNB; idx += kThreads) {
    const int k = idx / kBNB;
    const int n = idx - k * kBNB;
    wsb[idx] = (v0 + n < V) ? w[(size_t)k * V + v0 + n] : from_float<W>(0.0f);
  }
  float acc3[kKPerThread][4];  // dW[lane + 32i, v0 + 4 warp + c]
#pragma unroll
  for (int i = 0; i < kKPerThread; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc3[i][c] = 0.0f;
  }
  float db_acc = 0.0f;

  for (long long c0 = r_begin; c0 < r_end; c0 += kBMB) {
    const int rows = (int)min((long long)kBMB, r_end - c0);
    __syncthreads();  // the previous chunk is consumed
    load_rows_b(c0, rows, S, lab_w, base, cb, cy, lab_s, base_s, cb_s, cy_s,
                fo_s, go_s);
    __syncthreads();
    for (int r = warp; r < kBMB; r += kThreads / 32) {
      const int fo = fo_s[r];
      const int go = go_s[r];
      for (int k = lane; k < J; k += 32) {
        float z = 0.0f;
        if (fo >= 0) z = tanhf(f[(size_t)fo * J + k] + gw[(size_t)go * J + k]);
        zr[(size_t)r * ZR + k] = from_float<W>(z);
      }
    }
    __syncthreads();
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    }
    for (int k = 0; k < J; ++k) {
      const float z0 = to_float(zr[(size_t)(2 * ty) * ZR + k]);
      const float z1 = to_float(zr[(size_t)(2 * ty + 1) * ZR + k]);
      const W* wr = wsb + (size_t)k * kBNB + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float wv = to_float(wr[c]);
        acc[0][c] = fmaf(z0, wv, acc[0][c]);
        acc[1][c] = fmaf(z1, wv, acc[1][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = v0 + tx * 4 + c;
        float d = 0.0f;
        if (r < rows && v < V) {
          d = dlogit(acc[i][c] + bias[v], v, blank, lab_s[r], base_s[r],
                     cb_s[r], cy_s[r]);
        }
        dl_s[r * kBNB + tx * 4 + c] = d;
      }
    }
    __syncthreads();
    if (tid < kBNB) {
      for (int r = 0; r < rows; ++r) db_acc += dl_s[r * kBNB + tid];
    }
    // dW[:, tile] += round(z)^T . round(dlogits)
    for (int r = 0; r < rows; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(dl_s + r * kBNB + warp * 4);
      const float d[4] = {round_to<W>(d4.x), round_to<W>(d4.y),
                          round_to<W>(d4.z), round_to<W>(d4.w)};
      const W* zrow = zr + (size_t)r * ZR;
#pragma unroll
      for (int i = 0; i < kKPerThread; ++i) {
        const int k = lane + 32 * i;
        const float z = (k < J) ? to_float(zrow[k]) : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc3[i][c] = fmaf(z, d[c], acc3[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kKPerThread; ++i) {
    const int k = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = v0 + warp * 4 + c;
      if (k < J && v < V) dw_part[((size_t)split * J + k) * V + v] = acc3[i][c];
    }
  }
  if (tid < kBNB && v0 + tid < V) db_part[(size_t)split * V + v0 + tid] = db_acc;
}

// Tensor-core form of kernel B, in two launches, on the ring of
// zb_ring.cuh (shared with the fused joint's kernel B, joint_bwd.cu):
// band_bwd_b_zb_kernel writes zb = round(z), row r's z from f[r / S] and
// g_w[r]; band_bwd_b_ring_kernel runs the ring with the band's row policy.

// Row r of the band: z from f row r / S and g_w row r.
struct BandMap {
  int S;
  __device__ long long f_row(long long r) const { return r / S; }
  __device__ long long g_row(long long r) const { return r; }
};

// The band's sidecars: lab_w, base, cb, cy; dlogits as `dlogit` above.
struct BandRows {
  const int* __restrict__ lab_w;
  const float* __restrict__ base;
  const float* __restrict__ cb;
  const float* __restrict__ cy;
  __device__ void load(long long row, float (&s)[zb_ring::kSideWords]) const {
    s[0] = __int_as_float(lab_w[row]);
    s[1] = base[row];
    s[2] = cb[row];
    s[3] = cy[row];
    s[4] = 0.0f;
  }
  __device__ float dlogit(const float (&s)[zb_ring::kSideWords], float x,
                          int v, int blank) const {
    return ::dlogit(x, v, blank, __float_as_int(s[0]), s[1], s[2], s[3]);
  }
};

__global__ void __launch_bounds__(kThreads)
band_bwd_b_zb_kernel(const float* __restrict__ f,
                     const float* __restrict__ gw, bf16* __restrict__ zb,
                     long long N, long long n_rows, int S, int J, int JP) {
  zb_ring::build_zb(f, gw, zb, N, n_rows, J, JP, BandMap{S});
}

__global__ void __launch_bounds__(kThreads, 1)
band_bwd_b_ring_kernel(const bf16* __restrict__ zb,
                       const int* __restrict__ lab_w,
                       const bf16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ base,
                       const float* __restrict__ cb,
                       const float* __restrict__ cy,
                       float* __restrict__ dw_out, float* __restrict__ db_out,
                       long long N, int J, int V, int blank,
                       long long split_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  zb_ring::ring_body(smem_raw, zb, BandRows{lab_w, base, cb, cy}, w, bias,
                     dw_out, db_out, N, J, V, blank, split_rows);
}

// Tensor-core form of kernel A, in two launches, on wt_ring.cuh:
// band_bwd_a_wt_kernel writes wt = W^T once a call; band_bwd_a_ring_kernel
// runs the ring with the band's rows, whose epilogue writes
// dg_w = dz (1 - z^2), z recomputed in f32 from f and g_w.

// Kernel A's rows of the band: BandRows' sidecars and dlogit, z from f
// row r / S and g_w row r, and dg_w's epilogue.
struct BandRowsA : BandRows {
  const float* __restrict__ f;
  const float* __restrict__ gw;
  float* __restrict__ dgw;
  int S;
  int J;
  __device__ long long f_row(long long r) const { return r / S; }
  __device__ long long g_row(long long r) const { return r; }
  // dz[n][e] at column j0 + 8 n + e; every load before the first store
  __device__ void store_dz(long long row, int j0,
                           const float (&dz)[8][2]) const {
    const float* fr = f + f_row(row) * J + j0;
    const float* gr = gw + row * J + j0;
    float2 x[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (j0 + 8 * n < J) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(fr + 8 * n));
        const float2 b = __ldg(reinterpret_cast<const float2*>(gr + 8 * n));
        x[n] = make_float2(a.x + b.x, a.y + b.y);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (j0 + 8 * n < J) {
        const float z0 = tanhf(x[n].x);
        const float z1 = tanhf(x[n].y);
        *reinterpret_cast<float2*>(dgw + row * J + j0 + 8 * n) = make_float2(
            dz[n][0] * (1.0f - z0 * z0), dz[n][1] * (1.0f - z1 * z1));
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
band_bwd_a_wt_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt,
                     int J, int V, int JP) {
  wt_ring::build_wt(w, wt, J, V, JP);
}

__global__ void __launch_bounds__(kThreads, 1)
band_bwd_a_ring_kernel(const float* __restrict__ f,
                       const float* __restrict__ gw,
                       const int* __restrict__ lab_w,
                       const bf16* __restrict__ wt,
                       const float* __restrict__ bias,
                       const float* __restrict__ base,
                       const float* __restrict__ cb,
                       const float* __restrict__ cy, float* __restrict__ dgw,
                       long long N, int S, int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BandRowsA rows{{lab_w, base, cb, cy}, f, gw, dgw, S, J};
  wt_ring::ring_body(smem_raw, f, gw, rows, wt, bias, N, J, V, blank);
}

// Tensor-core form of the forward, in two launches, on wt_ring.cuh:
// band_fwd_wt_kernel writes wt = W^T once a call (kernel A's array, its
// own launch, so that the profiler counts it with the forward);
// band_fwd_ring_kernel runs the forward's ring with the band's rows.

// The forward's rows of the band: z from f row r / S and g_w row r, the
// label lab_w[r]; lp_blank, lp_y and base at row r.
struct BandRowsF {
  const int* __restrict__ lab_w;
  float* __restrict__ lp_blank;
  float* __restrict__ lp_y;
  float* __restrict__ base;
  int S;
  __device__ long long f_row(long long r) const { return r / S; }
  __device__ long long g_row(long long r) const { return r; }
  __device__ int label(long long r) const { return lab_w[r]; }
  __device__ void store(long long row, float lpb, float lpy,
                        float bse) const {
    lp_blank[row] = lpb;
    lp_y[row] = lpy;
    base[row] = bse;
  }
};

__global__ void __launch_bounds__(kThreads)
band_fwd_wt_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt, int J,
                   int V, int JP) {
  wt_ring::build_wt(w, wt, J, V, JP);
}

__global__ void __launch_bounds__(kThreads, 1)
band_fwd_ring_kernel(const float* __restrict__ f,
                     const float* __restrict__ gw,
                     const int* __restrict__ lab_w,
                     const bf16* __restrict__ wt,
                     const float* __restrict__ bias,
                     float* __restrict__ lp_blank, float* __restrict__ lp_y,
                     float* __restrict__ base, long long N, int S, int J,
                     int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BandRowsF rows{lab_w, lp_blank, lp_y, base, S};
  wt_ring::fwd_body(smem_raw, f, gw, rows, wt, bias, N, J, V, blank);
}

// out[o, x] = sum_p part[o, p, x], p in order.
__global__ void band_sum_parts_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, long long n_outer,
                                      int n_parts, long long X) {
  const long long n = n_outer * X;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long o = idx / X;
    const long long x = idx - o * X;
    float acc = 0.0f;
    for (int p = 0; p < n_parts; ++p) acc += part[(o * n_parts + p) * X + x];
    out[idx] = acc;
  }
}

int sum_parts(const float* part, float* out, long long n_outer, int n_parts,
              long long X, cudaStream_t stream) {
  const long long n = n_outer * X;
  const int blocks = (int)std::min((n + kThreads - 1) / kThreads, 4096LL);
  band_sum_parts_kernel<<<blocks, kThreads, 0, stream>>>(part, out, n_outer,
                                                         n_parts, X);
  return (int)cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The CUDA-core forward (f32 W, or shapes outside the tensor-core form).
template <typename W>
int run_fwd(const float* f, const float* gw, const int* lab_w, const W* w,
            const float* bias, float* lp_blank, float* lp_y, float* base,
            long long N, int S, int J, int V, int blank, cudaStream_t stream) {
  const size_t smem = (size_t)J * zs_stride<W>() * sizeof(W)
                      + (size_t)kBK * kBN * sizeof(W) + 3 * kBM * sizeof(float);
  const dim3 grid((unsigned)((N + kBM - 1) / kBM));
  const cudaError_t e = set_smem(band_fwd_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  band_fwd_kernel<W><<<grid, kThreads, smem, stream>>>(
      f, gw, lab_w, w, bias, lp_blank, lp_y, base, N, S, J, V, blank);
  return (int)cudaGetLastError();
}

// The CUDA-core form of kernel A (f32 W, or shapes outside the
// tensor-core form), then df[b, t] = sum over the frame's S rows of dg_w, in
// s order.
template <typename W>
int run_bwd_a(const float* f, const float* gw, const int* lab_w, const W* w,
              const float* bias, const float* base, const float* cb,
              const float* cy, float* df, float* dgw, int B, int T,
              long long N, int S, int J, int V, int blank,
              cudaStream_t stream) {
  const size_t smem = smem_a(J);
  const dim3 grid((unsigned)((N + kRA - 1) / kRA));
  const cudaError_t e = set_smem(band_bwd_a_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  band_bwd_a_kernel<W><<<grid, kThreads, smem, stream>>>(
      f, gw, lab_w, w, bias, base, cb, cy, dgw, N, S, J, V, blank);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  return sum_parts(dgw, df, (long long)B * T, S, J, stream);
}

// The CUDA-core form of kernel B (f32 W, or shapes outside the
// tensor-core form): grid (V / kBNB column tiles, n_split row splits).
template <typename W>
int run_bwd_b(const float* f, const float* gw, const int* lab_w, const W* w,
              const float* bias, const float* base, const float* cb,
              const float* cy, float* dw, float* db, float* dw_part,
              float* db_part, long long N, int S, int J, int V, int blank,
              int n_split, cudaStream_t stream) {
  const dim3 grid((V + kBNB - 1) / kBNB, n_split);
  const size_t smem = smem_b<W>(J);
  const cudaError_t e = set_smem(band_bwd_b_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  band_bwd_b_kernel<W><<<grid, kThreads, smem, stream>>>(
      f, gw, lab_w, w, bias, base, cb, cy, dw_part, db_part, N, S, J, V,
      blank, n_split);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  const int err = sum_parts(dw_part, dw, 1, n_split, (long long)J * V, stream);
  if (err) return err;
  return sum_parts(db_part, db, 1, n_split, V, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns 0, or the first
// cudaError_t a launch reported. J <= 512; W is bf16 (w_is_bf16) or f32.

// The CUDA-core forward, one launch: lp_blank, lp_y and base, each
// (B, T, S) f32. W in bf16 or f32, any J <= 512 and V;
// ops/rnnt_band_fused.py sends bf16 W with J % 16 == 0 and V even to the
// tensor-core form (band_fwd_wt, band_fwd_ring) instead.
extern "C" int band_fwd(const void* f, const void* gw, const void* lab_w,
                        const void* w, int w_is_bf16, const void* bias,
                        void* lp_blank, void* lp_y, void* base, int B, int T,
                        int S, int J, int V, int blank, int device,
                        void* stream) {
  if (J > kMaxJ) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_ = static_cast<const float*>(f);
  const float* gw_ = static_cast<const float*>(gw);
  const int* lab_ = static_cast<const int*>(lab_w);
  const float* bias_ = static_cast<const float*>(bias);
  float* lpb = static_cast<float*>(lp_blank);
  float* lpy = static_cast<float*>(lp_y);
  float* bse = static_cast<float*>(base);
  if (w_is_bf16) {
    return run_fwd<bf16>(f_, gw_, lab_, static_cast<const bf16*>(w), bias_, lpb,
                         lpy, bse, N, S, J, V, blank, s);
  }
  return run_fwd<float>(f_, gw_, lab_, static_cast<const float*>(w), bias_, lpb,
                        lpy, bse, N, S, J, V, blank, s);
}

// The CUDA-core form of kernel A, two launches: dg_w (B, T, S, J) and the
// ordered sum df (B, T, J). W in bf16 or f32, any J <= 512 and V;
// ops/rnnt_band_fused.py sends bf16 W with J % 16 == 0 and V even to the
// tensor-core form below instead.
extern "C" int band_bwd_a(const void* f, const void* gw, const void* lab_w,
                          const void* w, int w_is_bf16, const void* bias,
                          const void* base, const void* cb, const void* cy,
                          void* df, void* dgw, int B, int T, int S, int J,
                          int V, int blank, int device, void* stream) {
  if (J > kMaxJ) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_ = static_cast<const float*>(f);
  const float* gw_ = static_cast<const float*>(gw);
  const int* lab_ = static_cast<const int*>(lab_w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* base_ = static_cast<const float*>(base);
  const float* cb_ = static_cast<const float*>(cb);
  const float* cy_ = static_cast<const float*>(cy);
  float* df_ = static_cast<float*>(df);
  float* dgw_ = static_cast<float*>(dgw);
  if (w_is_bf16) {
    return run_bwd_a<bf16>(f_, gw_, lab_, static_cast<const bf16*>(w), bias_,
                           base_, cb_, cy_, df_, dgw_, B, T, N, S, J, V, blank,
                           s);
  }
  return run_bwd_a<float>(f_, gw_, lab_, static_cast<const float*>(w), bias_,
                          base_, cb_, cy_, df_, dgw_, B, T, N, S, J, V, blank,
                          s);
}

// The CUDA-core form of kernel B, three launches: the kernel into n_split
// partials (dw_part (n_split, J, V), db_part (n_split, V)), then their
// ordered sums into dw (J, V), db (V). W in bf16 or f32, any J <= 512 and
// V; ops/rnnt_band_fused.py sends bf16 W with J % 16 == 0 and V even to
// the tensor-core form below instead.
extern "C" int band_bwd_b(const void* f, const void* gw, const void* lab_w,
                          const void* w, int w_is_bf16, const void* bias,
                          const void* base, const void* cb, const void* cy,
                          void* dw, void* db, void* dw_part, void* db_part,
                          int B, int T, int S, int J, int V, int blank,
                          int n_split, int device, void* stream) {
  if (J > kMaxJ || n_split < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_ = static_cast<const float*>(f);
  const float* gw_ = static_cast<const float*>(gw);
  const int* lab_ = static_cast<const int*>(lab_w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* base_ = static_cast<const float*>(base);
  const float* cb_ = static_cast<const float*>(cb);
  const float* cy_ = static_cast<const float*>(cy);
  float* dw_ = static_cast<float*>(dw);
  float* db_ = static_cast<float*>(db);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
  if (w_is_bf16) {
    return run_bwd_b<bf16>(f_, gw_, lab_, static_cast<const bf16*>(w), bias_,
                           base_, cb_, cy_, dw_, db_, dwp, dbp, N, S, J, V,
                           blank, n_split, s);
  }
  return run_bwd_b<float>(f_, gw_, lab_, static_cast<const float*>(w), bias_,
                          base_, cb_, cy_, dw_, db_, dwp, dbp, N, S, J, V,
                          blank, n_split, s);
}

// The tensor-core form of kernel B (W bf16, J % 16 == 0, V even), as two
// entry points so that a caller can time them apart.
//
// One launch: zb (ceil(N / 64) * 64, pitch_j(J)) bf16 = round(z), zero
// past N rows and J columns.
extern "C" int band_bwd_b_zb(const void* f, const void* gw, void* zb, int B,
                             int T, int S, int J, int device, void* stream) {
  if (J > kMaxJ || J % 16 != 0 || J < 16) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * S;
  const long long n_rows = (N + kMR - 1) / kMR * kMR;
  const int JP = pitch_j(J);
  const long long n = n_rows * (JP / zb_ring::kZbVec);
  const int blocks = (int)std::min((n + kThreads - 1) / kThreads, 8192LL);
  band_bwd_b_zb_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(gw),
      static_cast<bf16*>(zb), N, n_rows, S, J, JP);
  return (int)cudaGetLastError();
}

// The main launch on the plan of ops/rnnt_band_fused.bwd_b_plan: grid
// (grid_x, n_split), split y owning rows y * split_rows .. (a multiple of
// 64, every split non-empty), smem_bytes the block's shared memory
// (zb_ring::ring_bytes(J)). With n_split == 1 it writes dw (J, V) and db
// (V) itself; otherwise it writes the partials dw_part (n_split, J, V) and
// db_part (n_split, V), and two more launches sum them in split order.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int band_bwd_b_ring(const void* zb, const void* lab_w,
                               const void* w, const void* bias,
                               const void* base, const void* cb,
                               const void* cy, void* dw, void* db,
                               void* dw_part, void* db_part, int B, int T,
                               int S, int J, int V, int blank, int grid_x,
                               int n_split, long long split_rows,
                               long long smem_bytes, int device,
                               void* stream) {
  const long long N = (long long)B * T * S;
  if (!zb_ring::plan_ok(N, J, V, grid_x, n_split, split_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = zb_ring::ring_bytes(J);
  const cudaError_t e1 = set_smem(band_bwd_b_ring_kernel, smem);
  if (e1 != cudaSuccess) return (int)e1;
  const bool direct = n_split == 1;
  float* dwo = static_cast<float*>(direct ? dw : dw_part);
  float* dbo = static_cast<float*>(direct ? db : db_part);
  band_bwd_b_ring_kernel<<<dim3(grid_x, n_split), kThreads, smem, s>>>(
      static_cast<const bf16*>(zb), static_cast<const int*>(lab_w),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(base), static_cast<const float*>(cb),
      static_cast<const float*>(cy), dwo, dbo, N, J, V, blank, split_rows);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || direct) return (int)e2;
  const int err = sum_parts(static_cast<const float*>(dw_part),
                            static_cast<float*>(dw), 1, n_split,
                            (long long)J * V, s);
  if (err) return err;
  return sum_parts(static_cast<const float*>(db_part),
                   static_cast<float*>(db), 1, n_split, V, s);
}

// The tensor-core form of kernel A (W bf16, J % 16 == 0, V even), as two
// entry points so that a caller can time them apart. Both take the layout
// of ops/rnnt_band_fused.bwd_a_layout (wt's rows; the ring block's shared
// bytes) and return cudaErrorInvalidValue for one that is not the
// kernel's.
//
// One launch: wt (wt_rows, pitch_j(J)) bf16 = W^T, wt_rows = V rounded up
// to 64, zero past V rows and J columns.
extern "C" int band_bwd_a_wt(const void* w, void* wt, int J, int V,
                             long long wt_rows, int device, void* stream) {
  return wt_ring::launch_wt(band_bwd_a_wt_kernel,
                            static_cast<const bf16*>(w),
                            static_cast<bf16*>(wt), J, V, wt_rows, device,
                            static_cast<cudaStream_t>(stream));
}

// Two launches: the ring kernel, one block a chunk of 64 rows with
// smem_bytes (wt_ring::ring_bytes(J)) of shared memory, writes dg_w
// (B, T, S, J) from wt; then the ordered sum df (B, T, J).
extern "C" int band_bwd_a_ring(const void* f, const void* gw,
                               const void* lab_w, const void* wt,
                               const void* bias, const void* base,
                               const void* cb, const void* cy, void* df,
                               void* dgw, int B, int T, int S, int J, int V,
                               int blank, long long wt_rows,
                               long long smem_bytes, int device,
                               void* stream) {
  const long long N = (long long)B * T * S;
  if (N < 1 || !wt_ring::layout_ok(J, V, wt_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = wt_ring::ring_bytes(J);
  const cudaError_t e1 = set_smem(band_bwd_a_ring_kernel, smem);
  if (e1 != cudaSuccess) return (int)e1;
  band_bwd_a_ring_kernel<<<(unsigned)((N + kMR - 1) / kMR), kThreads, smem,
                           s>>>(
      static_cast<const float*>(f), static_cast<const float*>(gw),
      static_cast<const int*>(lab_w), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(base),
      static_cast<const float*>(cb), static_cast<const float*>(cy),
      static_cast<float*>(dgw), N, S, J, V, blank);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  return sum_parts(static_cast<const float*>(dgw), static_cast<float*>(df),
                   (long long)B * T, S, J, s);
}

// The tensor-core form of the forward (W bf16, J % 16 == 0, V even), as
// two entry points so that a caller can time them apart. Both take the
// layout of ops/rnnt_band_fused.fwd_layout (wt's rows; the ring block's
// shared bytes) and return cudaErrorInvalidValue, launching nothing, for
// one that is not the kernel's.
//
// One launch: wt (wt_rows, pitch_j(J)) bf16 = W^T, wt_rows = V rounded up
// to 64, zero past V rows and J columns.
extern "C" int band_fwd_wt(const void* w, void* wt, int J, int V,
                           long long wt_rows, long long smem_bytes,
                           int device, void* stream) {
  if (!wt_ring::fwd_layout_ok(J, V, wt_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  return wt_ring::launch_wt(band_fwd_wt_kernel, static_cast<const bf16*>(w),
                            static_cast<bf16*>(wt), J, V, wt_rows, device,
                            static_cast<cudaStream_t>(stream));
}

// One launch: the ring kernel, one block a chunk of 64 rows with
// smem_bytes (wt_ring::fwd_ring_bytes(J)) of shared memory, writes
// lp_blank, lp_y and base, each (B, T, S) f32, from wt.
extern "C" int band_fwd_ring(const void* f, const void* gw,
                             const void* lab_w, const void* wt,
                             const void* bias, void* lp_blank, void* lp_y,
                             void* base, int B, int T, int S, int J, int V,
                             int blank, long long wt_rows,
                             long long smem_bytes, int device,
                             void* stream) {
  const long long N = (long long)B * T * S;
  if (N < 1 || !wt_ring::fwd_layout_ok(J, V, wt_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = wt_ring::fwd_ring_bytes(J);
  const cudaError_t e1 = set_smem(band_fwd_ring_kernel, smem);
  if (e1 != cudaSuccess) return (int)e1;
  band_fwd_ring_kernel<<<(unsigned)((N + kMR - 1) / kMR), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(gw),
      static_cast<const int*>(lab_w), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(lp_blank),
      static_cast<float*>(lp_y), static_cast<float*>(base), N, S, J, V,
      blank);
  return (int)cudaGetLastError();
}
