// Fused joint network + RNN-T loss, backward, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/rnnt_joint_fused.py `joint_lp_bwd`
// (kernels `_bwd_kernel` and `_bwd_kernel_vc`) and `_joint_lp_bwd_pipe`
// (kernel `_bwd_kernel_pipe`, the default). The three TPU schedules give
// bitwise-equal gradients, so one kernel family answers for all of them.
//
// Computes, from the occupancies of the lattice (gb blank, gy emit, gy
// already scaled by 1 + lambda under FastEmit), the forward's log-sum-exp
// `base` and the per-utterance loss cotangent s = gbar[b], for every cell:
//   z        = tanh(f[b, t] + g[b, u])
//   logits   = round(z) . W + bias                 (recomputed, fp32 acc.)
//   dlogits  = s (gb + gy) exp(logits - base) - s gb [v = blank]
//                                              - s gy [v = label[u]]
//   dz       = round(dlogits) . W^T * (1 - z^2)
// and the sums df[b, t] = sum_u dz, dg[b, u] = sum_t dz,
// dW = sum_cells round(z)^T round(dlogits), db = sum_cells dlogits.
// round() is the cast to W's type (bf16 or f32), as in the JAX kernels.
//
// Layout: f (B, T, J), g (B, U+1, J), gb, gy, base (B, T, U+1), gbar (B)
// f32; labels (B, U) int32; W (J, V) bf16 or f32; bias (V) f32 ->
// df (B, T, J), dg (B, U+1, J), dW (J, V), db (V), all f32.
//
// Design, three launches on the caller's stream:
//   A  grid (frame tiles, B): df, and the tile's dg partial. dlogits never
//      leaves the chip.
//   B  grid (V tiles of kBNB columns, row splits): dW and db partials,
//      recomputing the logits of its V tile from base; W[:, tile] stays in
//      shared memory, dW[:, tile] in registers, db summed in order.
//   C  ordered sums of the partials: dg over frame tiles, dW and db over
//      row splits. No float atomics anywhere: two runs give identical bits.
// A and B each come in two forms:
//   * W in bf16 (the training path): on the tensor cores (mma_bf16.cuh).
//     A takes the cells of its frame tile flattened, kMR at a time: the
//     logits kMV columns at a time, round(dlogits) for all of V in shared
//     memory, then dz = round(dlogits) . W^T in passes of 256 columns with
//     W's B fragments read straight from L2, dz *= 1 - z^2, and an ordered
//     per-column walk over the rows into df and dg. B keeps round(z) both
//     row-major (for the logits) and transposed (for dW). Needs J % 16 ==
//     0, V even and the tiles in shared memory (227 KB for A at libri100).
//   * W in f32 (the parity runs), or other shapes: CUDA-core FMAs. A walks
//     each frame's label positions in row blocks of up to kBM, for each V
//     chunk of kBN columns staging W[:, chunk], rebuilding z kBK columns
//     at a time and adding dlogits . W^T into a (kBM, J) dz tile in shared
//     memory; B builds z per chunk of kBMB cells.
//
// Partial memory (the wrapper allocates it): B * ceil(T / frames_per_tile)
// * (U+1) * J floats for dg and row_splits * (J * V + V) floats for dW and
// db: 67 MB and 33.6 MB at libri100 (B=32, T'=200, U+1=41, J=512, V=1024,
// 8 frames per tile, 16 splits).
//
// What bounds it on the H100: four products of 2 * cells * J * V flops
// (A and B each recompute the logits; 1.1 TFLOP at libri100, 1.1 ms at the
// bf16 dense peak), but the mma.sync kernels sit far from that: they
// rebuild z = tanh(f + g) per V tile (B) and per row chunk (A), stage W
// through shared memory with single buffering, and run one block per SM.
// The next steps are wgmma with TMA rings and z built once per cell
// (ROADMAP K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJ = 512;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use
// kernel A
constexpr int kBM = 64;   // label positions per row block
constexpr int kBN = 32;   // V columns per chunk
constexpr int kBK = 32;   // z columns built per step
constexpr int kZK = kBM + 1;  // padded row of the z chunk
constexpr int kDL = kBM + 1;  // padded row of the dlogits chunk
// kernel B
constexpr int kBMB = 64;  // cells per chunk
constexpr int kBNB = 32;  // V columns per block
constexpr int kKPerThread = kMaxJ / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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
template <typename W>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<W>(v));
}

// A row of W (or of z) padded to an odd number of 32-bit words, so that
// lanes walking down a column hit distinct banks.
template <typename W>
__host__ __device__ constexpr int padded(int n) {
  return n + 4 / (int)sizeof(W);
}

// dlogits of one cell and column, from its logit x (bias added).
__device__ __forceinline__ float dlogit(float x, int v, int blank, int lab,
                                        float base, float occ, float gb_s,
                                        float gy_s) {
  float d = expf(x - base) * occ;
  if (v == blank) d -= gb_s;
  if (v == lab) d -= gy_s;
  return d;
}

template <typename W>
size_t smem_a(int J) {
  return (size_t)J * padded<W>(kBN) * sizeof(W)
         + ((size_t)kBK * kZK + (size_t)kBN * kDL + (size_t)kBM * J + J
            + 5 * kBM) * sizeof(float);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
joint_bwd_a_kernel(const float* __restrict__ f, const float* __restrict__ g,
                   const int* __restrict__ labels, const W* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gb, const float* __restrict__ gy,
                   const float* __restrict__ base,
                   const float* __restrict__ gbar, float* __restrict__ df,
                   float* __restrict__ dg_part, int T, int U1, int J, int V,
                   int blank, int frames_per_tile, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int WS = padded<W>(kBN);
  W* ws = reinterpret_cast<W*>(smem_raw);                       // [J][WS]
  float* zk = reinterpret_cast<float*>(ws + (size_t)J * WS);     // [kBK][kZK]
  float* dl_s = zk + kBK * kZK;                                  // [kBN][kDL]
  float* dz_s = dl_s + kBN * kDL;                                // [kBM][J]
  float* df_s = dz_s + (size_t)kBM * J;                          // [J]
  float* occ_s = df_s + J;
  float* gb_s = occ_s + kBM;
  float* gy_s = gb_s + kBM;
  float* base_s = gy_s + kBM;
  int* lab_s = reinterpret_cast<int*>(base_s + kBM);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int t_begin = tile * frames_per_tile;
  const int t_end = min(T, t_begin + frames_per_tile);
  const int U = U1 - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 8;  // GEMM1 rows 2ty, 2ty+1
  const int tx = tid % 8;  // GEMM1 columns tx*4 .. tx*4+3
  const float s = gbar[b];

  for (int t = t_begin; t < t_end; ++t) {
    const float* f_t = f + ((size_t)b * T + t) * J;
    for (int u0 = 0; u0 < U1; u0 += kBM) {
      const int rows = min(kBM, U1 - u0);
      __syncthreads();  // the previous row block is done with dz_s
      for (int r = tid; r < kBM; r += kThreads) {
        if (r < rows) {
          const size_t cell = ((size_t)b * T + t) * U1 + u0 + r;
          const float gbv = gb[cell];
          const float gyv = gy[cell];
          occ_s[r] = (gbv + gyv) * s;
          gb_s[r] = gbv * s;
          gy_s[r] = gyv * s;
          base_s[r] = base[cell];
          lab_s[r] = (u0 + r < U) ? labels[(size_t)b * U + u0 + r] : -1;
        } else {
          occ_s[r] = gb_s[r] = gy_s[r] = base_s[r] = 0.0f;
          lab_s[r] = -1;
        }
      }
      for (int idx = tid; idx < kBM * J; idx += kThreads) dz_s[idx] = 0.0f;

      for (int v0 = 0; v0 < V; v0 += kBN) {
        __syncthreads();  // the previous chunk is done with ws and dl_s
        for (int idx = tid; idx < J * kBN; idx += kThreads) {
          const int k = idx / kBN;
          const int n = idx - k * kBN;
          ws[(size_t)k * WS + n] = (v0 + n < V) ? w[(size_t)k * V + v0 + n]
                                                : from_float<W>(0.0f);
        }
        // GEMM1: logits (rows, kBN) = round(z) . W[:, chunk]
        float acc[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
        }
        for (int k0 = 0; k0 < J; k0 += kBK) {
          __syncthreads();  // ws is staged; the last z chunk is consumed
          for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
            const int kk = idx % kBK;
            const int r = idx / kBK;
            const int k = k0 + kk;
            float z = 0.0f;
            if (r < rows && k < J) {
              z = round_to<W>(tanhf(
                  f_t[k] + g[((size_t)b * U1 + u0 + r) * J + k]));
            }
            zk[kk * kZK + r] = z;
          }
          __syncthreads();
          const int kmax = min(kBK, J - k0);
          for (int kk = 0; kk < kmax; ++kk) {
            const float z0 = zk[kk * kZK + 2 * ty];
            const float z1 = zk[kk * kZK + 2 * ty + 1];
            const W* wr = ws + (size_t)(k0 + kk) * WS + tx * 4;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float wv = to_float(wr[c]);
              acc[0][c] = fmaf(z0, wv, acc[0][c]);
              acc[1][c] = fmaf(z1, wv, acc[1][c]);
            }
          }
        }
        // dlogits of the chunk, rounded, into shared memory (v-major)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * ty + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int v = v0 + tx * 4 + c;
            float d = 0.0f;
            if (r < rows && v < V) {
              d = dlogit(acc[i][c] + bias[v], v, blank, lab_s[r], base_s[r],
                         occ_s[r], gb_s[r], gy_s[r]);
            }
            dl_s[(tx * 4 + c) * kDL + r] = round_to<W>(d);
          }
        }
        __syncthreads();
        // GEMM2: dz (rows, J) += round(dlogits) . W[:, chunk]^T. Warp w
        // owns rows 8w .. 8w+7; lane l owns columns kb + l + 32c.
        const int vmax = min(kBN, V - v0);
        for (int kb = 0; kb < J; kb += 128) {
          float acc2[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc2[i][c] = 0.0f;
          }
          for (int v = 0; v < vmax; ++v) {
            float d[8], wv[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) d[i] = dl_s[v * kDL + warp * 8 + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int k = kb + lane + 32 * c;
              wv[c] = (k < J) ? to_float(ws[(size_t)k * WS + v]) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc2[i][c] = fmaf(d[i], wv[c], acc2[i][c]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int k = kb + lane + 32 * c;
              if (k < J) dz_s[(size_t)(warp * 8 + i) * J + k] += acc2[i][c];
            }
          }
        }
      }
      __syncthreads();
      // dz *= 1 - z^2; df for the frame; the tile's dg partial. Thread k
      // owns column k here and in df_s, so no other thread touches them.
      for (int k = tid; k < J; k += kThreads) {
        const float fk = f_t[k];
        float colsum = 0.0f;
        for (int r = 0; r < rows; ++r) {
          const int u = u0 + r;
          const float z = tanhf(fk + g[((size_t)b * U1 + u) * J + k]);
          const float dz = dz_s[(size_t)r * J + k] * (1.0f - z * z);
          colsum += dz;
          float* p = dg_part + (((size_t)b * n_tiles + tile) * U1 + u) * J + k;
          *p = (t == t_begin) ? dz : *p + dz;
        }
        df_s[k] = (u0 == 0) ? colsum : df_s[k] + colsum;
      }
    }
    for (int k = tid; k < J; k += kThreads) {
      df[((size_t)b * T + t) * J + k] = df_s[k];
    }
  }
}

template <typename W>
size_t smem_b(int J) {
  return (size_t)J * kBNB * sizeof(W) + (size_t)kBMB * padded<W>(J) * sizeof(W)
         + ((size_t)kBMB * kBNB + 7 * kBMB) * sizeof(float);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
joint_bwd_b_kernel(const float* __restrict__ f, const float* __restrict__ g,
                   const int* __restrict__ labels, const W* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gb, const float* __restrict__ gy,
                   const float* __restrict__ base,
                   const float* __restrict__ gbar,
                   float* __restrict__ dw_part, float* __restrict__ db_part,
                   int B, int T, int U1, int J, int V, int blank,
                   int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ZR = padded<W>(J);
  W* wsb = reinterpret_cast<W*>(smem_raw);                       // [J][kBNB]
  W* zr = wsb + (size_t)J * kBNB;                                // [kBMB][ZR]
  float* dl_s = reinterpret_cast<float*>(zr + (size_t)kBMB * ZR);  // [kBMB][kBNB]
  float* occ_s = dl_s + kBMB * kBNB;
  float* gb_s = occ_s + kBMB;
  float* gy_s = gb_s + kBMB;
  float* base_s = gy_s + kBMB;
  int* lab_s = reinterpret_cast<int*>(base_s + kBMB);
  int* fo_s = lab_s + kBMB;  // row of f (b * T + t), -1 past the slice
  int* go_s = fo_s + kBMB;   // row of g (b * (U+1) + u)

  const int v0 = blockIdx.x * kBNB;
  const int split = blockIdx.y;
  const int TU = T * U1;
  const int U = U1 - 1;
  const long long R = (long long)B * TU;
  const long long per = (R + n_split - 1) / n_split;
  const long long r_begin = split * per;
  const long long r_end = min(R, r_begin + per);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ty = tid / 8;  // GEMM1 rows 2ty, 2ty+1
  const int tx = tid % 8;  // GEMM1 columns tx*4 .. tx*4+3

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
    for (int r = tid; r < kBMB; r += kThreads) {
      if (r < rows) {
        const long long cell = c0 + r;
        const int b = (int)(cell / TU);
        const int rem = (int)(cell - (long long)b * TU);
        const int t = rem / U1;
        const int u = rem - t * U1;
        const float s = gbar[b];
        const float gbv = gb[cell];
        const float gyv = gy[cell];
        occ_s[r] = (gbv + gyv) * s;
        gb_s[r] = gbv * s;
        gy_s[r] = gyv * s;
        base_s[r] = base[cell];
        lab_s[r] = (u < U) ? labels[(size_t)b * U + u] : -1;
        fo_s[r] = b * T + t;
        go_s[r] = b * U1 + u;
      } else {
        occ_s[r] = gb_s[r] = gy_s[r] = base_s[r] = 0.0f;
        lab_s[r] = -1;
        fo_s[r] = go_s[r] = -1;
      }
    }
    __syncthreads();
    for (int r = warp; r < kBMB; r += kThreads / 32) {
      const int fo = fo_s[r];
      const int go = go_s[r];
      for (int k = lane; k < J; k += 32) {
        float z = 0.0f;
        if (fo >= 0) {
          z = tanhf(f[(size_t)fo * J + k] + g[(size_t)go * J + k]);
        }
        zr[(size_t)r * ZR + k] = from_float<W>(z);
      }
    }
    __syncthreads();
    // GEMM1: logits (rows, kBNB) = round(z) . W[:, tile]
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
                     occ_s[r], gb_s[r], gy_s[r]);
        }
        dl_s[r * kBNB + tx * 4 + c] = d;
      }
    }
    __syncthreads();
    if (tid < kBNB) {
      for (int r = 0; r < rows; ++r) db_acc += dl_s[r * kBNB + tid];
    }
    // GEMM3: dW[:, tile] += round(z)^T . round(dlogits)
    for (int r = 0; r < rows; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(
          dl_s + r * kBNB + warp * 4);
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
      if (k < J && v < V) {
        dw_part[((size_t)split * J + k) * V + v] = acc3[i][c];
      }
    }
  }
  if (tid < kBNB && v0 + tid < V) db_part[(size_t)split * V + v0 + tid] = db_acc;
}

// ---------------------- bf16: the tensor-core kernels ----------------------
//
// With W in bf16 the three products run on the tensor cores
// (mma_bf16.cuh: mma.sync m16n8k16, fp32 accumulate), which is the JAX
// semantics exactly: z, dlogits and W rounded to bf16, products summed in
// fp32. They need J % 16 == 0 and V even, and their tiles in shared memory
// (mma_a_fits); other shapes, and f32, take the kernels above.

using bf16 = __nv_bfloat16;
using joint_mma::frag_a;
using joint_mma::frag_b;
using joint_mma::mma_16816;

using joint_mma::kMK;
using joint_mma::kMR;
using joint_mma::kMV;
using joint_mma::kWTP;
using joint_mma::logits_chunk;
constexpr int kDZP = 260;  // pitch of the f32 dz buffer (256 columns)
static_assert(kThreads == joint_mma::kMmaThreads, "one block shape");

using joint_mma::build_z_rows;
using joint_mma::pitch_j;
using joint_mma::round_up;
__host__ __device__ constexpr int pitch_v(int V) {
  return round_up(V, kMV) + 8;
}

struct MmaALayout {
  size_t dl, z, wt, df, side, total;
};

__host__ __device__ inline MmaALayout mma_a_layout(int J, int V, int ft) {
  MmaALayout l;
  l.dl = 0;                                          // bf16 [kMR][pitch_v]
  l.z = l.dl + (size_t)kMR * pitch_v(V) * 2;         // bf16 [kMR][pitch_j]
  size_t zbytes = (size_t)kMR * pitch_j(J) * 2;      // or f32 [kMR][kDZP]
  if (zbytes < (size_t)kMR * kDZP * 4) zbytes = (size_t)kMR * kDZP * 4;
  l.wt = l.z + zbytes;                               // bf16 [kMV][kWTP]
  l.df = l.wt + (size_t)kMV * kWTP * 2;              // f32 [ft][J]
  l.side = l.df + (size_t)ft * J * 4;                // 7 x [kMR] words
  l.total = l.side + (size_t)7 * kMR * 4;
  return l;
}

bool mma_shapes_ok(int J, int V) { return J % 16 == 0 && V % 2 == 0; }

// Kernel A on the tensor cores. The rows of a block are the cells of its
// frame tile, flattened t-major, in chunks of kMR. For each chunk: the
// logits chunk by chunk of V and round(dlogits) for all of V into shared
// memory, then dz = round(dlogits) . W^T in two passes of 256 columns
// (W read as B fragments straight from L2: W[j][v], W[j][v+1] is one
// 32-bit load), dz *= 1 - z^2, and an ordered per-column walk over the
// rows that adds into df (per frame, in shared memory) and the tile's dg
// partial.
__global__ void __launch_bounds__(kThreads)
joint_bwd_a_mma_kernel(const float* __restrict__ f,
                       const float* __restrict__ g,
                       const int* __restrict__ labels,
                       const bf16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ gb,
                       const float* __restrict__ gy,
                       const float* __restrict__ base,
                       const float* __restrict__ gbar, float* __restrict__ df,
                       float* __restrict__ dg_part, int T, int U1, int J,
                       int V, int blank, int frames_per_tile, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaALayout lay = mma_a_layout(J, V, frames_per_tile);
  const int VP = pitch_v(V);
  const int JP = pitch_j(J);
  bf16* dlA = reinterpret_cast<bf16*>(smem_raw + lay.dl);
  bf16* zA = reinterpret_cast<bf16*>(smem_raw + lay.z);
  float* dzbuf = reinterpret_cast<float*>(smem_raw + lay.z);
  bf16* wt = reinterpret_cast<bf16*>(smem_raw + lay.wt);
  float* df_s = reinterpret_cast<float*>(smem_raw + lay.df);
  float* occ_s = reinterpret_cast<float*>(smem_raw + lay.side);
  float* gb_s = occ_s + kMR;
  float* gy_s = gb_s + kMR;
  float* base_s = gy_s + kMR;
  int* lab_s = reinterpret_cast<int*>(base_s + kMR);
  int* fo_s = lab_s + kMR;   // row of f, -1 past the chunk
  int* go_s = fo_s + kMR;    // row of g; the frame within the tile is
                             // fo - (b T + t_begin)

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int t_begin = tile * frames_per_tile;
  const int nf = min(T, t_begin + frames_per_tile) - t_begin;
  const int R = nf * U1;
  const int U = U1 - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const float s = gbar[b];
  const int Vr = round_up(V, 16);

  for (int idx = tid; idx < frames_per_tile * J; idx += kThreads) {
    df_s[idx] = 0.0f;
  }
  for (int c0 = 0; c0 < R; c0 += kMR) {
    const int rows = min(kMR, R - c0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int r = tid; r < kMR; r += kThreads) {
      if (r < rows) {
        const int t = t_begin + (c0 + r) / U1;
        const int u = (c0 + r) % U1;
        const size_t cell = ((size_t)b * T + t) * U1 + u;
        const float gbv = gb[cell];
        const float gyv = gy[cell];
        occ_s[r] = (gbv + gyv) * s;
        gb_s[r] = gbv * s;
        gy_s[r] = gyv * s;
        base_s[r] = base[cell];
        lab_s[r] = (u < U) ? labels[(size_t)b * U + u] : -1;
        fo_s[r] = b * T + t;
        go_s[r] = b * U1 + u;
      } else {
        occ_s[r] = gb_s[r] = gy_s[r] = base_s[r] = 0.0f;
        lab_s[r] = -1;
        fo_s[r] = go_s[r] = -1;
      }
    }
    __syncthreads();
    build_z_rows(zA, JP, f, g, fo_s, go_s, J, round_up(J, 16));

    // round(dlogits) for the whole chunk into dlA
    const int wm = warp / 4;
    const int wn = warp % 4;
    for (int v0 = 0; v0 < V; v0 += kMV) {
      float acc[2][4][4];
      logits_chunk(acc, zA, JP, wt, w, v0, J, V);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * 32 + mi * 16 + gq + ((e >= 2) ? 8 : 0);
            const int v = v0 + wn * 32 + ni * 8 + 2 * q + (e & 1);
            float d = 0.0f;
            if (r < rows && v < V) {
              d = dlogit(acc[mi][ni][e] + bias[v], v, blank, lab_s[r],
                         base_s[r], occ_s[r], gb_s[r], gy_s[r]);
            }
            dlA[(size_t)r * VP + v] = __float2bfloat16_rn(d);
          }
        }
      }
    }

    // dz = round(dlogits) . W^T, 256 columns per pass: warp w owns
    // columns jp + 32 w .. jp + 32 w + 31, all kMR rows.
    for (int jp = 0; jp < J; jp += 256) {
      float acc[4][4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
        }
      }
      __syncthreads();  // dlA complete; the last pass's dzbuf is consumed
      const int jw = jp + warp * 32;
      if (jw < J) {
        for (int k0 = 0; k0 < Vr; k0 += 16) {
          uint32_t a[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) frag_a(a[mi], dlA, VP, mi * 16, k0,
                                                lane);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int j = jw + ni * 8 + gq;
            const int v = k0 + 2 * q;
            uint32_t bb[2] = {0u, 0u};
            if (j < J) {
              const bf16* wr = w + (size_t)j * V;
              if (v < V) bb[0] = __ldg(reinterpret_cast<const unsigned int*>(wr + v));
              if (v + 8 < V) bb[1] = __ldg(reinterpret_cast<const unsigned int*>(wr + v + 8));
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) mma_16816(acc[mi][ni], a[mi], bb);
          }
        }
      }
      __syncthreads();  // every warp is done with zA (now dzbuf)
      if (jw < J) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mi * 16 + gq + ((e >= 2) ? 8 : 0);
              const int jj = warp * 32 + ni * 8 + 2 * q + (e & 1);
              const int j = jp + jj;
              float dz = 0.0f;
              if (r < rows && j < J) {
                const float z = tanhf(f[(size_t)fo_s[r] * J + j]
                                      + g[(size_t)go_s[r] * J + j]);
                dz = acc[mi][ni][e] * (1.0f - z * z);
              }
              dzbuf[r * kDZP + jj] = dz;
            }
          }
        }
      }
      __syncthreads();
      // Ordered walk over the rows: thread tid owns column jp + tid.
      const int j = jp + tid;
      if (j < J) {
        for (int r = 0; r < rows; ++r) {
          const float dz = dzbuf[r * kDZP + tid];
          const int tl = fo_s[r] - (b * T + t_begin);
          const int u = go_s[r] - b * U1;
          df_s[tl * J + j] += dz;
          float* p = dg_part + (((size_t)b * n_tiles + tile) * U1 + u) * J + j;
          *p = (tl == 0) ? dz : *p + dz;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nf * J; idx += kThreads) {
    const int tl = idx / J;
    const int j = idx - tl * J;
    df[((size_t)b * T + t_begin + tl) * J + j] = df_s[idx];
  }
}

// Kernel B on the tensor cores: W[:, tile]^T stays in shared memory; per
// chunk of kMR cells, logits (kMR, 32) = round(z) . W[:, tile] and
// dW[:, tile] (J, 32) += round(z)^T . round(dlogits), with z kept both
// row-major and transposed. Warp w owns rows 64 w .. 64 w + 63 of dW.
constexpr int kZTP = kMR + 8;  // pitch of z^T and dlogits^T (36 words)

size_t mma_b_bytes(int J) {
  return (size_t)kBNB * pitch_j(J) * 2      // wT  [32][JP]
         + (size_t)kMR * pitch_j(J) * 2     // zA  [kMR][JP]
         + (size_t)round_up(J, 64) * kZTP * 2  // zT [J][kZTP]
         + (size_t)kBNB * kZTP * 2          // dlT [32][kZTP]
         + (size_t)kMR * kBNB * 4           // dlf [kMR][32]
         + (size_t)7 * kMR * 4;             // sidecars
}

__global__ void __launch_bounds__(kThreads)
joint_bwd_b_mma_kernel(const float* __restrict__ f,
                       const float* __restrict__ g,
                       const int* __restrict__ labels,
                       const bf16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ gb,
                       const float* __restrict__ gy,
                       const float* __restrict__ base,
                       const float* __restrict__ gbar,
                       float* __restrict__ dw_part,
                       float* __restrict__ db_part, int B, int T, int U1,
                       int J, int V, int blank, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int JP = pitch_j(J);
  const int Jr = round_up(J, 64);
  bf16* wT = reinterpret_cast<bf16*>(smem_raw);
  bf16* zA = wT + (size_t)kBNB * JP;
  bf16* zT = zA + (size_t)kMR * JP;
  bf16* dlT = zT + (size_t)Jr * kZTP;
  float* dlf = reinterpret_cast<float*>(dlT + kBNB * kZTP);
  float* occ_s = dlf + kMR * kBNB;
  float* gb_s = occ_s + kMR;
  float* gy_s = gb_s + kMR;
  float* base_s = gy_s + kMR;
  int* lab_s = reinterpret_cast<int*>(base_s + kMR);
  int* fo_s = lab_s + kMR;
  int* go_s = fo_s + kMR;

  const int v0 = blockIdx.x * kBNB;
  const int split = blockIdx.y;
  const int TU = T * U1;
  const int U = U1 - 1;
  const long long R = (long long)B * TU;
  const long long per = (R + n_split - 1) / n_split;
  const long long r_begin = split * per;
  const long long r_end = min(R, r_begin + per);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;

  for (int idx = tid; idx < Jr * kBNB; idx += kThreads) {
    const int n = idx % kBNB;
    const int j = idx / kBNB;
    wT[n * JP + j] = (j < J && v0 + n < V) ? w[(size_t)j * V + v0 + n]
                                            : __float2bfloat16_rn(0.0f);
  }
  float acc3[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[mi][ni][e] = 0.0f;
    }
  }
  float db_acc = 0.0f;

  for (long long c0 = r_begin; c0 < r_end; c0 += kMR) {
    const int rows = (int)min((long long)kMR, r_end - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int r = tid; r < kMR; r += kThreads) {
      if (r < rows) {
        const long long cell = c0 + r;
        const int bb = (int)(cell / TU);
        const int rem = (int)(cell - (long long)bb * TU);
        const int t = rem / U1;
        const int u = rem - t * U1;
        const float s = gbar[bb];
        const float gbv = gb[cell];
        const float gyv = gy[cell];
        occ_s[r] = (gbv + gyv) * s;
        gb_s[r] = gbv * s;
        gy_s[r] = gyv * s;
        base_s[r] = base[cell];
        lab_s[r] = (u < U) ? labels[(size_t)bb * U + u] : -1;
        fo_s[r] = bb * T + t;
        go_s[r] = bb * U1 + u;
      } else {
        occ_s[r] = gb_s[r] = gy_s[r] = base_s[r] = 0.0f;
        lab_s[r] = -1;
        fo_s[r] = go_s[r] = -1;
      }
    }
    __syncthreads();
    for (int r = warp; r < kMR; r += kThreads / 32) {
      const int fo = fo_s[r];
      const int go = go_s[r];
      for (int j = lane; j < Jr; j += 32) {
        float z = 0.0f;
        if (fo >= 0 && j < J) {
          z = tanhf(f[(size_t)fo * J + j] + g[(size_t)go * J + j]);
        }
        const bf16 zb = __float2bfloat16_rn(z);
        zA[(size_t)r * JP + j] = zb;
        zT[(size_t)j * kZTP + r] = zb;
      }
    }
    __syncthreads();
    // logits (kMR, 32): 4 m-tiles x 4 n-tiles, two per warp
    {
      const int mt = warp / 2;
      const int n0 = (warp % 2) * 2;
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
      for (int k0 = 0; k0 < J; k0 += 16) {
        uint32_t a[4];
        frag_a(a, zA, JP, mt * 16, k0, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t bb[2];
          frag_b(bb, wT, JP, (n0 + i) * 8, k0, lane);
          mma_16816(acc[i], a, bb);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + gq + ((e >= 2) ? 8 : 0);
          const int col = (n0 + i) * 8 + 2 * q + (e & 1);
          const int v = v0 + col;
          float d = 0.0f;
          if (r < rows && v < V) {
            d = dlogit(acc[i][e] + bias[v], v, blank, lab_s[r], base_s[r],
                       occ_s[r], gb_s[r], gy_s[r]);
          }
          dlf[r * kBNB + col] = d;
          dlT[col * kZTP + r] = __float2bfloat16_rn(d);
        }
      }
    }
    __syncthreads();
    if (tid < kBNB) {
      for (int r = 0; r < rows; ++r) db_acc += dlf[r * kBNB + tid];
    }
    // dW[:, tile] += round(z)^T . round(dlogits), K = the chunk's rows
#pragma unroll
    for (int k0 = 0; k0 < kMR; k0 += 16) {
      uint32_t bb[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) frag_b(bb[ni], dlT, kZTP, ni * 8, k0,
                                            lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int j0 = warp * 64 + mi * 16;
        if (j0 >= Jr) break;
        uint32_t a[4];
        frag_a(a, zT, kZTP, j0, k0, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc3[mi][ni], a, bb[ni]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = warp * 64 + mi * 16 + gq + ((e >= 2) ? 8 : 0);
        const int v = v0 + ni * 8 + 2 * q + (e & 1);
        if (j < J && v < V) {
          dw_part[((size_t)split * J + j) * V + v] = acc3[mi][ni][e];
        }
      }
    }
  }
  if (tid < kBNB && v0 + tid < V) {
    db_part[(size_t)split * V + v0 + tid] = db_acc;
  }
}

// out[o, x] = sum_p part[o, p, x], p in order.
__global__ void reduce_parts_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int n_outer,
                                    int n_parts, long long X) {
  const long long n = (long long)n_outer * X;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long o = idx / X;
    const long long x = idx - o * X;
    float acc = 0.0f;
    for (int p = 0; p < n_parts; ++p) acc += part[(o * n_parts + p) * X + x];
    out[idx] = acc;
  }
}

int reduce_parts(const float* part, float* out, int n_outer, int n_parts,
                 long long X, cudaStream_t stream) {
  const long long n = (long long)n_outer * X;
  const int blocks = (int)std::min((n + kThreads - 1) / kThreads, 4096LL);
  reduce_parts_kernel<<<blocks, kThreads, 0, stream>>>(part, out, n_outer,
                                                       n_parts, X);
  return (int)cudaGetLastError();
}

template <typename W>
int run_bwd(const void* f, const void* g, const void* labels, const void* w,
            const void* bias, const void* gb, const void* gy, const void* base,
            const void* gbar, void* df, void* dg, void* dw, void* db,
            void* dg_part, void* dw_part, void* db_part, int B, int T, int U1,
            int J, int V, int blank, int frames_per_tile, int n_split,
            cudaStream_t stream) {
  if (J > kMaxJ) return (int)cudaErrorInvalidValue;
  const int n_tiles = (T + frames_per_tile - 1) / frames_per_tile;
  const float* f_ = static_cast<const float*>(f);
  const float* g_ = static_cast<const float*>(g);
  const int* lab_ = static_cast<const int*>(labels);
  const W* w_ = static_cast<const W*>(w);
  const float* bias_ = static_cast<const float*>(bias);
  const float* gb_ = static_cast<const float*>(gb);
  const float* gy_ = static_cast<const float*>(gy);
  const float* base_ = static_cast<const float*>(base);
  const float* gbar_ = static_cast<const float*>(gbar);
  const dim3 grid_a(n_tiles, B);
  const dim3 grid_b((V + kBNB - 1) / kBNB, n_split);
  bool a_done = false, b_done = false;
  if constexpr (std::is_same_v<W, bf16>) {
    if (mma_shapes_ok(J, V)) {
      const size_t sa = mma_a_layout(J, V, frames_per_tile).total;
      if (sa <= kMaxSmem) {
        cudaError_t e = cudaFuncSetAttribute(
            joint_bwd_a_mma_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
        if (e != cudaSuccess) return (int)e;
        joint_bwd_a_mma_kernel<<<grid_a, kThreads, sa, stream>>>(
            f_, g_, lab_, w_, bias_, gb_, gy_, base_, gbar_,
            static_cast<float*>(df), static_cast<float*>(dg_part), T, U1, J,
            V, blank, frames_per_tile, n_tiles);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        a_done = true;
      }
      const size_t sb = mma_b_bytes(J);
      if (sb <= kMaxSmem) {
        cudaError_t e = cudaFuncSetAttribute(
            joint_bwd_b_mma_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
        if (e != cudaSuccess) return (int)e;
        joint_bwd_b_mma_kernel<<<grid_b, kThreads, sb, stream>>>(
            f_, g_, lab_, w_, bias_, gb_, gy_, base_, gbar_,
            static_cast<float*>(dw_part), static_cast<float*>(db_part), B, T,
            U1, J, V, blank, n_split);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        b_done = true;
      }
    }
  }
  if (!a_done) {
    const size_t sa = smem_a<W>(J);
    cudaError_t e = cudaFuncSetAttribute(
        joint_bwd_a_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sa);
    if (e != cudaSuccess) return (int)e;
    joint_bwd_a_kernel<W><<<grid_a, kThreads, sa, stream>>>(
        f_, g_, lab_, w_, bias_, gb_, gy_, base_, gbar_,
        static_cast<float*>(df), static_cast<float*>(dg_part), T, U1, J, V,
        blank, frames_per_tile, n_tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!b_done) {
    const size_t sb = smem_b<W>(J);
    cudaError_t e = cudaFuncSetAttribute(
        joint_bwd_b_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sb);
    if (e != cudaSuccess) return (int)e;
    joint_bwd_b_kernel<W><<<grid_b, kThreads, sb, stream>>>(
        f_, g_, lab_, w_, bias_, gb_, gy_, base_, gbar_,
        static_cast<float*>(dw_part), static_cast<float*>(db_part), B, T, U1,
        J, V, blank, n_split);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int err = reduce_parts(static_cast<const float*>(dg_part),
                         static_cast<float*>(dg), B, n_tiles,
                         (long long)U1 * J, stream);
  if (err) return err;
  err = reduce_parts(static_cast<const float*>(dw_part),
                     static_cast<float*>(dw), 1, n_split, (long long)J * V,
                     stream);
  if (err) return err;
  return reduce_parts(static_cast<const float*>(db_part),
                      static_cast<float*>(db), 1, n_split, V, stream);
}

}  // namespace

// Five launches on `stream` (A, B, three ordered sums). Returns 0, or the
// first cudaError_t a launch reported. The partial buffers are scratch of
// the sizes given in the header.
extern "C" int joint_bwd(const void* f, const void* g, const void* labels,
                         const void* w, int w_is_bf16, const void* bias,
                         const void* gb, const void* gy, const void* base,
                         const void* gbar, void* df, void* dg, void* dw,
                         void* db, void* dg_part, void* dw_part,
                         void* db_part, int B, int T, int U1, int J, int V,
                         int blank, int frames_per_tile, int n_split,
                         int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_bwd<__nv_bfloat16>(f, g, labels, w, bias, gb, gy, base, gbar,
                                  df, dg, dw, db, dg_part, dw_part, db_part,
                                  B, T, U1, J, V, blank, frames_per_tile,
                                  n_split, s);
  }
  return run_bwd<float>(f, g, labels, w, bias, gb, gy, base, gbar, df, dg, dw,
                        db, dg_part, dw_part, db_part, B, T, U1, J, V, blank,
                        frames_per_tile, n_split, s);
}
