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
// Design, on the caller's stream (an entry point for each step, so that
// a caller can time them apart):
//   A  grid (frame tiles, B): df, and the tile's dg partial. dlogits never
//      leaves the chip.
//   B  dW and db, recomputing the logits. With W in bf16, J % 16 == 0 and
//      V even, two launches on the ring of zb_ring.cuh, which the band
//      joint's kernel B (band_fused.cu) shares: joint_bwd_b_zb_kernel
//      writes zb = round(z) of the N = B T (U+1) cells once a call, (N
//      padded to 64, J + 8) bf16; joint_bwd_b_ring_kernel gives a block 64
//      V columns (W[:, tile]^T in shared memory, dW[:, tile] f32 in
//      registers) and walks 64-cell chunks of zb through a two-slot TMA
//      ring, on the one-wave grid of ops/rnnt_band_fused.bwd_b_plan (16
//      tiles x 8 row splits at libri100), its row policy reading each
//      cell's label (-1 at u = U), base and occupancies. With W in f32, or
//      other shapes: grid (V tiles of kBNB columns, ROW_SPLITS row splits)
//      on the CUDA cores, z built per chunk of kBMB cells.
//   C  ordered sums of the partials: dg over frame tiles, dW and db over
//      row splits (none for dW and db when the ring's plan has one split).
//      No float atomics anywhere: two runs give identical bits.
// A comes in two forms:
//   * W in bf16 (the training path): on the tensor cores (mma_bf16.cuh).
//     It takes the cells of its frame tile flattened, kMR at a time: the
//     logits kMV columns at a time, round(dlogits) for all of V in shared
//     memory, then dz = round(dlogits) . W^T in passes of 256 columns with
//     W's B fragments read straight from L2, dz *= 1 - z^2, and an ordered
//     per-column walk over the rows into df and dg. Needs J % 16 == 0, V
//     even and its tiles in shared memory (227 KB at libri100).
//   * W in f32 (the parity runs), or other shapes: CUDA-core FMAs, each
//     frame's label positions in row blocks of up to kBM, for each V chunk
//     of kBN columns staging W[:, chunk], rebuilding z kBK columns at a
//     time and adding dlogits . W^T into a (kBM, J) dz tile in shared
//     memory.
//
// Scratch memory (the wrapper allocates it): B * ceil(T / frames_per_tile)
// * (U+1) * J floats for dg's partials, splits * (J * V + V) floats for
// dW's and db's, and zb: 67 MB, 16.8 MB (8 splits) and 273 MB at libri100
// (B=32, T'=200, U+1=41, J=512, V=1024, 8 frames per tile).
//
// What bounds it on the H100: four products of 2 * cells * J * V flops
// (A and B each recompute the logits; 1.1 TFLOP at libri100, 1.1 ms at the
// bf16 dense peak, 0.56 ms each for A and B). Measured at libri100 in bf16
// on an NVIDIA H100 80GB HBM3, 700.00 W (bench_band_bwd_b.py, by
// torch.profiler's kernel times): A 17.3 ms, 31x its share, far from it:
// it rebuilds z per chunk and stages W through shared memory with single
// buffering, one block an SM (ROADMAP queue 2 pairs it with K6-A); B's
// zb pass 0.17 ms (273 MB written) and its ring kernel 2.79 ms (20.9 with
// z rebuilt per 32-column tile), 5.0x its share: a block walks 513
// chunks at 5.4 us, each chunk's logits, epilogue and dW product one
// after another between block barriers, as in K6-B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <type_traits>

#include "zb_ring.cuh"

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
// fp32. They need J % 16 == 0 and V even, and A its tiles in shared
// memory (mma_a_layout); other shapes, and f32, take the kernels above.

using bf16 = __nv_bfloat16;
using joint_mma::frag_a;
using joint_mma::mma_16816;

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

// Kernel B on the tensor cores, two launches on the ring of zb_ring.cuh
// (shared with the band joint's kernel B, band_fused.cu):
// joint_bwd_b_zb_kernel writes zb = round(z) once a call, row r = (b T +
// t) (U+1) + u from f[b, t] and g[b, u]; joint_bwd_b_ring_kernel runs the
// ring with the cells' row policy.

// Cell r = (b T + t) U1 + u: f row b T + t = r / U1, g row b U1 + u.
struct JointMap {
  long long TU;  // T * U1
  int U1;
  __device__ long long f_row(long long r) const { return r / U1; }
  __device__ long long g_row(long long r) const {
    return (r / TU) * U1 + r % U1;
  }
};

// The cells' sidecars: the label (-1 at u = U), base, and the occupancies
// scaled by s = gbar[b] as kernel A scales them; dlogits as `dlogit` above.
struct JointRows {
  const int* __restrict__ labels;
  const float* __restrict__ gb;
  const float* __restrict__ gy;
  const float* __restrict__ base;
  const float* __restrict__ gbar;
  long long TU;  // T * U1
  int U1;
  __device__ void load(long long row, float (&s)[zb_ring::kSideWords]) const {
    const long long b = row / TU;
    const int u = (int)(row % U1);
    const float sc = gbar[b];
    const float gbv = gb[row];
    const float gyv = gy[row];
    s[0] = __int_as_float(u < U1 - 1 ? labels[b * (U1 - 1) + u] : -1);
    s[1] = base[row];
    s[2] = (gbv + gyv) * sc;
    s[3] = gbv * sc;
    s[4] = gyv * sc;
  }
  __device__ float dlogit(const float (&s)[zb_ring::kSideWords], float x,
                          int v, int blank) const {
    return ::dlogit(x, v, blank, __float_as_int(s[0]), s[1], s[2], s[3],
                    s[4]);
  }
};

__global__ void __launch_bounds__(kThreads)
joint_bwd_b_zb_kernel(const float* __restrict__ f, const float* __restrict__ g,
                      bf16* __restrict__ zb, long long N, long long n_rows,
                      int T, int U1, int J, int JP) {
  zb_ring::build_zb(f, g, zb, N, n_rows, J, JP,
                    JointMap{(long long)T * U1, U1});
}

__global__ void __launch_bounds__(kThreads, 1)
joint_bwd_b_ring_kernel(const bf16* __restrict__ zb,
                        const int* __restrict__ labels,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ gb,
                        const float* __restrict__ gy,
                        const float* __restrict__ base,
                        const float* __restrict__ gbar,
                        float* __restrict__ dw_out,
                        float* __restrict__ db_out, long long N, int T,
                        int U1, int J, int V, int blank,
                        long long split_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  zb_ring::ring_body(smem_raw, zb,
                     JointRows{labels, gb, gy, base, gbar, (long long)T * U1,
                               U1},
                     w, bias, dw_out, db_out, N, J, V, blank, split_rows);
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Kernel A: the tensor-core form where W is bf16, the shape takes it and
// its tiles fit; the CUDA-core form otherwise.
template <typename W>
int run_a(const float* f, const float* g, const int* labels, const W* w,
          const float* bias, const float* gb, const float* gy,
          const float* base, const float* gbar, float* df, float* dg_part,
          int B, int T, int U1, int J, int V, int blank, int frames_per_tile,
          cudaStream_t stream) {
  const int n_tiles = (T + frames_per_tile - 1) / frames_per_tile;
  const dim3 grid(n_tiles, B);
  if constexpr (std::is_same_v<W, bf16>) {
    const size_t sa = mma_a_layout(J, V, frames_per_tile).total;
    if (mma_shapes_ok(J, V) && sa <= kMaxSmem) {
      const cudaError_t e = set_smem(joint_bwd_a_mma_kernel, sa);
      if (e != cudaSuccess) return (int)e;
      joint_bwd_a_mma_kernel<<<grid, kThreads, sa, stream>>>(
          f, g, labels, w, bias, gb, gy, base, gbar, df, dg_part, T, U1, J,
          V, blank, frames_per_tile, n_tiles);
      return (int)cudaGetLastError();
    }
  }
  const size_t sa = smem_a<W>(J);
  const cudaError_t e = set_smem(joint_bwd_a_kernel<W>, sa);
  if (e != cudaSuccess) return (int)e;
  joint_bwd_a_kernel<W><<<grid, kThreads, sa, stream>>>(
      f, g, labels, w, bias, gb, gy, base, gbar, df, dg_part, T, U1, J, V,
      blank, frames_per_tile, n_tiles);
  return (int)cudaGetLastError();
}

template <typename W>
int run_b(const float* f, const float* g, const int* labels, const W* w,
          const float* bias, const float* gb, const float* gy,
          const float* base, const float* gbar, float* dw_part,
          float* db_part, int B, int T, int U1, int J, int V, int blank,
          int n_split, cudaStream_t stream) {
  const size_t sb = smem_b<W>(J);
  const cudaError_t e = set_smem(joint_bwd_b_kernel<W>, sb);
  if (e != cudaSuccess) return (int)e;
  joint_bwd_b_kernel<W><<<dim3((V + kBNB - 1) / kBNB, n_split), kThreads, sb,
                          stream>>>(f, g, labels, w, bias, gb, gy, base, gbar,
                                    dw_part, db_part, B, T, U1, J, V, blank,
                                    n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points launch on `stream` and return 0, or the first
// cudaError_t a launch reported. J <= 512. A call of the backward is
// kernel A, then kernel B (the ring's two launches for bf16 W where
// ops/rnnt_band_fused.bwd_b_plan places it, else the CUDA-core form),
// then the ordered sums; the partial buffers are scratch of the sizes
// given in the header.

// Kernel A: df (B, T, J) and dg_part (B, n_tiles, U1, J), n_tiles =
// ceil(T / frames_per_tile).
extern "C" int joint_bwd_a(const void* f, const void* g, const void* labels,
                           const void* w, int w_is_bf16, const void* bias,
                           const void* gb, const void* gy, const void* base,
                           const void* gbar, void* df, void* dg_part, int B,
                           int T, int U1, int J, int V, int blank,
                           int frames_per_tile, int device, void* stream) {
  if (J > kMaxJ || frames_per_tile < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* f_ = static_cast<const float*>(f);
  const float* g_ = static_cast<const float*>(g);
  const int* lab_ = static_cast<const int*>(labels);
  const float* bias_ = static_cast<const float*>(bias);
  const float* gb_ = static_cast<const float*>(gb);
  const float* gy_ = static_cast<const float*>(gy);
  const float* base_ = static_cast<const float*>(base);
  const float* gbar_ = static_cast<const float*>(gbar);
  float* df_ = static_cast<float*>(df);
  float* dgp = static_cast<float*>(dg_part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_a<bf16>(f_, g_, lab_, static_cast<const bf16*>(w), bias_, gb_,
                       gy_, base_, gbar_, df_, dgp, B, T, U1, J, V, blank,
                       frames_per_tile, s);
  }
  return run_a<float>(f_, g_, lab_, static_cast<const float*>(w), bias_, gb_,
                      gy_, base_, gbar_, df_, dgp, B, T, U1, J, V, blank,
                      frames_per_tile, s);
}

// Kernel B's CUDA-core form (f32 W, or bf16 W of a shape the ring does not
// take): grid (V / 32 column tiles, n_split row splits) into dw_part
// (n_split, J, V) and db_part (n_split, V).
extern "C" int joint_bwd_b(const void* f, const void* g, const void* labels,
                           const void* w, int w_is_bf16, const void* bias,
                           const void* gb, const void* gy, const void* base,
                           const void* gbar, void* dw_part, void* db_part,
                           int B, int T, int U1, int J, int V, int blank,
                           int n_split, int device, void* stream) {
  if (J > kMaxJ || n_split < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* f_ = static_cast<const float*>(f);
  const float* g_ = static_cast<const float*>(g);
  const int* lab_ = static_cast<const int*>(labels);
  const float* bias_ = static_cast<const float*>(bias);
  const float* gb_ = static_cast<const float*>(gb);
  const float* gy_ = static_cast<const float*>(gy);
  const float* base_ = static_cast<const float*>(base);
  const float* gbar_ = static_cast<const float*>(gbar);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_b<bf16>(f_, g_, lab_, static_cast<const bf16*>(w), bias_, gb_,
                       gy_, base_, gbar_, dwp, dbp, B, T, U1, J, V, blank,
                       n_split, s);
  }
  return run_b<float>(f_, g_, lab_, static_cast<const float*>(w), bias_, gb_,
                      gy_, base_, gbar_, dwp, dbp, B, T, U1, J, V, blank,
                      n_split, s);
}

// Kernel B on the ring, first launch: zb (ceil(N / 64) * 64, pitch_j(J))
// bf16 = round(z) of the N = B T U1 cells, zero past N rows and J columns.
extern "C" int joint_bwd_b_zb(const void* f, const void* g, void* zb, int B,
                              int T, int U1, int J, int device,
                              void* stream) {
  if (J > kMaxJ || J % 16 != 0 || J < 16) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * U1;
  const long long n_rows = (N + kMR - 1) / kMR * kMR;
  const int JP = pitch_j(J);
  const long long n = n_rows * (JP / zb_ring::kZbVec);
  const int blocks = (int)std::min((n + kThreads - 1) / kThreads, 8192LL);
  joint_bwd_b_zb_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(g),
      static_cast<bf16*>(zb), N, n_rows, T, U1, J, JP);
  return (int)cudaGetLastError();
}

// Kernel B on the ring, the main launch on the plan of
// ops/rnnt_band_fused.bwd_b_plan: grid (grid_x, n_split), split y owning
// cells y * split_rows .. (a multiple of 64, every split non-empty),
// smem_bytes the block's shared memory (zb_ring::ring_bytes(J)). Writes
// dw_out (n_split, J, V) and db_out (n_split, V): dW and db themselves
// when n_split == 1, else the partials that joint_bwd_sums adds up.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int joint_bwd_b_ring(const void* zb, const void* labels,
                                const void* w, const void* bias,
                                const void* gb, const void* gy,
                                const void* base, const void* gbar,
                                void* dw_out, void* db_out, int B, int T,
                                int U1, int J, int V, int blank, int grid_x,
                                int n_split, long long split_rows,
                                long long smem_bytes, int device,
                                void* stream) {
  const long long N = (long long)B * T * U1;
  if (!zb_ring::plan_ok(N, J, V, grid_x, n_split, split_rows, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = zb_ring::ring_bytes(J);
  const cudaError_t e1 = set_smem(joint_bwd_b_ring_kernel, smem);
  if (e1 != cudaSuccess) return (int)e1;
  joint_bwd_b_ring_kernel<<<dim3(grid_x, n_split), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(zb), static_cast<const int*>(labels),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gb), static_cast<const float*>(gy),
      static_cast<const float*>(base), static_cast<const float*>(gbar),
      static_cast<float*>(dw_out), static_cast<float*>(db_out), N, T, U1, J,
      V, blank, split_rows);
  return (int)cudaGetLastError();
}

// The ordered sums: dg (B, U1, J) over kernel A's n_tiles frame tiles; dw
// (J, V) and db (V) over kernel B's n_split splits, or nothing for them
// when n_split == 0 (the ring wrote them itself).
extern "C" int joint_bwd_sums(const void* dg_part, void* dg,
                              const void* dw_part, void* dw,
                              const void* db_part, void* db, int B,
                              int n_tiles, int U1, int J, int V, int n_split,
                              int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = reduce_parts(static_cast<const float*>(dg_part),
                         static_cast<float*>(dg), B, n_tiles,
                         (long long)U1 * J, s);
  if (err || n_split == 0) return err;
  err = reduce_parts(static_cast<const float*>(dw_part),
                     static_cast<float*>(dw), 1, n_split, (long long)J * V, s);
  if (err) return err;
  return reduce_parts(static_cast<const float*>(db_part),
                      static_cast<float*>(db), 1, n_split, V, s);
}
