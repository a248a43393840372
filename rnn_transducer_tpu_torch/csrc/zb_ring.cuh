// The dW / db backward of a joint on the tensor cores (sm_90), shared by
// the band joint's kernel B (band_fused.cu, K6-B) and the fused joint's
// kernel B (joint_bwd.cu, K2-B). Both compute, over N rows of round(z),
//   logits = round(z) . W + bias                    (recomputed, fp32 acc.)
//   dW     = sum_rows round(z)^T round(dlogits),   db = sum_rows dlogits,
// and differ only in each row's sidecars (label, log-sum-exp, loss
// cotangents) and in how dlogits follows from them: a row policy, a small
// struct with
//   __device__ void load(long long row, float (&s)[kSideWords]) const;
//   __device__ float dlogit(const float (&s)[kSideWords], float x, int v,
//                           int blank) const;
// (`s` holds the row's sidecars, an int as its bits; x is the logit with
// the bias added, v its column).
//
// Two launches. `build_zb` writes zb = round(z), (ceil(N / kMR) kMR,
// pitch_j(J)) bf16, once a call, with tanhf and __float2bfloat16_rn, zero
// past N rows and past J columns; a row map gives each row its f and g
// rows. `ring_body`, the main kernel: block (x, y) owns the column tiles
// x, x + gridDim.x, .. of kVT columns and the rows y * split_rows .. of
// split y; every block of a grid row walks the same chunks of kMR rows in
// the same order, so the chunks the resident blocks read at one time sit
// in L2 and zb crosses HBM about once. Per column tile it keeps W[:, tile]^T
// in shared memory and dW[:, tile] (J, kVT) f32 in registers: warp w owns
// j = 64 w .. 64 w + 63, 4 m-tiles by 8 n-tiles. Per chunk:
//   thread 0 has already issued the chunk's rows of zb into one of two
//   ring slots (one TMA bulk copy, mbarrier: tma_bulk::Ring2, which the
//   band joint's kernel A, wt_ring.cuh, shares) during the last chunk, and
//   now issues the next chunk's; threads 0 .. kMR-1 load the next chunk's
//   sidecars into registers (into shared memory after this chunk's
//   epilogue: two slots);
//   logits (kMR, kVT) = z . W[:, tile] on mma.sync, warp w rows 16 (w % 4)
//   .., columns 32 (w / 4) ..; the policy's dlogits in registers into dlf
//   (f32, for db) and dlT (round(dlogits)^T, bf16);
//   db += the chunk's dlogits in row order (threads 0 .. kVT-1), while
//   dW += z^T . round(dlogits) on mma.sync, z^T's A fragments straight
//   from the ring slot by ldmatrix.trans.
// A split writes its dW / db partials (or, with one split, dW and db);
// the caller sums the partials in split order, so two runs give the same
// bits. No float atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"
#include "tma_bulk.cuh"

namespace zb_ring {

using bf16 = __nv_bfloat16;
using joint_mma::frag_a;
using joint_mma::frag_a_trans;
using joint_mma::frag_b;
using joint_mma::kMR;
using joint_mma::mma_16816;
using joint_mma::pitch_j;
using joint_mma::round_up;

constexpr int kThreads = 256;
constexpr int kMaxJ = 512;
constexpr int kVT = 64;          // V columns a block tile
constexpr int kDLTP = kMR + 8;   // pitch of dlT (36 words: 4 mod 32)
constexpr int kDLFP = kVT + 4;   // pitch of the f32 dlogits chunk
constexpr int kZbVec = 8;        // zb elements a thread writes at a time
constexpr int kSideWords = 5;    // sidecar words a row, two chunk slots
static_assert(kThreads == joint_mma::kMmaThreads, "one block shape");

// Shared bytes of a ring block: ring [2][kMR][JP], wT [kVT][JP], dlT
// [kVT][kDLTP], dlf [kMR][kDLFP], sidecars [2][kSideWords][kMR], two
// mbarriers.
inline size_t ring_bytes(int J) {
  return (size_t)2 * kMR * pitch_j(J) * 2 + (size_t)kVT * pitch_j(J) * 2
         + (size_t)kVT * kDLTP * 2 + (size_t)kMR * kDLFP * 4
         + (size_t)2 * kSideWords * kMR * 4
         + 2 * sizeof(unsigned long long);
}

// The shapes the ring takes (W bf16): 16 <= J <= 512, J % 16 == 0, V even.
inline bool shapes_ok(int J, int V) {
  return J >= 16 && J <= kMaxJ && J % 16 == 0 && V % 2 == 0;
}

// Whether a plan (ops/rnnt_band_fused.bwd_b_plan) can run: split_rows a
// multiple of kMR, every split non-empty, the rows covered, the grid no
// wider than the column tiles, the shared bytes the kernel's.
inline bool plan_ok(long long N, int J, int V, int grid_x, int n_split,
                    long long split_rows, long long smem_bytes) {
  const int n_tiles = (V + kVT - 1) / kVT;
  return shapes_ok(J, V) && N >= 1 && grid_x >= 1 && grid_x <= n_tiles &&
         n_split >= 1 && split_rows >= kMR && split_rows % kMR == 0 &&
         split_rows * (n_split - 1) < N && split_rows * n_split >= N &&
         smem_bytes == (long long)ring_bytes(J);
}

// zb = round(tanh(f[map.f_row(r)] + g[map.g_row(r)])) for rows r < N,
// zero past N and past J; a grid-stride loop over groups of kZbVec.
template <class Map>
__device__ __forceinline__ void build_zb(const float* __restrict__ f,
                                         const float* __restrict__ g,
                                         bf16* __restrict__ zb, long long N,
                                         long long n_rows, int J, int JP,
                                         const Map& map) {
  const int groups = JP / kZbVec;
  const long long n = n_rows * groups;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / groups;
    const int j = (int)(idx - r * groups) * kZbVec;
    float z[kZbVec];
    if (r < N && j < J) {  // J % 16 == 0: a group is all in or all out
      const float* fr = f + map.f_row(r) * J + j;
      const float* gr = g + map.g_row(r) * J + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(fr + 4 * h);
        const float4 b = *reinterpret_cast<const float4*>(gr + 4 * h);
        z[4 * h + 0] = tanhf(a.x + b.x);
        z[4 * h + 1] = tanhf(a.y + b.y);
        z[4 * h + 2] = tanhf(a.z + b.z);
        z[4 * h + 3] = tanhf(a.w + b.w);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kZbVec; ++c) z[c] = 0.0f;
    }
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int c = 0; c < kZbVec / 2; ++c) {
      const __nv_bfloat162 p = __halves2bfloat162(
          __float2bfloat16_rn(z[2 * c]), __float2bfloat16_rn(z[2 * c + 1]));
      o[c] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(zb + r * JP + j) = out;
  }
}

// The main kernel's body, for a __global__ of kThreads threads and
// ring_bytes(J) bytes of dynamic shared memory `smem`, one block an SM.
template <class Rows>
__device__ __forceinline__ void ring_body(
    unsigned char* smem, const bf16* __restrict__ zb, const Rows& rows_p,
    const bf16* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ dw_out, float* __restrict__ db_out, long long N,
    int J, int V, int blank, long long split_rows) {
  const int JP = pitch_j(J);
  const int Jr = round_up(J, 64);
  bf16* wT = reinterpret_cast<bf16*>(smem) + (size_t)2 * kMR * JP;
  bf16* dlT = wT + (size_t)kVT * JP;
  float* dlf = reinterpret_cast<float*>(dlT + kVT * kDLTP);
  float* side = dlf + kMR * kDLFP;  // [2][kSideWords][kMR]
  const tma_bulk::Ring2 ring{
      smem, (unsigned int)(kMR * JP * sizeof(bf16)),
      static_cast<unsigned int>(
          __cvta_generic_to_shared(side + 2 * kSideWords * kMR))};

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int mt = warp % 4;       // logits: rows 16 mt ..
  const int nh = warp / 4;       // logits: columns 32 nh ..
  const int j0w = warp * 64;     // dW: rows j0w .. j0w + 63
  const int r_lo = mt * 16 + gq;  // the thread's logits rows r_lo, r_lo + 8

  const long long r_begin = blockIdx.y * split_rows;
  const long long r_end = min(N, r_begin + split_rows);
  const int n_ch = (int)((r_end - r_begin + kMR - 1) / kMR);
  const int n_tiles = (V + kVT - 1) / kVT;
  const int my_tiles =
      ((int)blockIdx.x < n_tiles)
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int total = n_ch > 0 ? my_tiles * n_ch : 0;
  const size_t split = blockIdx.y;

  // iteration i stages chunk i % n_ch of the split into slot i & 1
  auto issue = [&](int i) {
    ring.issue(i, zb + (r_begin + (long long)(i % n_ch) * kMR) * JP);
  };
  // iteration i's sidecars: thread r < kMR loads row r's into sw, then
  // stores them into slot i & 1
  float sw[kSideWords];
  auto load_side = [&](int i) {
    if (tid >= kMR) return;
    const long long row = r_begin + (long long)(i % n_ch) * kMR + tid;
    if (row < r_end) {
      rows_p.load(row, sw);
    } else {
#pragma unroll
      for (int k = 0; k < kSideWords; ++k) sw[k] = 0.0f;
    }
  };
  auto store_side = [&](int i) {
    if (tid >= kMR) return;
#pragma unroll
    for (int k = 0; k < kSideWords; ++k) {
      side[((i & 1) * kSideWords + k) * kMR + tid] = sw[k];
    }
  };
  if (tid == 0) {
    ring.init();
    if (total > 0) issue(0);
  }
  if (total > 0) {
    load_side(0);
    store_side(0);
  }

  float acc3[4][8][4];
  float db_acc = 0.0f;
  float bias_r[4][2];
  int v0 = 0;
  for (int i = 0; i < total; ++i) {
    const int c = i % n_ch;
    const long long c0 = r_begin + (long long)c * kMR;
    const int rows = (int)min((long long)kMR, r_end - c0);
    const bf16* zs = ring.slot<const bf16>(i);
    __syncthreads();  // chunk i-1 is consumed: its slot, wT, dlT and dlf
    if (tid == 0 && i + 1 < total) issue(i + 1);
    if (c == 0) {  // a new column tile
      v0 = (blockIdx.x + (i / n_ch) * gridDim.x) * kVT;
      for (int idx = tid; idx < Jr * kVT; idx += kThreads) {
        const int n = idx % kVT;
        const int j = idx / kVT;
        wT[n * JP + j] = (j < J && v0 + n < V) ? w[(size_t)j * V + v0 + n]
                                                : __float2bfloat16_rn(0.0f);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc3[mi][ni][e] = 0.0f;
        }
      }
      db_acc = 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + nh * 32 + ni * 8 + 2 * q + e;
          bias_r[ni][e] = (v < V) ? bias[v] : 0.0f;
        }
      }
      __syncthreads();
    }
    // the next chunk's sidecars, in flight under this chunk's products
    if (i + 1 < total) load_side(i + 1);
    ring.wait(i);

    // logits of rows 16 mt .., columns 32 nh .. of the tile
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;
    }
    for (int k0 = 0; k0 < J; k0 += 16) {
      uint32_t a[4];
      frag_a(a, zs, JP, mt * 16, k0, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t bb[2];
        frag_b(bb, wT, JP, nh * 32 + ni * 8, k0, lane);
        mma_16816(acc[ni], a, bb);
      }
    }
    const float* sd = side + (size_t)(i & 1) * kSideWords * kMR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const bool ok = r < rows;
      float s[kSideWords];
#pragma unroll
      for (int k = 0; k < kSideWords; ++k) s[k] = sd[k * kMR + r];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nh * 32 + ni * 8 + 2 * q + e;
          const int v = v0 + col;
          float d = 0.0f;
          if (ok && v < V) {
            d = rows_p.dlogit(s, acc[ni][2 * h + e] + bias_r[ni][e], v,
                              blank);
          }
          dlf[r * kDLFP + col] = d;
          dlT[col * kDLTP + r] = __float2bfloat16_rn(d);
        }
      }
    }
    if (i + 1 < total) store_side(i + 1);  // slot (i+1) & 1 was read in i-1
    __syncthreads();
    if (tid < kVT) {
      for (int r = 0; r < rows; ++r) db_acc += dlf[r * kDLFP + tid];
    }
    // dW[:, tile] += z^T . round(dlogits), K = the chunk's rows
    if (j0w < Jr) {
#pragma unroll
      for (int k0 = 0; k0 < kMR; k0 += 16) {
        uint32_t bb[8][2];
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) frag_b(bb[ni], dlT, kDLTP, ni * 8, k0, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t a[4];
          frag_a_trans(a, zs, JP, j0w + mi * 16, k0, lane);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) mma_16816(acc3[mi][ni], a, bb[ni]);
        }
      }
    }
    if (c == n_ch - 1) {  // the tile's last chunk: its dW and db out
      float* dwo = dw_out + split * J * V;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0w + mi * 16 + gq + ((e >= 2) ? 8 : 0);
            const int v = v0 + ni * 8 + 2 * q + (e & 1);
            if (j < J && v < V) dwo[(size_t)j * V + v] = acc3[mi][ni][e];
          }
        }
      }
      if (tid < kVT && v0 + tid < V) db_out[split * V + v0 + tid] = db_acc;
    }
  }
}

}  // namespace zb_ring
