// The joints' products on a ring of W^T chunks, on the tensor cores
// (sm_90): the dz backward of a joint for its two users, each with its own
// row policy: the band joint's kernel A (band_fused.cu, K6-A: the band's
// rows, dg_w) and the fused joint's kernel A (joint_bwd.cu, K2-A: the
// B T (U+1) cells, a dz scratch that ordered sums reduce to df and dg);
// and the forward log-probs of both joints, each with a forward row
// policy of its own: the band joint's (band_fused.cu, K6-fwd: BandRowsF,
// the band's rows) and the fused joint's (joint_fwd.cu, K1: JointRowsF,
// the B T (U+1) cells). Over N rows of
// z = tanh(f[f row] + g[g row]) and W (J, V) bf16:
//   logits = round(z) . W + bias                    (fp32 acc.)
//   dz     = round(dlogits) . W^T                   (fp32 acc., backward)
//   base   = max + log(sum_v exp(logits[v] - max)),
//   lp_blank = logits[blank] - base, lp_y = logits[label] - base
//                                                   (forward)
// The backward's users differ in each row's sidecars (label, log-sum-exp,
// loss cotangents), in how dlogits follows from them, and in what becomes
// of a row's dz: a row policy, a small struct with
//   __device__ long long f_row(long long r) const;   // z's f row
//   __device__ long long g_row(long long r) const;   // z's g row
//   __device__ void load(long long row, float (&s)[kSideWords]) const;
//   __device__ float dlogit(const float (&s)[kSideWords], float x, int v,
//                           int blank) const;
//   __device__ void store_dz(long long row, int j0,
//                            const float (&dz)[8][2]) const;
// (`s` holds the row's sidecars, an int as its bits; x is the logit with
// the bias added, v its column; store_dz receives a thread's 16 values of
// a row, dz[n][e] at column j0 + 8 n + e, and stores those below J).
// Both policies multiply by (1 - z^2) with z recomputed in f32 and write
// the row's dz (K6-A into dg_w, K2-A into its scratch); they issue all
// their loads before their first store, so that they overlap (the
// compiler cannot move a load past a store it does not know to be
// elsewhere). The forward's row policy has f_row and g_row, and
//   __device__ int label(long long r) const;         // the row's label
//   __device__ void store(long long row, float lp_blank, float lp_y,
//                         float base) const;
// (a label outside [0, V) picks 0: lp_y = -base; K1's policy stores
// -1e30 for a negative label, the cells at u = U).
//
// Two launches for each. `build_wt` writes wt = W^T, (ceil(V / kVC) kVC,
// pitch_j(J)) bf16, once a call: row v holds W[:, v], zero past V rows and
// past J columns, so a chunk of kVC columns of W is one contiguous run of
// kVC * pitch_j(J) elements (66,560 bytes at J = 512). Then the main
// kernel: a block owns kMR = 64 rows. It builds round(z) for them once
// into shared memory (zA, row-major; `build_z`, kZBatch groups of 8
// values a thread with their loads in flight together) and loads their
// sidecars (the forward: their labels) once, then walks V in chunks of
// kVC columns, which thread 0 issues into a two-slot ring
// (tma_bulk::Ring2: one TMA bulk copy a chunk, the next chunk's in flight
// under this chunk's products). Per chunk both bodies take
//   logits (kMR, kVC) = zA . W[:, chunk] on mma.sync (`chunk_logits`),
//   warp w rows 16 (w % 4) .., columns 32 (w / 4) .., the B fragments
//   straight from the slot (frag_b: the slot is n-major, j contiguous), k
//   from 0 in steps of 16: the forward's logits are the ones kernel A
//   recomputes, bit for bit.
// `ring_body`, the backward: dz (kMR, J) f32 stays in registers: warp w
// owns j = 64 w .. 64 w + 63, 4 m-tiles by 8 n-tiles, 128 floats a
// thread. Per chunk, after the logits:
//   the policy's dlogits in registers, zero past V and past N, rounded
//   into dlA (kMR, kVC) bf16;
//   dz += dlA . W[:, chunk]^T on mma.sync, W's B fragments (k = v,
//   n = j) from the same slot by ldmatrix.trans (frag_b_trans).
// Then the policy's epilogue receives each row's dz from the registers.
// Each dz element is summed by one thread over V in chunk order.
// `fwd_body`, the forward: each thread keeps, for its two rows, a running
// max and sum of exp over its 8 columns a chunk (bias added, columns past
// V at -inf) and the logit of the blank or the row's label column where
// it holds one, all in registers; one block barrier a chunk (the slot's
// release). After the last chunk the 4 lanes of a row combine by shuffles
// and the two column halves through shared memory, in a fixed order, and
// one thread a row hands base, lp_blank and lp_y to the policy.
// Both bodies give the same bits on every run. No float atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"
#include "tma_bulk.cuh"

namespace wt_ring {

using bf16 = __nv_bfloat16;
using joint_mma::frag_a;
using joint_mma::frag_b;
using joint_mma::frag_b_trans;
using joint_mma::kMR;
using joint_mma::mma_16816;
using joint_mma::pitch_j;
using joint_mma::round_up;

constexpr int kThreads = 256;
constexpr int kMaxJ = 512;
constexpr int kVC = 64;          // V columns a chunk
constexpr int kDLP = kVC + 8;    // bf16 pitch of dlA (36 words: 4 mod 32)
constexpr int kSideWords = 5;    // sidecar words a row, as zb_ring's
constexpr int kWtTile = 64;      // the W^T pass: 64 x 64 tiles
constexpr int kZBatch = 4;       // groups of 8 z values a thread loads at once
constexpr int kFwdWords = 4;     // the forward's partial of a row a column
                                 // half: max, sum of exp, the two picks
static_assert(kThreads == joint_mma::kMmaThreads, "one block shape");

// Rows of wt: V rounded up to whole chunks.
__host__ __device__ inline long long wt_rows(int V) {
  return (long long)round_up(V, kVC);
}

// Shared bytes of a ring block: ring [2][kVC][JP], zA [kMR][JP], dlA
// [kMR][kDLP], sidecars [kSideWords][kMR], f and g rows [2][kMR] (int),
// two mbarriers. Every region is a multiple of 16 bytes.
inline size_t ring_bytes(int J) {
  return (size_t)2 * kVC * pitch_j(J) * 2 + (size_t)kMR * pitch_j(J) * 2
         + (size_t)kMR * kDLP * 2 + (size_t)kSideWords * kMR * 4
         + (size_t)2 * kMR * 4 + 2 * sizeof(unsigned long long);
}

// The shapes the ring takes (W bf16): 16 <= J <= 512, J % 16 == 0, V even.
inline bool shapes_ok(int J, int V) {
  return J >= 16 && J <= kMaxJ && J % 16 == 0 && V >= 2 && V % 2 == 0;
}

// Whether the caller's layout (ops/rnnt_band_fused.bwd_a_layout) is the
// kernel's: wt's rows and the block's shared bytes.
inline bool layout_ok(int J, int V, long long n_wt_rows,
                      long long smem_bytes) {
  return shapes_ok(J, V) && n_wt_rows == wt_rows(V) &&
         smem_bytes == (long long)ring_bytes(J);
}

// Shared bytes of a forward block: ring [2][kVC][JP], zA [kMR][JP], the
// column halves' partials [2][kFwdWords][kMR] f32, labels, f and g rows
// [3][kMR] (int), two mbarriers. Every region is a multiple of 16 bytes.
inline size_t fwd_ring_bytes(int J) {
  return (size_t)2 * kVC * pitch_j(J) * 2 + (size_t)kMR * pitch_j(J) * 2
         + (size_t)2 * kFwdWords * kMR * 4 + (size_t)3 * kMR * 4
         + 2 * sizeof(unsigned long long);
}

// Whether the caller's layout (ops/rnnt_band_fused.fwd_layout) is the
// forward's: wt's rows and the block's shared bytes.
inline bool fwd_layout_ok(int J, int V, long long n_wt_rows,
                          long long smem_bytes) {
  return shapes_ok(J, V) && n_wt_rows == wt_rows(V) &&
         smem_bytes == (long long)fwd_ring_bytes(J);
}

// wt[v][j] = W[j][v] for v < V, j < J; zero elsewhere in (wt_rows(V), JP).
// Block (x, y) of a (wt_rows(V) / kWtTile, ceil(JP / kWtTile)) grid moves
// a 64 x 64 tile through shared memory: W's rows read and wt's rows
// written by consecutive threads. The values move as their bits (bf16
// zero is all zero bits).
__device__ __forceinline__ void build_wt(const bf16* __restrict__ w,
                                         bf16* __restrict__ wt, int J, int V,
                                         int JP) {
  __shared__ uint16_t t[kWtTile][kWtTile + 2];  // 33 words a row
  const uint16_t* src = reinterpret_cast<const uint16_t*>(w);
  uint16_t* dst = reinterpret_cast<uint16_t*>(wt);
  const int v0 = blockIdx.x * kWtTile;
  const int j0 = blockIdx.y * kWtTile;
  for (int idx = threadIdx.x; idx < kWtTile * kWtTile; idx += blockDim.x) {
    const int jj = idx / kWtTile;
    const int vv = idx - jj * kWtTile;
    const int j = j0 + jj;
    const int v = v0 + vv;
    t[jj][vv] = (j < J && v < V) ? src[(size_t)j * V + v] : (uint16_t)0;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kWtTile * kWtTile; idx += blockDim.x) {
    const int vv = idx / kWtTile;
    const int jj = idx - vv * kWtTile;
    if (j0 + jj < JP) dst[(size_t)(v0 + vv) * JP + j0 + jj] = t[jj][vv];
  }
}

// Launches `kernel`, a __global__ (w, wt, J, V, JP) around build_wt, on
// its grid for W (J, V) into wt of n_wt_rows rows (which must be
// wt_rows(V)); returns cudaErrorInvalidValue for a shape or layout that is
// not the kernel's, else the launch's error.
template <class Kernel>
inline int launch_wt(Kernel kernel, const bf16* w, bf16* wt, int J, int V,
                     long long n_wt_rows, int device, cudaStream_t stream) {
  if (!shapes_ok(J, V) || n_wt_rows != wt_rows(V)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int JP = pitch_j(J);
  const dim3 grid((unsigned)(n_wt_rows / kWtTile),
                  (unsigned)((JP + kWtTile - 1) / kWtTile));
  kernel<<<grid, kThreads, 0, stream>>>(w, wt, J, V, JP);
  return (int)cudaGetLastError();
}

// round(z) of a block's kMR rows into zA (row-major, pitch JP), zero past
// the rows (fo_s[r] < 0); columns past J are left as they are. Thread t
// converts groups of 8 consecutive j of a row (two float4 of f and two of
// g; consecutive threads on consecutive groups), kZBatch groups' loads
// issued before their tanhf.
__device__ __forceinline__ void build_z(bf16* zA, int JP,
                                        const float* __restrict__ f,
                                        const float* __restrict__ g,
                                        const int* fo_s, const int* go_s,
                                        int J) {
  const int groups = J / 8;  // J % 16 == 0
  const int n = kMR * groups;
  for (int base = threadIdx.x; base < n; base += kThreads * kZBatch) {
    float4 a[kZBatch][2], b[kZBatch][2];
#pragma unroll
    for (int u = 0; u < kZBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / groups;
      const int j = (idx - r * groups) * 8;
      if (idx < n && fo_s[r] >= 0) {
        const float4* fp =
            reinterpret_cast<const float4*>(f + (size_t)fo_s[r] * J + j);
        const float4* gp =
            reinterpret_cast<const float4*>(g + (size_t)go_s[r] * J + j);
        a[u][0] = __ldg(fp);
        a[u][1] = __ldg(fp + 1);
        b[u][0] = __ldg(gp);
        b[u][1] = __ldg(gp + 1);
      } else {
        a[u][0] = a[u][1] = b[u][0] = b[u][1] = make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kZBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= n) continue;
      const int r = idx / groups;
      const int j = (idx - r * groups) * 8;
      const float x[8] = {a[u][0].x + b[u][0].x, a[u][0].y + b[u][0].y,
                          a[u][0].z + b[u][0].z, a[u][0].w + b[u][0].w,
                          a[u][1].x + b[u][1].x, a[u][1].y + b[u][1].y,
                          a[u][1].z + b[u][1].z, a[u][1].w + b[u][1].w};
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // a row past the block's rows has x = 0: tanh(0) = 0
        const __nv_bfloat162 p = __halves2bfloat162(
            __float2bfloat16_rn(tanhf(x[2 * c])),
            __float2bfloat16_rn(tanhf(x[2 * c + 1])));
        o[c] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(zA + (size_t)r * JP + j) = out;
    }
  }
}

// logits of rows 16 mt .., columns 32 nh .. of a chunk into acc (acc[ni]:
// the n-tile of columns 32 nh + 8 ni ..): zA . W[:, chunk] over k = 0, 16,
// .. J - 16 in that order, A's fragments from zA (pitch JP), B's straight
// from the slot `ws` (n-major, j contiguous). Both bodies call it, so the
// forward's logits are the ones kernel A recomputes.
__device__ __forceinline__ void chunk_logits(float (&acc)[4][4],
                                             const bf16* zA, const bf16* ws,
                                             int JP, int J, int mt, int nh,
                                             int lane) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;
  }
  for (int k0 = 0; k0 < J; k0 += 16) {
    uint32_t a[4];
    frag_a(a, zA, JP, mt * 16, k0, lane);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      uint32_t bb[2];
      frag_b(bb, ws, JP, nh * 32 + ni * 8, k0, lane);
      mma_16816(acc[ni], a, bb);
    }
  }
}

// The main kernel's body, for a __global__ of kThreads threads and
// ring_bytes(J) bytes of dynamic shared memory `smem`, one block an SM;
// block b owns rows b * kMR .. of N. f and g are z's (., J) f32 rows.
template <class Rows>
__device__ __forceinline__ void ring_body(
    unsigned char* smem, const float* __restrict__ f,
    const float* __restrict__ g, const Rows& rows_p,
    const bf16* __restrict__ wt, const float* __restrict__ bias, long long N,
    int J, int V, int blank) {
  const int JP = pitch_j(J);
  const int Jr = round_up(J, 64);
  bf16* zA = reinterpret_cast<bf16*>(smem) + (size_t)2 * kVC * JP;
  bf16* dlA = zA + (size_t)kMR * JP;
  float* side = reinterpret_cast<float*>(dlA + kMR * kDLP);  // [k][kMR]
  int* fo_s = reinterpret_cast<int*>(side + kSideWords * kMR);
  int* go_s = fo_s + kMR;
  const tma_bulk::Ring2 ring{
      smem, (unsigned int)(kVC * JP * sizeof(bf16)),
      static_cast<unsigned int>(__cvta_generic_to_shared(go_s + kMR))};

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int mt = warp % 4;        // logits: rows 16 mt ..
  const int nh = warp / 4;        // logits: columns 32 nh ..
  const int j0w = warp * 64;      // dz: columns j0w .. j0w + 63
  const int r_lo = mt * 16 + gq;  // the thread's logits rows r_lo, r_lo + 8

  const long long r0 = (long long)blockIdx.x * kMR;
  const int rows = (int)min((long long)kMR, N - r0);
  const int n_ch = (V + kVC - 1) / kVC;

  if (tid == 0) {
    ring.init();
    ring.issue(0, wt);
  }
  if (tid < kMR) {
    const long long row = r0 + tid;
    float s[kSideWords];
    if (tid < rows) {
      rows_p.load(row, s);
      fo_s[tid] = (int)rows_p.f_row(row);
      go_s[tid] = (int)rows_p.g_row(row);
    } else {
#pragma unroll
      for (int k = 0; k < kSideWords; ++k) s[k] = 0.0f;
      fo_s[tid] = -1;
      go_s[tid] = -1;
    }
#pragma unroll
    for (int k = 0; k < kSideWords; ++k) side[k * kMR + tid] = s[k];
  }
  __syncthreads();
  build_z(zA, JP, f, g, fo_s, go_s, J);

  float dz[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dz[mi][ni][e] = 0.0f;
    }
  }
  for (int i = 0; i < n_ch; ++i) {
    const int v0 = i * kVC;
    const bf16* ws = ring.slot<const bf16>(i);
    // chunk i-1 is consumed: its slot and dlA (at i = 0: zA and the
    // sidecars are written, the mbarriers initialised)
    __syncthreads();
    if (tid == 0 && i + 1 < n_ch) {
      ring.issue(i + 1, wt + (size_t)(i + 1) * kVC * JP);
    }
    float bias_r[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + nh * 32 + ni * 8 + 2 * q + e;
        bias_r[ni][e] = (v < V) ? bias[v] : 0.0f;
      }
    }
    ring.wait(i);

    float acc[4][4];
    chunk_logits(acc, zA, ws, JP, J, mt, nh, lane);
    // round(dlogits) into dlA, zero past V and past N
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const bool ok = r < rows;
      float s[kSideWords];
#pragma unroll
      for (int k = 0; k < kSideWords; ++k) s[k] = side[k * kMR + r];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = nh * 32 + ni * 8 + 2 * q;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + col + e;
          d[e] = (ok && v < V) ? rows_p.dlogit(s, acc[ni][2 * h + e]
                                                      + bias_r[ni][e],
                                               v, blank)
                               : 0.0f;
        }
        *reinterpret_cast<__nv_bfloat162*>(dlA + r * kDLP + col) =
            __halves2bfloat162(__float2bfloat16_rn(d[0]),
                               __float2bfloat16_rn(d[1]));
      }
    }
    __syncthreads();
    // dz[:, j0w ..] += dlA . W[j0w .., chunk]^T, K = the chunk's columns
    if (j0w < Jr) {
      const int kmax = min(kVC, round_up(V - v0, 16));
      for (int k0 = 0; k0 < kmax; k0 += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) frag_a(a[mi], dlA, kDLP, mi * 16, k0, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[2][2];
          frag_b_trans(bb, ws, JP, j0w + np * 16, k0, lane);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_16816(dz[mi][2 * np], a[mi], bb[0]);
            mma_16816(dz[mi][2 * np + 1], a[mi], bb[1]);
          }
        }
      }
    }
  }
  // each row's dz to the policy: the thread's 16 values of row r, at
  // columns j0w + 2 q + 8 n + e
  if (j0w >= J) return;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + gq + 8 * h;
      if (r >= rows) continue;
      float d[8][2];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        d[ni][0] = dz[mi][ni][2 * h];
        d[ni][1] = dz[mi][ni][2 * h + 1];
      }
      rows_p.store_dz(r0 + r, j0w + 2 * q, d);
    }
  }
}

// (m, s) <- the pair of the union of two sets of logits, each given by
// its max m and its sum of exp(x - m) s (an empty set: m = -inf, s = 0).
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -CUDART_INF_F) return;
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// The forward's body, for a __global__ of kThreads threads and
// fwd_ring_bytes(J) bytes of dynamic shared memory `smem`, one block an
// SM; block b owns rows b * kMR .. of N. f and g are z's (., J) f32 rows.
template <class Rows>
__device__ __forceinline__ void fwd_body(
    unsigned char* smem, const float* __restrict__ f,
    const float* __restrict__ g, const Rows& rows_p,
    const bf16* __restrict__ wt, const float* __restrict__ bias, long long N,
    int J, int V, int blank) {
  const int JP = pitch_j(J);
  bf16* zA = reinterpret_cast<bf16*>(smem) + (size_t)2 * kVC * JP;
  float* part = reinterpret_cast<float*>(zA + (size_t)kMR * JP);
  int* lab_s = reinterpret_cast<int*>(part + 2 * kFwdWords * kMR);
  int* fo_s = lab_s + kMR;
  int* go_s = fo_s + kMR;
  const tma_bulk::Ring2 ring{
      smem, (unsigned int)(kVC * JP * sizeof(bf16)),
      static_cast<unsigned int>(__cvta_generic_to_shared(go_s + kMR))};

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int mt = warp % 4;        // rows 16 mt ..
  const int nh = warp / 4;        // columns 32 nh .. of a chunk
  const int r_lo = mt * 16 + gq;  // the thread's rows r_lo, r_lo + 8

  const long long r0 = (long long)blockIdx.x * kMR;
  const int rows = (int)min((long long)kMR, N - r0);
  const int n_ch = (V + kVC - 1) / kVC;

  if (tid == 0) {
    ring.init();
    ring.issue(0, wt);
  }
  if (tid < kMR) {
    const long long row = r0 + tid;
    const bool ok = tid < rows;
    lab_s[tid] = ok ? rows_p.label(row) : -1;
    fo_s[tid] = ok ? (int)rows_p.f_row(row) : -1;
    go_s[tid] = ok ? (int)rows_p.g_row(row) : -1;
  }
  __syncthreads();
  build_z(zA, JP, f, g, fo_s, go_s, J);
  const int lab[2] = {lab_s[r_lo], lab_s[r_lo + 8]};

  // per row h: running max, sum of exp(x - max), the blank's and the
  // label's logit where this thread holds their column (else 0)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float s[2] = {0.0f, 0.0f};
  float pb[2] = {0.0f, 0.0f};
  float py[2] = {0.0f, 0.0f};
  for (int i = 0; i < n_ch; ++i) {
    const int v0 = i * kVC;
    const bf16* ws = ring.slot<const bf16>(i);
    // chunk i-1 is consumed: its slot (at i = 0: zA and the labels are
    // written, the mbarriers initialised)
    __syncthreads();
    if (tid == 0 && i + 1 < n_ch) {
      ring.issue(i + 1, wt + (size_t)(i + 1) * kVC * JP);
    }
    float bias_r[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + nh * 32 + ni * 8 + 2 * q + e;
        bias_r[ni][e] = (v < V) ? bias[v] : 0.0f;
      }
    }
    ring.wait(i);

    float acc[4][4];
    chunk_logits(acc, zA, ws, JP, J, mt, nh, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4][2];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + nh * 32 + ni * 8 + 2 * q + e;
          x[ni][e] = -CUDART_INF_F;
          if (v < V) {
            x[ni][e] = acc[ni][2 * h + e] + bias_r[ni][e];
            if (v == blank) pb[h] = x[ni][e];
            if (v == lab[h]) py[h] = x[ni][e];
          }
          mloc = fmaxf(mloc, x[ni][e]);
        }
      }
      const float mn = fmaxf(m[h], mloc);
      if (mn != -CUDART_INF_F) {
        float sum = 0.0f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += expf(x[ni][e] - mn);
        }
        s[h] = s[h] * expf(m[h] - mn) + sum;
        m[h] = mn;
      }
    }
  }
  // the 4 lanes of a row (xor 1, then 2), then lane q = 0 writes its
  // half's partial; a pick is held by one lane of one half, 0 elsewhere
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[h], off);
      lse_merge(m[h], s[h], mo, so);
      pb[h] += __shfl_xor_sync(0xffffffffu, pb[h], off);
      py[h] += __shfl_xor_sync(0xffffffffu, py[h], off);
    }
  }
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = part + nh * kFwdWords * kMR + r_lo + 8 * h;
      p[0] = m[h];
      p[kMR] = s[h];
      p[2 * kMR] = pb[h];
      p[3 * kMR] = py[h];
    }
  }
  __syncthreads();
  // one thread a row: half 0, then half 1
  if (tid < rows) {
    const float* p0 = part + tid;
    const float* p1 = p0 + kFwdWords * kMR;
    float mr = p0[0], sr = p0[kMR];
    lse_merge(mr, sr, p1[0], p1[kMR]);
    const float base = mr + logf(sr);
    rows_p.store(r0 + tid, (p0[2 * kMR] + p1[2 * kMR]) - base,
                 (p0[3 * kMR] + p1[3 * kMR]) - base, base);
  }
}

}  // namespace wt_ring
