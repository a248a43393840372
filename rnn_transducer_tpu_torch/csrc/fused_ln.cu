// LayerNorm over the last axis, with an optional silu epilogue, forward and
// backward, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/fused_ln.py `_fln_call_fwd` (kernel
// `_fwd_kernel`) and `_fln_bwd` (kernel `_bwd_kernel`).
//
// Computes, for every row r of x (N, D) f32 and the vectors g, b (D,) f32:
//   fused_ln_fwd: mu[r]   = mean(x[r])
//                 rstd[r] = rsqrt(mean((x[r] - mu[r])^2) + 1e-6)
//                 y[r]    = (x[r] - mu[r]) * rstd[r] * g + b,
//                           then y * sigmoid(y) under silu
//   fused_ln_bwd: with xhat = (x - mu) * rstd and, under silu, dy chained
//                 through dsilu(y) = s (1 + y (1 - s)), s = sigmoid(y),
//                 at y = xhat * g + b recomputed:
//                 dx[r] = rstd (a - mean(a) - xhat mean(a xhat)),  a = dy g
//                 dg    = sum over rows of dy xhat,  db = sum over rows of dy
// The forward always writes mu and rstd (8 bytes a row against the row's
// 2 KB at D = 512), so serving and training run the same launch.
//
// Layout: row-major and contiguous, D a multiple of 4 (rows are read with
// 16-byte vector loads); any N, no padding of the rows.
//
// Design: one warp per row, eight warps per block. For D <= 512 a lane
// keeps its D/32 values of the row in registers (at most four float4), so
// the forward reads x once and writes y once; the mean and then the
// variance of the centred values (two passes, as the TPU kernel takes
// them) come from warp shuffles over the registers. For D > 512 the lane
// loops over the row and reads it again from L1 / L2 for each pass.
// The backward is one launch. The TPU kernel carries dg and db across a
// sequential grid; here blocks run in parallel and in no order, so each
// block takes an equal share of the rows (a floor or a ceiling of N /
// blocks, blocks = min(N, 264): one wave of two blocks on each of the
// H100's 132 SMs), each warp sums dy xhat and dy over its rows in
// registers (loading a row's x and dy before the last row's sums and
// store), and the block adds its warps' sums in warp order into one
// partial row. The last block of each group of 17 to publish its row (an
// integer ticket after a fence) adds the group's rows in order, and the
// last group adds the group rows in order into dg and db; each last block
// resets its ticket. No float atomics and no second launch: the order of
// every sum is fixed by N, and two runs give the same bits.
//
// What bounds it on the H100: device memory. At N = 6400 rows (B=64 x
// T'=100), D = 512 the forward moves 26.2 MB (7.8 us at 3.35 TB/s) and the
// backward 39.3 MB (11.7 us); the backward's partial rows add ~1.2 MB,
// read from L2 by the last blocks of their groups.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;                // rows in flight per block
constexpr int kMaxVec = 4;               // float4 per lane in registers
constexpr int kMaxRegD = kMaxVec * 128;  // widest row kept in registers
// The backward's blocks (partial rows) a group, added by the group's last
// block; 17 groups of 17 cover the 264 blocks of a wave in one batch of
// loads at each of the two levels.
constexpr int kGroup = 17;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

__device__ __forceinline__ void st4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// y = xhat * g + b, then silu.
__device__ __forceinline__ float ln_out(float xhat, float g, float b,
                                        bool silu) {
  const float y = xhat * g + b;
  return silu ? y * sigmoid(y) : y;
}

// dy chained through silu at the pre-activation y = xhat * g + b.
__device__ __forceinline__ float chain(float dy, float xhat, float g, float b,
                                       bool silu) {
  if (!silu) return dy;
  const float y = xhat * g + b;
  const float s = sigmoid(y);
  return dy * (s * (1.0f + y * (1.0f - s)));
}

// ------------------------------- forward --------------------------------

// D <= 128 * NV: the lane's 4 * NV values of the row stay in registers.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_reg(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ b, float* __restrict__ y,
           float* __restrict__ mu, float* __restrict__ rstd, int N, int D,
           bool silu) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= (size_t)N) return;
  const float* xr = x + row * D;
  float v[NV][4];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c < D) {
      ld4(xr + c, v[k]);
      s += (v[k][0] + v[k][1]) + (v[k][2] + v[k][3]);
    }
  }
  const float m = warp_sum(s) / (float)D;
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (4 * (lane + 32 * k) < D) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[k][i] -= m;
        ss += v[k][i] * v[k][i];
      }
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + kEps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c < D) {
      float gv[4], bv[4], o[4];
      ld4(g + c, gv);
      ld4(b + c, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = ln_out(v[k][i] * r, gv[i], bv[i], silu);
      st4(y + row * D + c, o);
    }
  }
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// Any D: the lane walks the row three times (sum, centred squares, output).
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_loop(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ b, float* __restrict__ y,
            float* __restrict__ mu, float* __restrict__ rstd, int N, int D,
            bool silu) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= (size_t)N) return;
  const float* xr = x + row * D;
  float s = 0.0f;
  for (int c = 4 * lane; c < D; c += 128) {
    float t[4];
    ld4(xr + c, t);
    s += (t[0] + t[1]) + (t[2] + t[3]);
  }
  const float m = warp_sum(s) / (float)D;
  float ss = 0.0f;
  for (int c = 4 * lane; c < D; c += 128) {
    float t[4];
    ld4(xr + c, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) ss += (t[i] - m) * (t[i] - m);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + kEps);
  for (int c = 4 * lane; c < D; c += 128) {
    float t[4], gv[4], bv[4], o[4];
    ld4(xr + c, t);
    ld4(g + c, gv);
    ld4(b + c, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = ln_out((t[i] - m) * r, gv[i], bv[i], silu);
    st4(y + row * D + c, o);
  }
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// ------------------------------- backward -------------------------------

// The rows of block `blk` of `blocks`: [N blk / blocks, N (blk + 1) /
// blocks), so that block sizes differ by one row at most.
__device__ __forceinline__ size_t first_row(int blk, int blocks, int N) {
  return (size_t)N * (size_t)blk / (size_t)blocks;
}

// Acquire the partial rows other blocks published before their ticket:
// loads from L2, never from this SM's L1.
__device__ __forceinline__ float4 ld_part(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Thread 0 of a block whose threads have published its row (each thread's
// fence, then a block barrier): take a ticket of counter `t` (out of `n`
// blocks that add to it) and say whether this block is the counter's
// last, which resets it for the next call.
__device__ __forceinline__ bool last_of(unsigned int* t, unsigned int n) {
  const bool last = atomicAdd(t, 1u) == n - 1;
  if (last) {
    *t = 0u;
    __threadfence();
  }
  return last;
}

// out_g, out_b (D floats each) = the `n` rows at `rows` (2D floats each:
// dg's, then db's) added in row order, each thread over its float4
// columns, a batch of kGroup rows' loads in flight before their adds.
__device__ __forceinline__ void add_rows(const float* rows, int n, int D,
                                         float* out_g, float* out_b) {
  const int cols4 = 2 * D / 4;
  for (int c4 = threadIdx.x; c4 < cols4; c4 += blockDim.x) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p0 = 0; p0 < n; p0 += kGroup) {
      float4 v[kGroup];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        if (p0 + p < n) {
          v[p] = ld_part(rows + (size_t)(p0 + p) * 2 * D + 4 * c4);
        }
      }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        if (p0 + p < n) {
          s.x += v[p].x;
          s.y += v[p].y;
          s.z += v[p].z;
          s.w += v[p].w;
        }
      }
    }
    const int c = 4 * c4;
    float* dst = c < D ? out_g + c : out_b + (c - D);
    *reinterpret_cast<float4*>(dst) = s;
  }
}

// One warp's rows of its block for D <= 128 * NV: dx of each row, and the
// warp's dy xhat and dy sums over them in acc_g / acc_b. Row r + kWarps's x
// and dy are loaded before row r's sums and store, so a warp keeps a row
// in flight behind the one it works on. The per-row arithmetic and the
// lanes' columns (4 (lane + 32 k)) are those of the design before this
// one, so dx keeps its bits.
template <int NV, bool kSilu>
__device__ __forceinline__ void rows_reg(
    const float* __restrict__ x, const float* __restrict__ mu,
    const float* __restrict__ rstd, const float* __restrict__ dy,
    float* __restrict__ dx, const float* sg, const float* sb, size_t r0,
    size_t r1, int D, float (&acc_g)[NV][4], float (&acc_b)[NV][4]) {
  const int lane = threadIdx.x % 32;
  float nx[NV][4], nd[NV][4], nm = 0.0f, nr = 0.0f;
  auto load = [&](size_t row) {
    nm = mu[row];
    nr = rstd[row];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c < D) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(
            x + row * D + c));
        const float4 e = __ldcs(reinterpret_cast<const float4*>(
            dy + row * D + c));
        nx[k][0] = a.x; nx[k][1] = a.y; nx[k][2] = a.z; nx[k][3] = a.w;
        nd[k][0] = e.x; nd[k][1] = e.y; nd[k][2] = e.z; nd[k][3] = e.w;
      }
    }
  };
  if (r0 < r1) load(r0);
  for (size_t row = r0; row < r1; row += kWarps) {
    float xh[NV][4], a[NV][4];
    const float m = nm;
    const float r = nr;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xh[k][i] = nx[k][i];
        a[k][i] = nd[k][i];
      }
    }
    if (row + kWarps < r1) load(row + kWarps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c < D) {
        float gv[4], bv[4];
        ld4(sg + c, gv);
        ld4(sb + c, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xh[k][i] = (xh[k][i] - m) * r;
          const float dc = chain(a[k][i], xh[k][i], gv[i], bv[i], kSilu);
          acc_g[k][i] += dc * xh[k][i];
          acc_b[k][i] += dc;
          a[k][i] = dc * gv[i];
          s1 += a[k][i];
          s2 += a[k][i] * xh[k][i];
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c < D) {
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = r * (a[k][i] - m1 - xh[k][i] * m2);
        __stcs(reinterpret_cast<float4*>(dx + row * D + c),
               make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

// One warp's rows for any D: two walks over each row (the row means, then
// dx), the warp's sums in its own partial row `pw` (2D floats: dg's, then
// db's), which only that warp's lanes touch, each lane its own columns.
template <bool kSilu>
__device__ __forceinline__ void rows_loop(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, const float* __restrict__ mu,
    const float* __restrict__ rstd, const float* __restrict__ dy,
    float* __restrict__ dx, float* pw, size_t r0, size_t r1, int D) {
  const int lane = threadIdx.x % 32;
  float* pg = pw;
  float* pb = pw + D;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 4 * lane; c < D; c += 128) {
    st4(pg + c, zero);
    st4(pb + c, zero);
  }
  for (size_t row = r0; row < r1; row += kWarps) {
    const float m = mu[row];
    const float r = rstd[row];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = 4 * lane; c < D; c += 128) {
      float xv[4], d[4], gv[4], bv[4];
      ld4(x + row * D + c, xv);
      ld4(dy + row * D + c, d);
      ld4(g + c, gv);
      ld4(b + c, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xh = (xv[i] - m) * r;
        const float a = chain(d[i], xh, gv[i], bv[i], kSilu) * gv[i];
        s1 += a;
        s2 += a * xh;
      }
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
    for (int c = 4 * lane; c < D; c += 128) {
      float xv[4], d[4], gv[4], bv[4], ag[4], ab[4], o[4];
      ld4(x + row * D + c, xv);
      ld4(dy + row * D + c, d);
      ld4(g + c, gv);
      ld4(b + c, bv);
      ld4(pg + c, ag);
      ld4(pb + c, ab);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xh = (xv[i] - m) * r;
        const float dc = chain(d[i], xh, gv[i], bv[i], kSilu);
        const float a = dc * gv[i];
        ag[i] += dc * xh;
        ab[i] += dc;
        o[i] = r * (a - m1 - xh * m2);
      }
      st4(dx + row * D + c, o);
      st4(pg + c, ag);
      st4(pb + c, ab);
    }
  }
}

// The whole backward in one launch. Block blk of `blocks` takes rows
// [first_row(blk), first_row(blk + 1)); its warp w the rows w, w + 8, ...
// of them. The block adds its warps' sums in warp order into its partial
// row parts[blk] (dg's D floats, then db's). Blocks form groups of kGroup
// in block order; the last block of a group to publish its row (by the
// group's ticket) adds the group's rows in order into parts[blocks + grp];
// the last group to finish (by the final ticket) adds the group rows in
// order into dg and db. Each last block resets its ticket. NV > 0: the row
// in registers (D <= 128 NV); NV = 0: any D, each warp's sums in wpart.
// kSilu: dy chained through silu.
template <int NV, bool kSilu>
__global__ void __launch_bounds__(kWarps * 32, 2)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, const float* __restrict__ mu,
              const float* __restrict__ rstd, const float* __restrict__ dy,
              float* __restrict__ dx, float* __restrict__ dg,
              float* __restrict__ db, float* parts, float* wpart,
              unsigned int* tickets, int N, int D, int blocks) {
  constexpr int kRegD = NV > 0 ? 128 * NV : 4;
  __shared__ __align__(16) float sg[kRegD];
  __shared__ __align__(16) float sb[kRegD];
  __shared__ __align__(16) float sred[NV > 0 ? kWarps : 1][2 * kRegD];
  __shared__ int last;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int blk = blockIdx.x;
  const size_t r0 = first_row(blk, blocks, N) + warp;
  const size_t r1 = first_row(blk + 1, blocks, N);
  float* part = parts + (size_t)blk * 2 * D;
  if constexpr (NV > 0) {
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      sg[c] = g[c];
      sb[c] = b[c];
    }
    __syncthreads();
    float acc_g[NV][4], acc_b[NV][4];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_g[k][i] = acc_b[k][i] = 0.0f;
    }
    rows_reg<NV, kSilu>(x, mu, rstd, dy, dx, sg, sb, r0, r1, D, acc_g,
                        acc_b);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c < D) {
        st4(&sred[warp][c], acc_g[k]);
        st4(&sred[warp][D + c], acc_b[k]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += sred[w][c];
      part[c] = t;
    }
  } else {
    float* pw = wpart + ((size_t)blk * kWarps + warp) * 2 * D;
    rows_loop<kSilu>(x, g, b, mu, rstd, dy, dx, pw, r0, r1, D);
    __syncthreads();
    const float* pw0 = wpart + (size_t)blk * kWarps * 2 * D;
    for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += pw0[(size_t)w * 2 * D + c];
      part[c] = t;
    }
  }
  // every thread's stores of the row are published before thread 0's
  // ticket
  __threadfence();
  __syncthreads();
  const int groups = (blocks + kGroup - 1) / kGroup;
  const int grp = blk / kGroup;
  const int in_grp = min(kGroup, blocks - grp * kGroup);
  if (threadIdx.x == 0) last = last_of(&tickets[grp], (unsigned)in_grp);
  __syncthreads();
  if (!last) return;
  const float* grp_rows = parts + (size_t)grp * kGroup * 2 * D;
  if (groups == 1) {
    add_rows(grp_rows, in_grp, D, dg, db);
    return;
  }
  float* grp_out = parts + ((size_t)blocks + grp) * 2 * D;
  add_rows(grp_rows, in_grp, D, grp_out, grp_out + D);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = last_of(&tickets[groups], (unsigned)groups);
  __syncthreads();
  if (!last) return;
  add_rows(parts + (size_t)blocks * 2 * D, groups, D, dg, db);
}

int vec_per_lane(int D) { return (D + 127) / 128; }

bool valid_width(int N, int D) { return N >= 0 && D > 0 && D % 4 == 0; }

}  // namespace

// y (N, D) and mu, rstd (N,), all f32, from x (N, D), g and b (D,) f32;
// silu != 0 adds the silu epilogue. Returns 0 or the launch's cudaError_t.
extern "C" int fused_ln_fwd(const void* x, const void* g, const void* b,
                            void* y, void* mu, void* rstd, int N, int D,
                            int silu, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_width(N, D)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((N + kWarps - 1) / kWarps));
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  float* mp = static_cast<float*>(mu);
  float* rp = static_cast<float*>(rstd);
  switch (vec_per_lane(D)) {
    case 1:
      ln_fwd_reg<1><<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, yp, mp, rp, N,
                                                 D, silu != 0);
      break;
    case 2:
      ln_fwd_reg<2><<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, yp, mp, rp, N,
                                                 D, silu != 0);
      break;
    case 3:
      ln_fwd_reg<3><<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, yp, mp, rp, N,
                                                 D, silu != 0);
      break;
    case 4:
      ln_fwd_reg<4><<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, yp, mp, rp, N,
                                                 D, silu != 0);
      break;
    default:
      ln_fwd_loop<<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, yp, mp, rp, N, D,
                                               silu != 0);
  }
  return (int)cudaGetLastError();
}

// Blocks a multiprocessor holds of the backward's kernel for rows of D
// floats (its occupancy), in *per_sm. Returns 0 or the cudaError_t.
extern "C" int fused_ln_bwd_occupancy(int D, int device, int* per_sm) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int t = kWarps * 32;
  switch (D > 0 ? vec_per_lane(D) : 1) {
    case 1:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, ln_bwd_kernel<1, false>, t, 0);
    case 2:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, ln_bwd_kernel<2, false>, t, 0);
    case 3:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, ln_bwd_kernel<3, false>, t, 0);
    case 4:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, ln_bwd_kernel<4, false>, t, 0);
    default:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, ln_bwd_kernel<0, false>, t, 0);
  }
}

// dx (N, D), dg and db (D,), all f32, from the forward's x, g, b, mu, rstd
// and the cotangent dy (N, D) f32, in one launch of `blocks` blocks (1 <=
// blocks <= kGroup^2; the caller fixes it by N alone, so the order of the
// dg / db sums is fixed). Scratch: parts, blocks + ceil(blocks / kGroup)
// rows of 2D floats; wpart, for D > 512 only, blocks * 8 rows of 2D
// floats; tickets, ceil(blocks / kGroup) + 1 zeroed unsigned ints, which
// the launch leaves zeroed (one ticket array a stream: two launches at
// once must not share it). Returns 0 or the launch's cudaError_t.
extern "C" int fused_ln_bwd(const void* x, const void* g, const void* b,
                            const void* mu, const void* rstd, const void* dy,
                            void* dx, void* dg, void* db, void* parts,
                            void* wpart, void* tickets, int N, int D,
                            int blocks, int silu, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_width(N, D) || blocks < 1 || blocks > kGroup * kGroup ||
      (D > kMaxRegD && wpart == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  const float* mp = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const float* dyp = static_cast<const float*>(dy);
  float* dxp = static_cast<float*>(dx);
  float* dgp = static_cast<float*>(dg);
  float* dbp = static_cast<float*>(db);
  float* pp = static_cast<float*>(parts);
  float* wp = static_cast<float*>(wpart);
  unsigned int* tp = static_cast<unsigned int*>(tickets);
  const bool act = silu != 0;
  auto launch = [&](auto kernel) {
    kernel<<<grid, kWarps * 32, 0, s>>>(xp, gp, bp, mp, rp, dyp, dxp, dgp,
                                        dbp, pp, wp, tp, N, D, blocks);
  };
  switch (vec_per_lane(D)) {
    case 1:
      launch(act ? ln_bwd_kernel<1, true> : ln_bwd_kernel<1, false>);
      break;
    case 2:
      launch(act ? ln_bwd_kernel<2, true> : ln_bwd_kernel<2, false>);
      break;
    case 3:
      launch(act ? ln_bwd_kernel<3, true> : ln_bwd_kernel<3, false>);
      break;
    case 4:
      launch(act ? ln_bwd_kernel<4, true> : ln_bwd_kernel<4, false>);
      break;
    default:
      launch(act ? ln_bwd_kernel<0, true> : ln_bwd_kernel<0, false>);
  }
  return (int)cudaGetLastError();
}
