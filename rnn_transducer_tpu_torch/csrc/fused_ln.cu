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
// Design: one warp per row, eight rows per block. For D <= 512 a lane
// keeps its D/32 values of the row in registers (at most four float4), so
// the forward reads x once and writes y once; the mean and then the
// variance of the centred values (two passes, as the TPU kernel takes
// them) come from warp shuffles over the registers. For D > 512 the lane
// loops over the row and reads it again from L1 / L2 for each pass.
// The backward cannot carry dg and db across a sequential grid as the TPU
// kernel does: blocks run in parallel and in no order. Launch A gives each
// block a fixed range of rows; each warp sums dy xhat and dy over its rows
// in registers, and the block adds its eight warps' sums in warp order
// through shared memory into one partial row per block (for D > 512 each
// warp keeps its own partial row in device memory instead). Launch B adds
// the partial rows in order, one thread per column. No float atomics: two
// runs give the same bits.
//
// What bounds it on the H100: device memory. At N = 6400 rows (B=64 x
// T'=100), D = 512 the forward moves 26.2 MB (7.8 us at 3.35 TB/s) and the
// backward 39.3 MB (11.7 us); the backward's partial rows add ~0.8 MB.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;                // rows in flight per block
constexpr int kMaxVec = 4;               // float4 per lane in registers
constexpr int kMaxRegD = kMaxVec * 128;  // widest row kept in registers
constexpr int kSumThreads = 128;         // launch B: one thread a column
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

// Launch A, D <= 128 * NV: dx of the block's rows [blockIdx.x *
// rows_per_block, + rows_per_block) and the block's partial dg, db row.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows_reg(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ mu,
                const float* __restrict__ rstd, const float* __restrict__ dy,
                float* __restrict__ dx, float* __restrict__ dg_part,
                float* __restrict__ db_part, int N, int D, int rows_per_block,
                bool silu) {
  __shared__ float sg[kWarps][kMaxRegD];
  __shared__ float sb[kWarps][kMaxRegD];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float gv[NV][4], bv[NV][4], acc_g[NV][4], acc_b[NV][4];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c < D) {
      ld4(g + c, gv[k]);
      ld4(b + c, bv[k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_g[k][i] = acc_b[k][i] = 0.0f;
  }
  const size_t r0 = (size_t)blockIdx.x * rows_per_block;
  const size_t r1 = r0 + rows_per_block < (size_t)N ? r0 + rows_per_block
                                                      : (size_t)N;
  for (size_t row = r0 + warp; row < r1; row += kWarps) {
    const float m = mu[row];
    const float r = rstd[row];
    float xh[NV][4], a[NV][4];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c < D) {
        float xv[4], d[4];
        ld4(x + row * D + c, xv);
        ld4(dy + row * D + c, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xh[k][i] = (xv[i] - m) * r;
          const float dc = chain(d[i], xh[k][i], gv[k][i], bv[k][i], silu);
          acc_g[k][i] += dc * xh[k][i];
          acc_b[k][i] += dc;
          a[k][i] = dc * gv[k][i];
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
        st4(dx + row * D + c, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c < D) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sg[warp][c + i] = acc_g[k][i];
        sb[warp][c + i] = acc_b[k][i];
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float tg = 0.0f, tb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tg += sg[w][d];
      tb += sb[w][d];
    }
    dg_part[(size_t)blockIdx.x * D + d] = tg;
    db_part[(size_t)blockIdx.x * D + d] = tb;
  }
}

// Launch A, any D: as ln_bwd_rows_reg, with two walks over each row (the
// row means, then dx) and one partial row per warp, which only that warp's
// lanes touch (each lane its own columns).
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows_loop(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ dg_part,
                 float* __restrict__ db_part, int N, int D,
                 int rows_per_block, bool silu) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t part = (size_t)blockIdx.x * kWarps + warp;
  float* pg = dg_part + part * D;
  float* pb = db_part + part * D;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 4 * lane; c < D; c += 128) {
    st4(pg + c, zero);
    st4(pb + c, zero);
  }
  const size_t r0 = (size_t)blockIdx.x * rows_per_block;
  const size_t r1 = r0 + rows_per_block < (size_t)N ? r0 + rows_per_block
                                                      : (size_t)N;
  for (size_t row = r0 + warp; row < r1; row += kWarps) {
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
        const float a = chain(d[i], xh, gv[i], bv[i], silu) * gv[i];
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
        const float dc = chain(d[i], xh, gv[i], bv[i], silu);
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

// Launch B: dg, db = the partial rows added in order.
__global__ void __launch_bounds__(kSumThreads)
ln_bwd_sum(const float* __restrict__ dg_part,
           const float* __restrict__ db_part, float* __restrict__ dg,
           float* __restrict__ db, int parts, int D) {
  const int d = blockIdx.x * kSumThreads + threadIdx.x;
  if (d >= D) return;
  float tg = 0.0f, tb = 0.0f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) {
    tg += dg_part[(size_t)p * D + d];
    tb += db_part[(size_t)p * D + d];
  }
  dg[d] = tg;
  db[d] = tb;
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

// The rows of partial sums launch A writes: one per block of
// rows_per_block rows for D <= 512, one per warp of it above.
extern "C" int fused_ln_bwd_parts(int N, int D, int rows_per_block) {
  if (N <= 0 || rows_per_block <= 0) return 0;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  return D <= kMaxRegD ? blocks : blocks * kWarps;
}

// dx (N, D), dg and db (D,), all f32, from the forward's x, g, b, mu, rstd
// and the cotangent dy (N, D) f32. dg_part and db_part are scratch of
// fused_ln_bwd_parts(N, D, rows_per_block) rows of D floats each.
extern "C" int fused_ln_bwd(const void* x, const void* g, const void* b,
                            const void* mu, const void* rstd, const void* dy,
                            void* dx, void* dg, void* db, void* dg_part,
                            void* db_part, int N, int D, int rows_per_block,
                            int silu, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_width(N, D) || rows_per_block <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = fused_ln_bwd_parts(N, D, rows_per_block);
  const dim3 grid((unsigned)((N + rows_per_block - 1) / rows_per_block));
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  const float* mp = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const float* dyp = static_cast<const float*>(dy);
  float* dxp = static_cast<float*>(dx);
  float* pg = static_cast<float*>(dg_part);
  float* pb = static_cast<float*>(db_part);
  const bool act = silu != 0;
  if (N > 0) {
    switch (vec_per_lane(D)) {
      case 1:
        ln_bwd_rows_reg<1><<<grid, kWarps * 32, 0, s>>>(
            xp, gp, bp, mp, rp, dyp, dxp, pg, pb, N, D, rows_per_block, act);
        break;
      case 2:
        ln_bwd_rows_reg<2><<<grid, kWarps * 32, 0, s>>>(
            xp, gp, bp, mp, rp, dyp, dxp, pg, pb, N, D, rows_per_block, act);
        break;
      case 3:
        ln_bwd_rows_reg<3><<<grid, kWarps * 32, 0, s>>>(
            xp, gp, bp, mp, rp, dyp, dxp, pg, pb, N, D, rows_per_block, act);
        break;
      case 4:
        ln_bwd_rows_reg<4><<<grid, kWarps * 32, 0, s>>>(
            xp, gp, bp, mp, rp, dyp, dxp, pg, pb, N, D, rows_per_block, act);
        break;
      default:
        ln_bwd_rows_loop<<<grid, kWarps * 32, 0, s>>>(
            xp, gp, bp, mp, rp, dyp, dxp, pg, pb, N, D, rows_per_block, act);
    }
    const cudaError_t ea = cudaGetLastError();
    if (ea != cudaSuccess) return (int)ea;
  }
  ln_bwd_sum<<<(D + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      pg, pb, static_cast<float*>(dg), static_cast<float*>(db), parts, D);
  return (int)cudaGetLastError();
}
