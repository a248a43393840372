// Greedy RNN-T decoding in one launch, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/decode/greedy_pallas.py `greedy_decode_fused`
// (kernel `_greedy_kernel`, cell `_cell`): the whole greedy loop of one
// utterance inside one program, for a one-layer LSTM prediction network.
//
// Computes, for utterance b with len = lens[b] encoder frames and
// f = enc_out @ enc_proj + b_enc (B, T, J) f32 computed by the caller:
//   (h, c) = 0; (g, h, c) = pred_step(blank)
//   t = u = 0
//   until t >= len or u >= U_max:
//     z = rd(tanh(f[b, t] + g))
//     logits = z @ W_out + b_out;  k = first argmax
//     if k != blank: tokens[b, u] = k; (g, h, c) = pred_step(k); u += 1
//     else: t += 1
// with pred_step(k): e = rd(embed[k]);
//   gates = (e @ W_ih + rd(h) @ W_hh) + b;  the i, f, g, o cell in f32;
//   g = rd(h) @ W_pred + b_pred.
// rd() rounds an activation to the compute dtype (bf16 or f32) and keeps it
// as float; the weights stay f32, as the JAX kernel's `jnp.dot(bf16, f32)`
// promotes to f32. tokens is (B, U_max) int32, blank past the last token;
// steps[b] counts the iterations utterance b ran.
//
// What the port changes, with the same results: the loop of an utterance
// stops once it is done (the JAX kernel runs T + U_max iterations and
// leaves a finished utterance unchanged), the prediction network runs only
// on an emission (the JAX kernel computes it every iteration and selects),
// V is not padded to the TPU's lane width, and k == V (no logit above
// -FLT_MAX) is taken as blank.
//
// Design: one thread-block cluster of C blocks per utterance (the plan of
// decode/greedy_fused.py `cluster_plan`: C = 16), two launches a call.
// `greedy_pack_kernel` first writes the f32 weights block-major into a
// scratch, so that what block r reads is one contiguous run each:
//   G_r  max(E, H) rows, 8U columns: W_ih at its 4U gate columns n, H+n,
//        2H+n, 3H+n for its U = H / C units n, then W_hh at the same;
//   P_r  H rows, JU = J / C columns: W_pred at its joint units;
//   O_r  J rows, vc = ceil(V / C) columns: W_out at its vocab columns
//        [r vc, min(V, (r+1) vc)).
// Each is stored column by column in chunks of R rows (a resident one is one
// chunk): a column's R values in a row, as float4 groups whose positions are
// XOR-swizzled (`swz`), so that a thread reads its column with 16-byte loads
// and 8 neighbouring threads meet 8 distinct bank quads. W_ih's columns are
// zero past E rows, W_hh's past H.
// Then `greedy_cluster_kernel`: block r keeps O_r (and P_r, where the plan
// finds room beside a deep ring) resident in shared memory for the launch,
// loaded by one TMA bulk copy each. A blank step needs no cluster barrier:
// every block forms z over all J from its own copy of g and of the frame's f
// row (prefetched into shared memory by TMA bulk copies two frames ahead, where
// the plan finds room), takes the logits and the first-index argmax of its own
// columns, and each warp sends its best (key, index) (the key an unsigned in
// the floats' order, so that a warp reduces with two redux.sync) into its slot
// of every block's candidate array with st.async, which completes its bytes on
// the receiving block's mbarrier of that step's parity. Every warp waits on its
// own block's barrier and reduces the slots itself. The arrays and barriers
// alternate by step parity: a block sends step s + 2 only after it holds every
// block's candidates of step s + 1, which each sent after reading its slots of
// step s. While some warps run the logits' chains, the others form the next
// frame's z, which after a blank step is that step's z. An emission streams G_r
// (and P_r where it is not resident) through a ring of TMA bulk copies (the
// ring's first chunks are issued as soon as the ring is free, before the next
// emission is known); W_ih's and W_hh's columns, two chains a gate, run side by
// side on 8U threads. It updates the block's own units' c and rd(h), scatters
// rd(h) into every block (double-buffered by emission parity, as a block may
// still read the old h), meets the cluster at barrier.cluster, forms its JU
// columns of g, scatters them, and meets the cluster again. Where O_r does not
// fit (J = 1024, V = 2048: 512 KB a block), it streams through the same ring
// every step: slower, the same results. Where one wave cannot hold the batch,
// cluster c takes the c-th longest utterance.
//
// Every output column is one thread's in-order fmaf chain over k, the order of
// the plain loop, and the gates keep `(a + r) + b` and the cell its `__f*_rn`
// products: every logit, gate and g has the same bits as the one-block kernel
// this one replaced, and the argmax's (value, first index) order is total, so
// the tokens and steps are the same at f32 and bf16.
//
// What bounds it (bench_greedy_step.py splits a step by clock64 stamps; on an
// NVIDIA H100 80GB HBM3 at 700 W): a blank step is a chain of J dependent fmaf
// from shared memory (about 4,100 cycles at J = 512, twice the fmaf's own
// latency) and the candidates' exchange; an emission streams 8U max(E, H) + H
// JU floats (576 KB at libri100) into each block from L2, at about 23 bytes a
// cycle a block, and runs chains of max(E, H) and H fmaf. The bound by
// operations (2 J V a step, 2 ((E + H) 4H + H J) an emission, at the f32 rate)
// is far below either: the loop is a chain of dependent steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "tma_bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = 8;

__device__ __forceinline__ float round_cd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct Params {
  const float* f;
  const int* lens;
  const float* embed;
  const float* w_ih;
  const float* w_hh;
  const float* b;
  const float* wp;
  const float* bp;
  const float* wo;
  const float* bo;
  int* tokens;
  int* steps;
  int B, T, E, H, J, V, U_max, blank;
  bool bf16;
};

// The cluster plan of decode/greedy_fused.py `cluster_plan`.
struct Plan {
  const float* packed;  // C blocks of block_floats, written by the pack
  int C;                // blocks a cluster
  int U, JU, vc;        // units, joint units, vocab columns a block
  int cw;               // warps a block that own vocab columns
  bool wo_res, wp_res;  // O_r, P_r resident in shared memory
  int fs;               // f rows in shared memory: 3 (prefetched), or 0
                        // (read from global memory, no z a frame ahead)
  int rg, rp, ro;       // rows a chunk of G_r, P_r, O_r
  int slots;            // the ring's slots
  int slot_bytes;       // a slot's bytes
};

__host__ __device__ inline size_t r16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// A segment of `rows` rows and `cols` columns in chunks of R rows: chunk
// c holds each column's rows c R .. c R + R - 1 (zero past `rows`), as
// groups of 4 rows, group g of column n at position g ^ swz(n, R / 4).
__host__ __device__ inline size_t seg_floats(int rows, int cols, int R) {
  return (size_t)((rows + R - 1) / R) * cols * R;
}

// The swizzle of column n's groups: 8 threads that read group g of 8
// neighbouring columns with 16-byte loads meet 8 distinct bank quads (a
// column of one group is not swizzled).
__host__ __device__ inline int swz(int n, int groups) {
  return groups >= 8 ? (n & 7)
                     : groups == 4 ? ((n >> 1) & 3)
                                   : groups == 2 ? ((n >> 2) & 1) : 0;
}

// Floats of a block's packed weights: G_r, then P_r, then O_r.
__host__ __device__ inline size_t off_p(int E, int H, const Plan& q) {
  return seg_floats(max(E, H), 8 * q.U, q.rg);
}
__host__ __device__ inline size_t off_o(int E, int H, const Plan& q) {
  return off_p(E, H, q) + seg_floats(H, q.JU, q.rp);
}
__host__ __device__ inline size_t block_floats(int E, int H, int J,
                                               const Plan& q) {
  return off_o(E, H, q) + seg_floats(J, q.vc, q.ro);
}

// Byte offsets of the regions of a block's dynamic shared memory, each a
// multiple of 16 bytes; decode/greedy_fused.py `cluster_plan` computes the
// same total.
struct Layout {
  size_t mbar, row, cand, z, g, f, hr, e, c, bg, ga, pa, bp, la, bo, wo, wp,
      ring, total;
};

__host__ __device__ inline Layout layout(int E, int H, int J, const Plan& q) {
  Layout L;
  size_t o = 0;
  // mbarriers: f 3, loads 2, candidates 2, ring
  L.mbar = o;  o += r16((size_t)(7 + q.slots) * 8);
  L.row = o;   o += 16;                                // the utterance
  L.cand = o;  o += r16((size_t)2 * q.C * q.cw * 8);
  L.z = o;     o += r16((size_t)J * 4);
  L.e = o;     o += r16((size_t)max(E, q.fs ? J : 0) * 4);  // or z's other
  L.g = o;     o += r16((size_t)J * 4);
  L.f = o;     o += q.fs * r16((size_t)J * 4);
  L.hr = o;    o += 2 * r16((size_t)H * 4);
  L.c = o;     o += r16((size_t)q.U * 4);
  L.bg = o;    o += r16((size_t)4 * q.U * 4);
  L.ga = o;    o += r16((size_t)8 * q.U * 4);
  L.pa = o;    o += r16((size_t)q.JU * 4);
  L.bp = o;    o += r16((size_t)q.JU * 4);
  L.la = o;    o += r16((size_t)q.vc * 4);
  L.bo = o;    o += r16((size_t)q.vc * 4);
  L.wo = o;    o += q.wo_res ? (size_t)J * q.vc * 4 : 0;
  L.wp = o;    o += q.wp_res ? (size_t)H * q.JU * 4 : 0;
  L.ring = o;  o += (size_t)q.slots * q.slot_bytes;
  L.total = o;
  return L;
}

// ------------------------------- the pack --------------------------------

__global__ void __launch_bounds__(kThreads)
greedy_pack_kernel(const float* __restrict__ w_ih,
                   const float* __restrict__ w_hh,
                   const float* __restrict__ wp, const float* __restrict__ wo,
                   float* __restrict__ packed, int E, int H, int J, int V,
                   Plan q) {
  const int U4 = 4 * q.U;
  const size_t bf = block_floats(E, H, J, q);
  const size_t op = off_p(E, H, q), oo = off_o(E, H, q);
  const size_t total = bf * q.C;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int r = (int)(i / bf);
    size_t o = i % bf;
    const int seg = o < op ? 0 : o < oo ? 1 : 2;
    o -= seg == 0 ? 0 : seg == 1 ? op : oo;
    const int cols = seg == 0 ? 2 * U4 : seg == 1 ? q.JU : q.vc;
    const int R = seg == 0 ? q.rg : seg == 1 ? q.rp : q.ro;
    const size_t chunk = (size_t)cols * R;
    const int c = (int)(o / chunk), n = (int)(o % chunk / R);
    const int pos = (int)(o % R);
    const int k = c * R + 4 * ((pos / 4) ^ swz(n, R / 4)) + pos % 4;
    float v = 0.0f;
    if (seg == 0) {
      const int qq = n % U4, col = (qq / q.U) * H + r * q.U + qq % q.U;
      if (n < U4 && k < E) v = w_ih[(size_t)k * 4 * H + col];
      if (n >= U4 && k < H) v = w_hh[(size_t)k * 4 * H + col];
    } else if (seg == 1) {
      if (k < H) v = wp[(size_t)k * J + r * q.JU + n];
    } else {
      const int col = r * q.vc + n;
      if (k < J && col < V) v = wo[(size_t)k * V + col];
    }
    packed[i] = v;
  }
}

// --------------------------- the cluster kernel --------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the remote stores before it
// are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `local` (this block's shared memory) in
// the block of rank `rank`.
__device__ __forceinline__ unsigned remote(const void* local, unsigned rank) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local)), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// The shared::cluster address of this block's mbarrier `mbar` (a
// shared::cta address) in the block of rank `rank`.
__device__ __forceinline__ unsigned remote_bar(unsigned mbar, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(mbar), "r"(rank));
  return r;
}

// A remote 8-byte store that completes its bytes on the receiving block's
// mbarrier `rbar`: the receiver waits on its own barrier, no cluster
// barrier needed.
__device__ __forceinline__ void st_async(unsigned addr, unsigned long long v,
                                         unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(v), "r"(rbar)
      : "memory");
}

// The single arrival of an mbarrier's phase, which then completes once
// `bytes` have landed on it.
__device__ __forceinline__ void expect_bytes(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(mbar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float chain_fma(float acc, const float4& a,
                                           const float4& w) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// Groups of 4 rows whose loads a chain keeps in flight ahead of its fmaf.
constexpr int kLag = 8;

// acc continued over rows [0, 4 groups) of a column of a chunk (`col`, in
// shared memory, its groups swizzled by sw), with x[k] the row's
// coefficient (x 16-byte aligned): one in-order fmaf chain. Each group's
// loads are issued kLag groups before its fmaf, so that the chain runs
// near the fmaf's latency, not the loads'.
__device__ __forceinline__ float chain(float acc, const float* x,
                                       const float* col, int groups,
                                       int sw) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* c4 = reinterpret_cast<const float4*>(col);
  int g = 0;
  if (groups >= kLag) {
    float4 xr[kLag], wr[kLag];
#pragma unroll
    for (int j = 0; j < kLag; ++j) {
      xr[j] = x4[j];
      wr[j] = c4[j ^ sw];
    }
    for (g = kLag; g + kLag <= groups; g += kLag) {
#pragma unroll
      for (int j = 0; j < kLag; ++j) {
        acc = chain_fma(acc, xr[j], wr[j]);
        xr[j] = x4[g + j];
        wr[j] = c4[(g + j) ^ sw];
      }
    }
#pragma unroll
    for (int j = 0; j < kLag; ++j) acc = chain_fma(acc, xr[j], wr[j]);
  }
  for (; g < groups; ++g) acc = chain_fma(acc, x4[g], c4[g ^ sw]);
  return acc;
}

// A logit's key: unsigned, in the order of the floats, -0 equal to +0
// and NaN below every float, as the argmax compares them (the larger
// value wins; a NaN never does).
__device__ __forceinline__ unsigned order_key(float v) {
  if (!(v == v)) return 0u;
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (key, index) with the larger key, the smaller index on a tie: a total
// order on the pairs a block can offer, so any order of reduction gives
// the same pair.
__device__ __forceinline__ void better(unsigned& k, int& i, unsigned k2,
                                       int i2) {
  if (k2 > k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

// The warp's best (key, index), in every lane: the largest key, then the
// smallest index that holds it.
__device__ __forceinline__ void warp_best(unsigned& k, int& i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, k);
  i = (int)__reduce_min_sync(0xffffffffu, k == m ? (unsigned)i : ~0u);
  k = m;
}

// order_key(-FLT_MAX): the key of a block or warp that owns no column
constexpr unsigned kNoKey = 0x00800000u;

// The ring: `slots` slots of `slot_bytes`, each filled by one TMA bulk
// copy that completes on the slot's own mbarrier. The chunks of the whole
// launch are numbered in order (seq); chunk seq uses slot seq % slots, on
// phase (seq / slots) & 1 of its barrier. A stream is a run of chunks that
// starts at `base`: `prime` issues its first `slots` chunks, `acquire(i)`
// waits for its chunk i, `release(i)` ends every thread's reads of it (a
// block barrier) and issues chunk i + slots.
struct Ring {
  unsigned char* base_ptr;
  unsigned mbar0;
  int slots, slot_bytes;

  __device__ __forceinline__ float* slot(unsigned seq) const {
    return reinterpret_cast<float*>(base_ptr +
                                    (size_t)(seq % slots) * slot_bytes);
  }
  // One bulk copy into slot seq % slots. Only the shared-memory proxy
  // fence: the block's reads of the slot's last chunk (ordered before this
  // by a barrier) come before the copy's writes. The global sources were
  // written by earlier launches, which the launch order already orders.
  __device__ __forceinline__ void issue(unsigned seq, const float* src,
                                        unsigned bytes) const {
    const unsigned mbar = mbar0 + 8 * (seq % slots);
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(slot(seq)));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :
                 : "r"(mbar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :
        : "r"(dst), "l"(src), "r"(bytes), "r"(mbar)
        : "memory");
  }
  __device__ __forceinline__ void wait(unsigned seq) const {
    unsigned phase = (seq / slots) & 1u;
    tma_bulk::mbar_wait(mbar0 + 8 * (seq % slots), phase);
  }
};

// A stream of up to two segments of a block's packed weights, chunk by
// chunk: segment s has n[s] chunks of cols[s] columns by per[s] rows.
struct Stream {
  const float* src[2];
  int cols[2], per[2], n[2];
  int total;

  __device__ void add(int s, const float* p, int rows, int c, int R) {
    src[s] = p;
    cols[s] = c;
    per[s] = R;
    n[s] = (rows + R - 1) / R;
  }
  __device__ void issue(const Ring& ring, unsigned base, int i) const {
    const int s = i < n[0] ? 0 : 1;
    const size_t chunk = (size_t)cols[s] * per[s];
    ring.issue(base + i, src[s] + (s == 0 ? i : i - n[0]) * chunk,
               (unsigned)(chunk * 4));
  }
  __device__ void prime(const Ring& ring, unsigned base) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < min(ring.slots, total); ++i) issue(ring, base, i);
    }
  }
  __device__ const float* acquire(const Ring& ring, unsigned base,
                                  int i) const {
    ring.wait(base + i);
    return ring.slot(base + i);
  }
  __device__ void release(const Ring& ring, unsigned base, int i) const {
    __syncthreads();
    if (threadIdx.x == 0 && i + ring.slots < total) {
      issue(ring, base, i + ring.slots);
    }
  }
};

struct Smem {
  unsigned mbar;  // shared address: f slots 0-2, loads 3-4, candidates
                  // 5-6, ring 7..
  unsigned long long* cand;  // [2][C * cw]
  float *z, *g, *f, *hr, *e, *c, *bg, *ga, *pa, *bp, *la, *bo, *wo, *wp;
  unsigned char* ring;
};

struct Block {
  Smem s;
  Ring ring;
  Ring fring;             // the f rows: row t in slot t % 3
  Stream emit, out;       // [G; P unless resident], O unless resident
  unsigned seq;           // the first chunk of the next stream
  int rank, ne;           // cluster rank, emissions so far
};

// One step of the prediction network on token k, for the whole cluster:
// g, the block's c, and both h buffers' next one. The emission stream is
// primed on entry; it is primed again on exit where O_r is resident.
__device__ __forceinline__ void emission(const Params& p, const Plan& q,
                                         Block& x, int k) {
  const Smem& s = x.s;
  const int U4 = 4 * q.U;
  for (int i = threadIdx.x; i < p.E; i += kThreads) {
    s.e[i] = round_cd(p.embed[(size_t)k * p.E + i], p.bf16);
  }
  for (int n = threadIdx.x; n < 2 * U4; n += kThreads) s.ga[n] = 0.0f;
  for (int n = threadIdx.x; n < q.JU; n += kThreads) s.pa[n] = 0.0f;
  __syncthreads();
  const float* h_in = s.hr + (size_t)(x.ne & 1) * p.H;
  float* h_out = s.hr + (size_t)((x.ne + 1) & 1) * p.H;
  // the gates: column n < 4U sums a over W_ih's rows, column 4U + n sums
  // r over W_hh's, the two chains side by side
  const Stream& st = x.emit;
  for (int i = 0; i < st.n[0]; ++i) {
    const float* w = st.acquire(x.ring, x.seq, i);
    const int k0 = i * q.rg;
    for (int n = threadIdx.x; n < 2 * U4; n += kThreads) {
      const bool a = n < U4;
      const int rows = min(q.rg, (a ? p.E : p.H) - k0);
      if (rows > 0) {
        s.ga[n] = chain(s.ga[n], (a ? s.e : h_in) + k0, w + n * q.rg,
                        rows / 4, swz(n, q.rg / 4));
      }
    }
    st.release(x.ring, x.seq, i);
  }
  // the cell of the block's units; rd(h) into every block's h_out
  for (int j = threadIdx.x; j < q.U; j += kThreads) {
    float gt[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = a * q.U + j;
      gt[a] = (s.ga[n] + s.ga[U4 + n]) + s.bg[n];
    }
    const float gi = sigmoid(gt[0]);
    const float gf = sigmoid(gt[1]);
    const float gg = tanhf(gt[2]);
    const float go = sigmoid(gt[3]);
    // no contraction into fmaf: the products round as in the plain version
    const float c_new = __fadd_rn(__fmul_rn(gf, s.c[j]), __fmul_rn(gi, gg));
    s.c[j] = c_new;
    const float h = round_cd(__fmul_rn(go, tanhf(c_new)), p.bf16);
    float* dst = h_out + x.rank * q.U + j;
    for (int r = 0; r < q.C; ++r) st_remote(remote(dst, r), h);
  }
  cluster_sync();
  // the block's joint units of g = rd(h) W_pred + b_pred, into every block
  if (q.wp_res) {
    for (int n = threadIdx.x; n < q.JU; n += kThreads) {
      s.pa[n] = chain(0.0f, h_out, s.wp + n * p.H, p.H / 4,
                      swz(n, p.H / 4));
    }
  } else {
    for (int i = st.n[0]; i < st.total; ++i) {
      const float* w = st.acquire(x.ring, x.seq, i);
      const int k0 = (i - st.n[0]) * q.rp, rows = min(q.rp, p.H - k0);
      for (int n = threadIdx.x; n < q.JU; n += kThreads) {
        s.pa[n] = chain(s.pa[n], h_out + k0, w + n * q.rp, rows / 4,
                        swz(n, q.rp / 4));
      }
      st.release(x.ring, x.seq, i);
    }
  }
  for (int n = threadIdx.x; n < q.JU; n += kThreads) {
    const float v = s.pa[n] + s.bp[n];
    float* dst = s.g + x.rank * q.JU + n;
    for (int r = 0; r < q.C; ++r) st_remote(remote(dst, r), v);
  }
  x.seq += st.total;
  ++x.ne;
  cluster_sync();
  if (q.wo_res) st.prime(x.ring, x.seq);
}

__global__ void __launch_bounds__(kThreads, 1)
greedy_cluster_kernel(Params p, Plan q) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block x;
  const Layout L = layout(p.E, p.H, p.J, q);
  Smem& s = x.s;
  s.mbar = static_cast<unsigned>(__cvta_generic_to_shared(smem + L.mbar));
  s.cand = reinterpret_cast<unsigned long long*>(smem + L.cand);
  s.z = reinterpret_cast<float*>(smem + L.z);
  s.g = reinterpret_cast<float*>(smem + L.g);
  s.f = reinterpret_cast<float*>(smem + L.f);
  s.hr = reinterpret_cast<float*>(smem + L.hr);
  s.e = reinterpret_cast<float*>(smem + L.e);
  s.c = reinterpret_cast<float*>(smem + L.c);
  s.bg = reinterpret_cast<float*>(smem + L.bg);
  s.ga = reinterpret_cast<float*>(smem + L.ga);
  s.pa = reinterpret_cast<float*>(smem + L.pa);
  s.bp = reinterpret_cast<float*>(smem + L.bp);
  s.la = reinterpret_cast<float*>(smem + L.la);
  s.bo = reinterpret_cast<float*>(smem + L.bo);
  s.wo = reinterpret_cast<float*>(smem + L.wo);
  s.wp = reinterpret_cast<float*>(smem + L.wp);
  s.ring = smem + L.ring;
  x.ring = Ring{s.ring, s.mbar + 56, q.slots, q.slot_bytes};
  x.fring = Ring{reinterpret_cast<unsigned char*>(s.f), s.mbar, 3, p.J * 4};
  x.rank = (int)cluster_rank();
  x.seq = 0;
  x.ne = 0;
  const int r = x.rank;
  // cluster c decodes the c-th longest utterance (ties: the lower index
  // first), so that where one wave cannot hold the batch the shortest
  // utterances wait, not the longest
  int* row = reinterpret_cast<int*>(smem + L.row);
  const int c = blockIdx.x / q.C;
  for (int i = threadIdx.x; i < p.B; i += kThreads) {
    const int li = p.lens[i];
    int rank = 0;
    for (int j = 0; j < p.B; ++j) {
      const int lj = p.lens[j];
      rank += lj > li || (lj == li && j < i);
    }
    if (rank == c) *row = i;
  }
  __syncthreads();
  const int b = *row;
  const int len = p.lens[b];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int v0 = r * q.vc, nv = max(0, min(q.vc, p.V - v0));
  const int U4 = 4 * q.U;
  const float* pk = q.packed + (size_t)r * block_floats(p.E, p.H, p.J, q);
  x.emit.add(0, pk, max(p.E, p.H), 2 * U4, q.rg);
  x.emit.total = x.emit.n[0];
  if (!q.wp_res) {
    x.emit.add(1, pk + off_p(p.E, p.H, q), p.H, q.JU, q.rp);
    x.emit.total += x.emit.n[1];
  }
  x.out.add(0, pk + off_o(p.E, p.H, q), p.J, q.vc, q.ro);
  x.out.total = x.out.n[0];
  const float* f_b = p.f + (size_t)b * p.T * p.J;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 7 + q.slots; ++i) {
      tma_bulk::mbar_init(s.mbar + 8 * i);
    }
    // the candidates of steps 0 and 1: every block's warps' (key, index)
    expect_bytes(s.mbar + 40, 8 * q.C * q.cw);
    expect_bytes(s.mbar + 48, 8 * q.C * q.cw);
  }
  __syncthreads();
  int f_issued = q.fs ? min(len, 2) - 1 : -1;  // the last f row issued
  if (threadIdx.x == 0) {
    for (int t = 0; t <= f_issued; ++t) {
      x.fring.issue(t, f_b + (size_t)t * p.J, p.J * 4);
    }
    if (q.wo_res) {
      tma_bulk::tma_rows(s.wo, 0, pk + off_o(p.E, p.H, q), 0, 1,
                         (unsigned)((size_t)p.J * q.vc * 4), s.mbar + 24);
    }
    if (q.wp_res) {
      tma_bulk::tma_rows(s.wp, 0, pk + off_p(p.E, p.H, q), 0, 1,
                         (unsigned)((size_t)p.H * q.JU * 4), s.mbar + 32);
    }
  }
  x.emit.prime(x.ring, x.seq);
  int* toks = p.tokens + (size_t)b * p.U_max;
  if (r == 0) {
    for (int i = threadIdx.x; i < p.U_max; i += kThreads) toks[i] = p.blank;
  }
  for (int j = threadIdx.x; j < p.H; j += kThreads) s.hr[j] = 0.0f;
  for (int j = threadIdx.x; j < q.U; j += kThreads) s.c[j] = 0.0f;
  for (int n = threadIdx.x; n < U4; n += kThreads) {
    s.bg[n] = p.b[(n / q.U) * p.H + r * q.U + n % q.U];
  }
  for (int n = threadIdx.x; n < q.JU; n += kThreads) {
    s.bp[n] = p.bp[r * q.JU + n];
  }
  for (int n = threadIdx.x; n < nv; n += kThreads) s.bo[n] = p.bo[v0 + n];
  if (q.wo_res || q.wp_res) {
    unsigned ph = 0;
    if (q.wo_res) tma_bulk::mbar_wait(s.mbar + 24, ph);
    ph = 0;
    if (q.wp_res) tma_bulk::mbar_wait(s.mbar + 32, ph);
  }
  cluster_sync();  // every block runs, and has set its state, before the
                   // first remote store
  emission(p, q, x, p.blank);

  const int NS = q.C * q.cw;
  // the warps past the vocab columns' (where there are any and W_out is
  // resident) form the next frame's z while the others run their chains:
  // after a blank step it is this step's z
  const bool ahead = q.cw < kWarps && q.wo_res && q.fs > 0;
  const int issuer = ahead ? kThreads - 32 : 0;
  // which of them: where the chains' warps leave a scheduler (warp w runs
  // on scheduler w % 4) free, only the warps on the free ones; thread
  // ahead_i of ahead_n, or -1
  const bool spare = q.cw < 4;
  const int ahead_w = spare ? (warp % 4 >= q.cw ? (warp / 4) * (4 - q.cw)
                                                      + warp % 4 - q.cw
                                                : -1)
                            : (warp >= q.cw ? warp - q.cw : -1);
  const int ahead_n = 32 * (spare ? 2 * (4 - q.cw) : kWarps - q.cw);
  const int ahead_i = ahead_w < 0 ? -1 : 32 * ahead_w + lane;
  // z's two buffers: z and, as an emission needs neither, e's
  float* z_cur = s.z;
  float* z_next = s.e;
  bool z_valid = false;
  int t = 0, u = 0, it = 0;
  while (t < len && u < p.U_max) {  // the same in every thread of the cluster
    // f rows go two frames ahead, into the slot of row t - 1, which every
    // thread read before the last cluster barrier
    if (q.fs && f_issued < t + 2 && t + 2 < len) {
      f_issued = t + 2;
      if (threadIdx.x == issuer) {
        x.fring.issue(t + 2, f_b + (size_t)(t + 2) * p.J, p.J * 4);
      }
    }
    if (!q.wo_res) x.out.prime(x.ring, x.seq);
    if (!z_valid) {
      if (q.fs) x.fring.wait(t);
      const float* f_t = q.fs ? x.fring.slot(t) : f_b + (size_t)t * p.J;
      for (int j = threadIdx.x; j < p.J; j += kThreads) {
        z_cur[j] = round_cd(tanhf(f_t[j] + s.g[j]), p.bf16);
      }
      __syncthreads();
    }
    const bool pre = ahead && t + 1 < len;
    unsigned best = kNoKey;
    int best_i = p.V;
    if (q.wo_res) {
      for (int n = threadIdx.x; n < nv; n += kThreads) {
        const float logit =
            chain(0.0f, z_cur, s.wo + n * p.J, p.J / 4, swz(n, p.J / 4))
            + s.bo[n];
        better(best, best_i, order_key(logit), v0 + n);
      }
      if (pre && ahead_i >= 0) {
        x.fring.wait(t + 1);
        const float* f_n = x.fring.slot(t + 1);
        for (int j = ahead_i; j < p.J; j += ahead_n) {
          z_next[j] = round_cd(tanhf(f_n[j] + s.g[j]), p.bf16);
        }
      }
    } else {
      for (int n = threadIdx.x; n < nv; n += kThreads) s.la[n] = 0.0f;
      const Stream& st = x.out;
      for (int i = 0; i < st.total; ++i) {
        const float* w = st.acquire(x.ring, x.seq, i);
        const int k0 = i * q.ro, rows = min(q.ro, p.J - k0);
        for (int n = threadIdx.x; n < nv; n += kThreads) {
          s.la[n] = chain(s.la[n], z_cur + k0, w + n * q.ro, rows / 4,
                          swz(n, q.ro / 4));
        }
        st.release(x.ring, x.seq, i);
      }
      x.seq += st.total;
      for (int n = threadIdx.x; n < nv; n += kThreads) {
        better(best, best_i, order_key(s.la[n] + s.bo[n]), v0 + n);
      }
    }
    unsigned long long* slots = s.cand + (size_t)(it & 1) * NS;
    const unsigned cbar = s.mbar + 40 + 8 * (it & 1);
    if (warp < q.cw) warp_best(best, best_i);
    // every warp is done with the last step's slots before this step's
    // candidates go out, and the next frame's z, formed by the other
    // warps, reaches the chains' warps
    __syncthreads();
    if (warp < q.cw && lane < q.C) {
      st_async(remote(slots + r * q.cw + warp, lane),
               ((unsigned long long)(unsigned)best_i << 32) | best,
               remote_bar(cbar, lane));
    }
    unsigned cphase = (unsigned)(it >> 1) & 1u;
    tma_bulk::mbar_wait(cbar, cphase);
    // armed for step it + 2 before any block can send it: a block sends
    // that step only after it holds this block's candidates of it + 1
    if (threadIdx.x == 0) expect_bytes(cbar, 8 * NS);
    best = kNoKey;
    best_i = p.V;
    for (int i = lane; i < NS; i += 32) {
      const unsigned long long c = slots[i];
      better(best, best_i, (unsigned)c, (int)(c >> 32));
    }
    warp_best(best, best_i);
    const int k = best_i;
    ++it;
    // k == V only if no logit beats -FLT_MAX (all -inf or NaN): taken as
    // blank, as the lock-step decoder takes k >= vocab_size
    if (k != p.blank && k < p.V) {
      if (r == 0 && threadIdx.x == 0) toks[u] = k;
      if (!q.wo_res) x.emit.prime(x.ring, x.seq);
      emission(p, q, x, k);
      z_valid = false;  // g moved
      ++u;
    } else {
      ++t;
      z_valid = pre;  // z_next was formed with this g (and the block
                      // barrier published it)
      if (pre) {  // without f rows z_next is e's room, too short for z
        float* z = z_cur;
        z_cur = z_next;
        z_next = z;
      }
    }
  }
  // no bulk copy is left in flight into this block, and no block leaves
  // while a peer may still write into it (the last three rows' slots were
  // not refilled, so their waits are safe to repeat)
  for (int i = max(f_issued - 2, 0); i <= f_issued; ++i) x.fring.wait(i);
  if (q.wo_res) {
    for (int i = 0; i < min(q.slots, x.emit.total); ++i) {
      x.ring.wait(x.seq + i);
    }
  }
  cluster_sync();
  if (r == 0 && threadIdx.x == 0) p.steps[b] = it;
}

// Whether R rows a chunk suit a segment of `rows` rows: whole groups of 4
// that the swizzle permutes within a column (R / 4 of 1, 2, 4 or a
// multiple of 8), all the rows where the segment is resident.
__host__ __device__ inline bool chunk_ok(int R, int rows, bool resident) {
  const int g = R / 4;
  return R > 0 && R % 4 == 0 && (g <= 2 || g == 4 || g % 8 == 0)
         && (!resident || R == rows);
}

// A plan's fields that follow from the shape and C: the units, joint
// units and vocab columns a block owns, the warps that own those columns.
Plan derive(int H, int J, int V, int C) {
  Plan q{};
  q.C = C;
  if (C > 0) {
    q.U = H / C;
    q.JU = J / C;
    q.vc = (V + C - 1) / C;
    q.cw = std::min(kWarps, (q.vc + 31) / 32);
  }
  return q;
}

// The shape a cluster of C blocks takes.
bool shape_ok(int E, int H, int J, int C) {
  return C >= 1 && C <= kMaxCluster && H % C == 0 && J % C == 0
         && E % 4 == 0;
}

// The plan's fields and the layout a launch needs, checked against what
// the kernel takes; cudaSuccess or cudaErrorInvalidValue.
cudaError_t check_plan(int E, int H, int J, const Plan& q,
                       long long smem_bytes) {
  if (!shape_ok(E, H, J, q.C) || q.slots < 1 || q.slots > kMaxSlots
      || q.slot_bytes % 16 || (q.fs != 0 && q.fs != 3)
      || !chunk_ok(q.rg, std::max(E, H), false)
      || !chunk_ok(q.rp, H, q.wp_res) || !chunk_ok(q.ro, J, q.wo_res)
      || (size_t)q.slot_bytes < (size_t)8 * q.U * q.rg * 4
      || (!q.wp_res && (size_t)q.slot_bytes < (size_t)q.JU * q.rp * 4)
      || (!q.wo_res && (size_t)q.slot_bytes < (size_t)q.vc * q.ro * 4))
    return cudaErrorInvalidValue;
  if ((long long)layout(E, H, J, q).total != smem_bytes)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int B, int C, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      greedy_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(greedy_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The clusters of C blocks of `smem_bytes` that card `device` holds at
// once, into *clusters. Returns 0, or a cudaError_t.
extern "C" int greedy_cluster_occupancy(int C, int smem_bytes, int device,
                                        int* clusters) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = cluster_config(cfg, attr, 1, C, smem_bytes, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters, greedy_cluster_kernel,
                                             &cfg);
}

// Writes the C blocks' packed weights (G_r, P_r, O_r in chunks of g_chunk,
// p_chunk and o_chunk rows; see the top of this file) into `packed`, on
// `stream`. Returns 0, or the launch's cudaError_t.
extern "C" int greedy_pack(const void* w_ih, const void* w_hh, const void* wp,
                           const void* wo, void* packed, int E, int H, int J,
                           int V, int C, int g_chunk, int p_chunk,
                           int o_chunk, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Plan q = derive(H, J, V, C);
  q.rg = g_chunk;
  q.rp = p_chunk;
  q.ro = o_chunk;
  if (!shape_ok(E, H, J, C) || !chunk_ok(g_chunk, std::max(E, H), false)
      || !chunk_ok(p_chunk, H, false) || !chunk_ok(o_chunk, J, false))
    return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  greedy_pack_kernel<<<4 * n_sm, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
      static_cast<const float*>(wp), static_cast<const float*>(wo),
      static_cast<float*>(packed), E, H, J, V, q);
  return (int)cudaGetLastError();
}

// Decodes B utterances, one cluster of C blocks each, on `stream`, from
// the weights that greedy_pack wrote into `packed`, on the plan of
// decode/greedy_fused.py `cluster_plan`. Returns 0, or a cudaError_t: a
// plan the kernel does not take (cudaErrorInvalidValue), a card that holds
// no such cluster (cudaErrorInvalidConfiguration), or the launch's error.
extern "C" int greedy_cluster(const void* f, const void* lens,
                              const void* embed, const void* w_ih,
                              const void* w_hh, const void* b, const void* wp,
                              const void* bp, const void* wo, const void* bo,
                              const void* packed, void* tokens, void* steps,
                              int B, int T, int E, int H, int J, int V,
                              int U_max, int blank, int cd_is_bf16, int C,
                              int wo_resident, int wp_resident, int f_slots,
                              int g_chunk, int p_chunk, int o_chunk,
                              int slots, int slot_bytes, long long smem_bytes,
                              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{static_cast<const float*>(f),     static_cast<const int*>(lens),
           static_cast<const float*>(embed), static_cast<const float*>(w_ih),
           static_cast<const float*>(w_hh),  static_cast<const float*>(b),
           static_cast<const float*>(wp),    static_cast<const float*>(bp),
           static_cast<const float*>(wo),    static_cast<const float*>(bo),
           static_cast<int*>(tokens),        static_cast<int*>(steps),
           B, T, E, H, J, V, U_max, blank, cd_is_bf16 != 0};
  Plan q = derive(H, J, V, C);
  q.packed = static_cast<const float*>(packed);
  q.wo_res = wo_resident != 0;
  q.wp_res = wp_resident != 0;
  q.fs = f_slots;
  q.rg = g_chunk;
  q.rp = p_chunk;
  q.ro = o_chunk;
  q.slots = slots;
  q.slot_bytes = slot_bytes;
  e = check_plan(E, H, J, q, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = cluster_config(cfg, attr, B, C, (int)smem_bytes,
                     static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, greedy_cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, greedy_cluster_kernel, p, q);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
