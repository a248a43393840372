// Greedy RNN-T decoding in one program, for Hopper (sm_90a).
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
//     z = rd(tanh(f[b, min(t, max(len - 1, 0))] + g))
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
// and V is not padded to the TPU's lane width.
//
// Design: one block of kThreads threads per utterance; the state (z, g, h,
// c, the gates) lives in shared memory, the f32 weights (13 MB at libri100:
// W_ih and W_hh 4 MB each, W_out 2 MB, embed 2 MB, W_pred 1 MB) are
// streamed from L2 on every use. A thread owns output columns (a vocab
// entry, a gate column, a joint unit) and sums over k in order with fmaf,
// neighbouring threads on neighbouring columns so every weight load is
// coalesced. The argmax is a block reduction that keeps the first index
// of the maximum.
//
// What bounds it on the H100: the B programs are sequential loops of
// T + U steps on B SMs. Each step streams W_out (2 MB) and each emission
// another 9 MB from L2 into one SM, so the time is about (frames *
// 2 MB + tokens * 11 MB) / (one SM's L2 bandwidth). Splitting an
// utterance over a thread-block cluster is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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
  int T, E, H, J, V, U_max, blank;
  bool bf16;
};

// Shared-memory layout, in floats: z[J] g[J] hr[H] c[H] e[E] gates[4H];
// hr is h rounded to the compute dtype, the only form of h any product
// reads.
struct Smem {
  float *z, *g, *hr, *c, *e, *gates;
};

// out[n] = sum_k x[k] * w[k * n_cols + n] over k in [0, K), for this
// thread's columns n; x in shared memory.
__device__ __forceinline__ float column_dot(const float* x, const float* w,
                                            int K, int n_cols, int n) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(x[k], w[(size_t)k * n_cols + n], acc);
  return acc;
}

// One step of the prediction network on token k: updates hr, c, g.
__device__ void pred_step(const Params& p, const Smem& s, int k) {
  const int H4 = 4 * p.H;
  for (int i = threadIdx.x; i < p.E; i += kThreads) {
    s.e[i] = round_cd(p.embed[(size_t)k * p.E + i], p.bf16);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < H4; n += kThreads) {
    const float a = column_dot(s.e, p.w_ih, p.E, H4, n);
    const float r = column_dot(s.hr, p.w_hh, p.H, H4, n);
    s.gates[n] = (a + r) + p.b[n];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.H; j += kThreads) {
    const float gi = sigmoid(s.gates[j]);
    const float gf = sigmoid(s.gates[p.H + j]);
    const float gg = tanhf(s.gates[2 * p.H + j]);
    const float go = sigmoid(s.gates[3 * p.H + j]);
    // no contraction into fmaf: the products round as in the plain version
    const float c_new = __fadd_rn(__fmul_rn(gf, s.c[j]), __fmul_rn(gi, gg));
    s.c[j] = c_new;
    s.hr[j] = round_cd(__fmul_rn(go, tanhf(c_new)), p.bf16);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.J; j += kThreads) {
    s.g[j] = column_dot(s.hr, p.wp, p.H, p.J, j) + p.bp[j];
  }
  __syncthreads();
}

// (value, index) with the larger value, the smaller index on a tie.
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
greedy_fused_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int k_s;
  Smem s;
  s.z = smem;
  s.g = s.z + p.J;
  s.hr = s.g + p.J;
  s.c = s.hr + p.H;
  s.e = s.c + p.H;
  s.gates = s.e + p.E;

  const int b = blockIdx.x;
  const int len = p.lens[b];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* toks = p.tokens + (size_t)b * p.U_max;
  for (int i = threadIdx.x; i < p.U_max; i += kThreads) toks[i] = p.blank;
  for (int j = threadIdx.x; j < p.H; j += kThreads) {
    s.hr[j] = s.c[j] = 0.0f;
  }
  __syncthreads();
  pred_step(p, s, p.blank);

  const float* f_b = p.f + (size_t)b * p.T * p.J;
  const int t_last = max(len - 1, 0);
  int t = 0, u = 0, it = 0;
  while (t < len && u < p.U_max) {  // the same on every thread
    const float* f_t = f_b + (size_t)min(t, t_last) * p.J;
    for (int j = threadIdx.x; j < p.J; j += kThreads) {
      s.z[j] = round_cd(tanhf(f_t[j] + s.g[j]), p.bf16);
    }
    __syncthreads();
    float best = -FLT_MAX;
    int best_i = p.V;
    for (int v = threadIdx.x; v < p.V; v += kThreads) {
      better(best, best_i, column_dot(s.z, p.wo, p.J, p.V, v) + p.bo[v], v);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      better(best, best_i, __shfl_xor_sync(0xffffffffu, best, off),
             __shfl_xor_sync(0xffffffffu, best_i, off));
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = red_v[0];
      int i = red_i[0];
      for (int w = 1; w < kWarps; ++w) better(v, i, red_v[w], red_i[w]);
      k_s = i;
    }
    __syncthreads();
    const int k = k_s;
    ++it;
    // k == V only if no logit beats -FLT_MAX (all -inf or NaN): taken as
    // blank, as the lock-step decoder takes k >= vocab_size
    if (k != p.blank && k < p.V) {
      if (threadIdx.x == 0) toks[u] = k;
      pred_step(p, s, k);  // ends in __syncthreads: k_s is free again
      ++u;
    } else {
      ++t;
    }
  }
  if (threadIdx.x == 0) p.steps[b] = it;
}

}  // namespace

// Decodes B utterances, one block each, on `stream`. Returns 0, or the
// cudaError_t of the launch.
extern "C" int greedy_fused(const void* f, const void* lens,
                            const void* embed, const void* w_ih,
                            const void* w_hh, const void* b, const void* wp,
                            const void* bp, const void* wo, const void* bo,
                            void* tokens, void* steps, int B, int T, int E,
                            int H, int J, int V, int U_max, int blank,
                            int cd_is_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  Params p{static_cast<const float*>(f),     static_cast<const int*>(lens),
           static_cast<const float*>(embed), static_cast<const float*>(w_ih),
           static_cast<const float*>(w_hh),  static_cast<const float*>(b),
           static_cast<const float*>(wp),    static_cast<const float*>(bp),
           static_cast<const float*>(wo),    static_cast<const float*>(bo),
           static_cast<int*>(tokens),        static_cast<int*>(steps),
           T, E, H, J, V, U_max, blank, cd_is_bf16 != 0};
  const size_t smem = (size_t)(2 * J + 2 * H + E + 4 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(greedy_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_fused_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
