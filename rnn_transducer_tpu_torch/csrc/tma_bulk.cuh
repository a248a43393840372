// The TMA's bulk copies from global to shared memory, completing on an
// mbarrier (sm_90), shared by the kernels that stage rows this way: the
// LSTM forward and backward (lstm_fwd.cu, lstm_bwd.cu), the joints' kernel B (zb_ring.cuh, for
// band_fused.cu and joint_bwd.cu) and the joints' kernel A and the band
// joint's forward (wt_ring.cuh, for band_fused.cu and joint_bwd.cu), and
// the greedy decode (greedy_fused.cu). The joints' kernels stream their
// chunks through `Ring2`, a two-slot ring.
//
// A copy is issued by one thread after `mbar_init`; every thread that
// reads the copied rows waits with `mbar_wait` on the barrier's phase.
// The TMA reads through L2, never L1, so it sees what other SMs wrote.

#pragma once

#include <cstddef>

namespace tma_bulk {

// Thread 0: make `mbar` an mbarrier that one arrival (with its bytes)
// completes, visible to the TMA. The block synchronises before any thread
// waits on it.
__device__ __forceinline__ void mbar_init(unsigned int mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Thread 0: copy `rows` rows of `row_bytes` from global memory (`src_pitch`
// elements apart) to shared memory (`dst_pitch` apart) with the TMA's bulk
// copies, which complete on the mbarrier `mbar`. Addresses and sizes are
// multiples of 16 bytes. The proxy fences order the copies after the
// generic-proxy accesses before them: other blocks' global writes,
// acquired by this thread, and the warps' reads of the last contents of
// `dst`, ordered before this call by a block barrier.
template <typename W>
__device__ __forceinline__ void tma_rows(W* dst, int dst_pitch, const W* src,
                                         size_t src_pitch, int rows,
                                         unsigned int row_bytes,
                                         unsigned int mbar) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(mbar), "r"(row_bytes * rows)
               : "memory");
  for (int r = 0; r < rows; ++r) {
    const unsigned int d = static_cast<unsigned int>(
        __cvta_generic_to_shared(dst + (size_t)r * dst_pitch));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :
        : "r"(d), "l"(src + (size_t)r * src_pitch), "r"(row_bytes),
          "r"(mbar)
        : "memory");
  }
}

// Every thread: wait for the mbarrier's phase `phase` to complete, then
// flip `phase` to the next one.
__device__ __forceinline__ void mbar_wait(unsigned int mbar,
                                          unsigned int& phase) {
  unsigned int done = 0;
  do {
    asm volatile(
        "{\n .reg .pred q;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
        " selp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(phase)
        : "memory");
  } while (!done);
  phase ^= 1u;
}

// A ring of two equal slots in shared memory, each filled by one bulk copy
// that completes on the slot's own mbarrier (the two 8 bytes apart from
// `mbar0`). Iteration i fills and reads slot i & 1, on the (i / 2)-th
// phase of its barrier. Thread 0 calls `init` (before a block barrier) and
// `issue`; every thread that reads slot i calls `wait(i)` first. A block
// barrier between the warps' last reads of a slot and the `issue` that
// refills it orders the two (tma_rows' proxy fences do the rest).
struct Ring2 {
  unsigned char* base;  // slot 0; slot 1 follows at base + bytes
  unsigned int bytes;   // of a slot: a multiple of 16, as base
  unsigned int mbar0;   // shared address of slot 0's mbarrier

  __device__ __forceinline__ void init() const {
    mbar_init(mbar0);
    mbar_init(mbar0 + 8);
  }
  template <typename T>
  __device__ __forceinline__ T* slot(int i) const {
    return reinterpret_cast<T*>(base + (size_t)(i & 1) * bytes);
  }
  // copy `bytes` contiguous bytes from `src` into slot i & 1
  __device__ __forceinline__ void issue(int i, const void* src) const {
    tma_rows(slot<unsigned char>(i), 0,
             static_cast<const unsigned char*>(src), 0, 1, bytes,
             mbar0 + 8 * (i & 1));
  }
  __device__ __forceinline__ void wait(int i) const {
    unsigned int phase = (unsigned int)(i >> 1) & 1u;
    mbar_wait(mbar0 + 8 * (i & 1), phase);
  }
};

}  // namespace tma_bulk
