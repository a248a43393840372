// The TMA's bulk copies from global to shared memory, completing on an
// mbarrier (sm_90), shared by the kernels that stage rows this way: the
// LSTM backward (lstm_bwd.cu) and the band joint's kernel B
// (band_fused.cu).
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

}  // namespace tma_bulk
