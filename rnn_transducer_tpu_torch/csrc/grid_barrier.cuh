// The grid barrier of the persistent LSTM kernels, shared by the forward
// (lstm_fwd.cu) and the backward (lstm_bwd.cu): one cooperative launch a
// layer, whose blocks hand each step's rounded values to one another
// through an exchange buffer in device memory and meet here once a step.
//
// The barrier comes in two halves (the release / acquire pattern of
// CUTLASS's barrier.h), for a launch whose blocks are all resident, which
// the cooperative launch guarantees. arrive() publishes the block's writes
// of the step; wait() returns once every block has arrived `target` /
// grid-size times. The next step's input loads go between the two: a
// fence before the arrival would wait for them (cooperative_groups'
// grid.sync() fences in the arriving thread), so here the arrival comes
// first and the loads overlap the wait. The counter is a zeroed u32 in
// device memory that only this launch touches.

#pragma once

namespace grid_barrier {

__device__ __forceinline__ void barrier_arrive(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :
                 : "l"(arrived)
                 : "memory");
  }
}

__device__ __forceinline__ void barrier_wait(unsigned int* arrived,
                                             unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(arrived)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

}  // namespace grid_barrier
