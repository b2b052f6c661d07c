// Stage clocks of tacotron2_step.cu, for a profiling build only
// (scripts/profile_torch_tacotron2_step.py --stages compiles the kernel with
// -DTACOTRON2_STEP_TIMES, which includes this header): each block's SM clock
// at every grid barrier's arrival and exit, and the card's clock and the SM
// clock at the start and the end of block 0, read back by
// tacotron2_step_times.  The shipped build has no-op marks instead.

#pragma once

#include <cuda_runtime.h>

constexpr int kTimedBlocks = 160;
constexpr int kTimedSteps = 64;
constexpr int kStages = 6;
__device__ long long g_stage_clock[kTimedBlocks][kTimedSteps][kStages][2];
__device__ long long g_calibration[4];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// block's clock at a barrier of `step`: side 0 its arrival, 1 its exit
__device__ __forceinline__ void mark(int step, int stage, int side) {
  if (threadIdx.x == 0 && blockIdx.x < kTimedBlocks && step < kTimedSteps)
    g_stage_clock[blockIdx.x][step][stage][side] = clock64();
}

// block 0's card and SM clocks: slot 0 at the start, 2 at the end
__device__ __forceinline__ void calibrate(int slot) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_calibration[slot] = global_ns();
    g_calibration[slot + 1] = clock64();
  }
}

// The clocks of the last launch: out = g_stage_clock ([160][64][6][2] long
// long), then g_calibration (4 long long).
extern "C" int tacotron2_step_times(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stage_clock, sizeof(g_stage_clock));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + sizeof(g_stage_clock) / sizeof(long long), g_calibration,
                               sizeof(g_calibration));
  return (int)err;
}
