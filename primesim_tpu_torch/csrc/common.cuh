// Device helpers shared by the step kernels (the CUDA counterparts of
// primesim_tpu_torch/kernels/layouts.py). All arithmetic that can wrap or
// touch bit 31 goes through uint32_t: signed overflow and 1 << 31 are
// undefined in C++, while the simulator's int32 words rely on wraparound
// (sharer bit 31, directory row deltas).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psim {

// MESI encoding (sim/state.py)
constexpr int I = 0, S = 1, E = 2, M = 3;

__device__ __forceinline__ int popc(int x) { return __popc((uint32_t)x); }

// bit b of a packed sharer word, 0 or 1
__device__ __forceinline__ int bit_at(int word, int b) {
  return (int)(((uint32_t)word >> b) & 1u);
}

// the word with only bit b set (b may be 31)
__device__ __forceinline__ int bit_word(int b) { return (int)(1u << b); }

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// Python/JAX floor semantics for b > 0 (CUDA's / and % truncate)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

}  // namespace psim

extern "C" const char* psim_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
