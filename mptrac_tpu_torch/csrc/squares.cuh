// The float32 Squares draws of ops/rng.py as device functions: the chain of
// one counter and the float steps that make a uniform or a normal of it.
//
// Included by squares_rng.cu (the draws, one launch a draw) and diff_turb.cu
// (the turbulent diffusion, which draws its three normals in registers).
//
// The arithmetic is unsigned long long: its wrap is the uint64 wrap that the
// plain version's int64 chain imitates.  The float steps are those of the
// plain version in its order (every file that includes this header is
// compiled with -fmad=false, so none is contracted), and logf, sqrtf and
// cosf are the CUDA math library's, which PyTorch's own kernels call.

#pragma once

#include <cuda_runtime.h>

namespace mptrac {

constexpr unsigned long long SQUARES_KEY = 0xC8E4FD154CE32F6DULL;
// 2 pi rounded to float32, as the plain version's float32 product rounds it
constexpr float TWO_PI_F = (float)6.283185307179586;
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float TWO_M25 = 2.98023223876953125e-08f;  // 2^-25

__device__ __forceinline__ unsigned long long rot32(unsigned long long x) {
  return (x >> 32) | (x << 32);
}

// The Squares rounds up to t, the word whose high half is the draw's high
// word; x and y come back for the last round.
__device__ __forceinline__ unsigned long long squares_t(
    unsigned long long ctr, unsigned long long& x, unsigned long long& y) {
  x = ctr * SQUARES_KEY;
  y = x;
  const unsigned long long z = y + SQUARES_KEY;
  x = rot32(x * x + y);
  x = rot32(x * x + z);
  x = rot32(x * x + y);
  const unsigned long long t = x * x + z;
  x = rot32(t);
  return t;
}

// The 64 output bits of the draw at counter ctr.
__device__ __forceinline__ unsigned long long squares64(
    unsigned long long ctr) {
  unsigned long long x, y;
  const unsigned long long t = squares_t(ctr, x, y);
  return t ^ ((x * x + y) >> 32);
}

// The high word of the draw at counter ctr.
__device__ __forceinline__ unsigned int squares_hi(unsigned long long ctr) {
  unsigned long long x, y;
  return (unsigned int)(squares_t(ctr, x, y) >> 32);
}

// The uniform in [0, 1) of a word's top 24 bits.
__device__ __forceinline__ float unit24(unsigned int w) {
  return (float)(w >> 8) * TWO_M24;
}

// The Box-Muller radius of a uniform, floored at 2^-25 as torch.clamp does.
__device__ __forceinline__ float radius(float u) {
  return sqrtf(-2.0f * logf(fmaxf(u, TWO_M25)));
}

// The normal of squares_normal3_f32 at counter ctr: the radius from the high
// word's top 24 bits, the phase from the low word's.
__device__ __forceinline__ float normal3_at(unsigned long long ctr) {
  const unsigned long long r = squares64(ctr);
  return radius(unit24((unsigned int)(r >> 32))) *
         cosf(TWO_PI_F * unit24((unsigned int)r));
}

}  // namespace mptrac
