// The float32 Squares draws (ops/rng.py), one launch a draw:
//   squares_normal3_kernel  the [3, n] component-major normals of
//                           squares_normal3_f32 (diffusion, the PBL scheme);
//   squares_uniform_kernel  the count uniforms of squares_uniform_f32
//                           (convection's draws);
//   squares_pairs_kernel    the Box-Muller pairs of squares_normal_f32.
//
// Replaces no Pallas kernel: the JAX package's Squares (mptrac_tpu/ops/rng.py)
// is plain jnp, and so is the plain version here (ops/rng.py
// squares_*_f32_plain), which runs the chain as ~25 int64 elementwise passes
// over chunks of RNG_CHUNK counters, each pass a full read and write of 8-byte
// temporaries.
//
// What bounds it on an H100.  A draw is a function of its counter alone, which
// a thread computes from its index: the only bytes are the float32 outputs
// (4 B a draw, 1.21 GB for [3, 100,663,296], 0.36 ms at 3.35 TB/s).  The work
// is the integer chain: a key product and five squarings of 64-bit words, each
// three 32-bit multiply-adds, with a 64-bit add after each; the rotations by
// 32 bits are a swap of the two 32-bit halves, which costs nothing.  With
// logf, sqrtf and cosf after it that is at least ~70 instructions a draw
// (27 integer, 44 float), 0.64 ms for 3.0e8 draws at one instruction a lane
// a cycle: 1.8 times the bytes' time.  So the design keeps every
// intermediate in registers and spends nothing on memory but the output: one
// grid-stride loop with an int64 index, four consecutive draws of one row a
// thread and one 16-byte streaming store (scalar stores on a ragged tail or
// an unaligned row).  The uniforms and the pairs need only the high word, which
// the last squaring does not touch (its result is xored into the low word
// alone), so they skip it.
//
// The chain and the float steps are squares.cuh's, shared with diff_turb.cu;
// sinf, like its logf, sqrtf and cosf, is the CUDA math library's, which
// PyTorch's own kernels call.

#include <cstdint>

#include "squares.cuh"

namespace {

using mptrac::normal3_at;
using mptrac::radius;
using mptrac::squares_hi;
using mptrac::TWO_PI_F;
using mptrac::unit24;

constexpr int BLOCK = 256;

// Stores v[0 .. cnt-1] at out[i0 ..]: one 16-byte store where the four are
// whole and `vec` says the row is 16-byte aligned.
__device__ __forceinline__ void store4(float* out, long long i0, int cnt,
                                       bool vec, const float (&v)[4]) {
  if (vec && cnt == 4) {
    __stcs(reinterpret_cast<float4*>(out + i0),
           make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cnt) __stcs(out + i0 + j, v[j]);
}

// Row c = blockIdx.y of out [3, n]: out[c, p] is the normal of the draw at
// counter ctr + c*total + first + p.
__global__ void __launch_bounds__(BLOCK) squares_normal3_kernel(
    float* __restrict__ out, unsigned long long ctr, long long first,
    long long total, long long n, bool vec) {
  const long long c = blockIdx.y;
  float* row = out + c * n;
  const unsigned long long base =
      ctr + (unsigned long long)(c * total + first);
  const long long stride = 4LL * gridDim.x * BLOCK;
  for (long long i0 = 4LL * ((long long)blockIdx.x * BLOCK + threadIdx.x);
       i0 < n; i0 += stride) {
    const int cnt = n - i0 < 4 ? (int)(n - i0) : 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < cnt ? normal3_at(base + (unsigned long long)(i0 + j)) : 0.f;
    store4(row, i0, cnt, vec, v);
  }
}

// out[i] = the uniform of the draw at counter ctr + start + i, i < count.
__global__ void __launch_bounds__(BLOCK) squares_uniform_kernel(
    float* __restrict__ out, unsigned long long ctr, long long start,
    long long count, bool vec) {
  const unsigned long long base = ctr + (unsigned long long)start;
  const long long stride = 4LL * gridDim.x * BLOCK;
  for (long long i0 = 4LL * ((long long)blockIdx.x * BLOCK + threadIdx.x);
       i0 < count; i0 += stride) {
    const int cnt = count - i0 < 4 ? (int)(count - i0) : 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < cnt ? unit24(squares_hi(base + (unsigned long long)(i0 + j)))
                     : 0.f;
    store4(out, i0, cnt, vec, v);
  }
}

// out[i] = normal g = start + i of the pairs: pair q = g / 2 takes the draws
// at counters ctr + 2q (radius) and ctr + 2q + 1 (phase); an even g is
// r cos(phi), an odd g r sin(phi).  A thread's four normals span two or three
// pairs, each computed once.
__global__ void __launch_bounds__(BLOCK) squares_pairs_kernel(
    float* __restrict__ out, unsigned long long ctr, long long start,
    long long n, bool vec) {
  const long long stride = 4LL * gridDim.x * BLOCK;
  for (long long i0 = 4LL * ((long long)blockIdx.x * BLOCK + threadIdx.x);
       i0 < n; i0 += stride) {
    const int cnt = n - i0 < 4 ? (int)(n - i0) : 4;
    float v[4];
    long long q_last = -1;
    float r = 0.f, phi = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = 0.f;
      if (j >= cnt) continue;
      const long long g = start + i0 + j;
      const long long q = g >> 1;
      if (q != q_last) {
        const unsigned long long c0 = ctr + 2ULL * (unsigned long long)q;
        r = radius(unit24(squares_hi(c0)));
        phi = TWO_PI_F * unit24(squares_hi(c0 + 1ULL));
        q_last = q;
      }
      v[j] = r * ((g & 1) ? sinf(phi) : cosf(phi));
    }
    store4(out, i0, cnt, vec, v);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Blocks of the grid-stride loop over `quads` groups of four: enough for
// eight blocks of 256 threads on every SM, no more than the work needs.
int grid_blocks(long long quads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (quads + BLOCK - 1) / BLOCK;
  const long long most = 8LL * sms;
  return (int)(need < most ? need : most);
}

}  // namespace

// Each launches one kernel on `stream`, allocates nothing, does not
// synchronise and returns cudaGetLastError(); nothing is launched for an empty
// output.  Counters are taken mod 2^64; first, total, start, n and count are
// non-negative (the wrapper checks).

// out [3, n] f32: the columns first .. first+n-1 of a [3, total] draw
extern "C" int squares_normal3(float* out, unsigned long long ctr,
                               long long first, long long total, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  if (first < 0 || total < first + n) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(out);
  const dim3 grid((unsigned)grid_blocks((n + 3) / 4), 3);
  squares_normal3_kernel<<<grid, BLOCK, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      out, ctr, first, total, n, vec);
  return (int)cudaGetLastError();
}

// out [count] f32: the uniforms of counters ctr + start ..
extern "C" int squares_uniform(float* out, unsigned long long ctr,
                               long long start, long long count,
                               void* stream) {
  if (count <= 0) return 0;
  if (start < 0) return (int)cudaErrorInvalidValue;
  squares_uniform_kernel<<<grid_blocks((count + 3) / 4), BLOCK, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      out, ctr, start, count, aligned16(out));
  return (int)cudaGetLastError();
}

// out [n] f32: the normals start .. start+n-1 of the pairs from counter ctr
extern "C" int squares_pairs(float* out, unsigned long long ctr,
                             long long start, long long n, void* stream) {
  if (n <= 0) return 0;
  if (start < 0) return (int)cudaErrorInvalidValue;
  squares_pairs_kernel<<<grid_blocks((n + 3) / 4), BLOCK, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      out, ctr, start, n, aligned16(out));
  return (int)cudaGetLastError();
}
