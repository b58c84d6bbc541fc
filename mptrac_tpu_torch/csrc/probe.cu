// P1-P3: the measurement probes of perf/probe.py, as kernels for this card.
//
// Replace the three Pallas kernels of the JAX package's perf/probe.py:
//   P1 probe_lane   <- _coarse_kernel (launched by _coarse_call, :203)
//   P2 probe_grid   <- the doubling kernel of probe_grid (:241)
//   P3 probe_small  <- the small-table gather of probe_small (:276)
// Plain versions: perf/probe.py:probe_lane_plain, probe_grid_plain,
// probe_small_plain.  Each probe measures one property of the card that a
// kernel design rests on; none is called by a module of the model.
//
// What bounds them on an H100: bytes, all three.
//   P1 reads 64 floats a parcel from the transposed table [64, ncell_pad],
//      one float from each of 64 rows ncell_pad apart.  Neighbouring threads
//      hold neighbouring cells (the parcels are sorted), so a warp's 32 loads
//      of one row fall into a few 32-byte sectors; the rows themselves lie
//      ncell_pad * 4 bytes apart (16 MB at 360x181x61).  The TPU kernel's
//      slab copy, 128-lane windows, group size G, slab width S and served flag
//      exist because a TPU gathers only within 128 lanes of a vector register;
//      here a thread gathers its own column and every parcel is served.
//   P2 streams 8 bytes an element.  What it shows is not the stream but the
//      cost of a block: the same bytes in nchunk blocks of [8, G*128], the
//      card's counterpart of a TPU grid step.  A large tile (G 32, 64) holds
//      its block's slot for long, and its 8 rows lie ncol apart: 8 streams
//      where a contiguous range is one.  Blocks of 1024 threads, the most a
//      block holds, keep a tile short: G 64 then costs under 1 % more than
//      G 8, where blocks of 256 cost 2 % more.  More float4s in flight a
//      thread, a loop without the division and evict-first hints gave no
//      more (PERF.md section 5).
//   P3 reads 4 bytes and writes 32 bytes an index.  The table (4 KB) sits in
//      shared memory, so the gather itself costs no device memory traffic.

#include <cstdint>

#include "interp_common.cuh"

namespace {

constexpr int LANES = 64;        // rows of the transposed table
constexpr int SMALL_ROWS = 8;    // rows of the small table
constexpr int SMALL_COLS = 128;  // its columns
constexpr int GRID_BLOCK = 1024; // most threads of a P2 block

// out [8, n]: rows 0-2 (u, v, w), 3 T, 4 the served flag (1.0), 5-7 zero.
// The arithmetic is perf/probe.py:_trilerp_T, which is trilerp_time() of
// interp_common.cuh on the lanes corner*6 + (u0,v0,w0,u1,v1,w1) and
// 48 + corner*2 + (t0,t1).
__global__ void __launch_bounds__(256) probe_lane_kernel(
    const float* __restrict__ packT, const int* __restrict__ base,
    const float* __restrict__ w, float* __restrict__ out, long long n,
    long long ncell_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* col = packT + base[i];
  float lane[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) lane[l] = __ldg(col + (size_t)l * ncell_pad);
  float c[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int f = 0; f < 6; ++f) c[k][f] = lane[k * 6 + f];
    c[k][6] = lane[48 + 2 * k];
    c[k][7] = lane[48 + 2 * k + 1];
  }
  const float x = w[i], y = w[n + i], z = w[2 * n + i], t = w[3 * n + i];
  out[i] = mptrac::trilerp_time(c, 0, 3, x, y, z, t);
  out[n + i] = mptrac::trilerp_time(c, 1, 4, x, y, z, t);
  out[2 * n + i] = mptrac::trilerp_time(c, 2, 5, x, y, z, t);
  out[3 * n + i] = mptrac::trilerp_time(c, 6, 7, x, y, z, t);
  out[4 * n + i] = 1.0f;
  out[5 * n + i] = 0.0f;
  out[6 * n + i] = 0.0f;
  out[7 * n + i] = 0.0f;
}

// Block c doubles the tile [8, cp] at columns c*cp of x [8, ncol]; cp is a
// multiple of 128, so every row of a tile starts on a 16-byte boundary.
__global__ void __launch_bounds__(GRID_BLOCK) probe_grid_kernel(
    const float* __restrict__ x, float* __restrict__ out, int cp,
    long long ncol) {
  const int cp4 = cp / 4;
  const size_t col0 = (size_t)blockIdx.x * cp;
  for (int j = threadIdx.x; j < 8 * cp4; j += blockDim.x) {
    const int r = j / cp4, q = j - r * cp4;
    const size_t at = ((size_t)r * ncol + col0) / 4 + q;
    float4 v = __ldg(reinterpret_cast<const float4*>(x) + at);
    v.x = v.x * 2.0f; v.y = v.y * 2.0f; v.z = v.z * 2.0f; v.w = v.w * 2.0f;
    reinterpret_cast<float4*>(out)[at] = v;
  }
}

// out[r, i] = tab[r, idx[i]] for the 8 rows of a table of 128 columns
__global__ void __launch_bounds__(256) probe_small_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    float* __restrict__ out, long long n) {
  __shared__ float s_tab[SMALL_ROWS * SMALL_COLS];
  for (int j = threadIdx.x; j < SMALL_ROWS * SMALL_COLS; j += blockDim.x)
    s_tab[j] = tab[j];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = idx[i];
#pragma unroll
  for (int r = 0; r < SMALL_ROWS; ++r) out[r * n + i] = s_tab[r * SMALL_COLS + k];
}

}  // namespace

// All three launch on `stream`, allocate nothing, do not synchronise and
// return cudaGetLastError().

// packT [64, ncell_pad] f32, base [n] i32 in [0, ncell_pad), w [4, n] f32
// (wx, wy, wz, wt), out [8, n] f32
extern "C" int probe_lane(const float* packT, const int* base, const float* w,
                          float* out, long long n, long long ncell_pad,
                          void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  probe_lane_kernel<<<dim3((unsigned)nblk), block, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      packT, base, w, out, n, ncell_pad);
  return (int)cudaGetLastError();
}

// x, out [8, nchunk * cp] f32, 16-byte aligned; cp a multiple of 128;
// blocks of min(GRID_BLOCK, 2 * cp) threads (a tile holds 2 * cp float4s)
extern "C" int probe_grid(const float* x, float* out, long long nchunk, int cp,
                          void* stream) {
  if (nchunk <= 0) return 0;
  if (nchunk > 2147483647LL || cp <= 0 || cp % 128 != 0 ||
      (reinterpret_cast<std::uintptr_t>(x) |
       reinterpret_cast<std::uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int block = 2 * cp < GRID_BLOCK ? 2 * cp : GRID_BLOCK;
  probe_grid_kernel<<<dim3((unsigned)nchunk), block, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      x, out, cp, nchunk * cp);
  return (int)cudaGetLastError();
}

// tab [8, 128] f32, idx [n] i32 in [0, 128), out [8, n] f32
extern "C" int probe_small(const float* tab, const int* idx, float* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  probe_small_kernel<<<dim3((unsigned)nblk), block, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(tab, idx, out,
                                                                 n);
  return (int)cudaGetLastError();
}
