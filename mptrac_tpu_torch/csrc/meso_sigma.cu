// K5 meso_sigma: the 16-point subgrid wind sigma (8 corners x 2 snapshots of
// u, v, w) of each parcel's cell, as two kernels:
//   meso_sigma_table  once per met pair: the sigma of every cell of the grid,
//                     one thread per cell, into a table sigT;
//   meso_sigma        once per step: out[:, i] = sigT[cell[i], :3].
//
// Replaces the Pallas slab kernel mptrac_tpu/ops/slab_interp.py:_kernel in
// mode "meso" (launched by meso_sigma; math _meso_sigma_T).  Plain versions:
// ops/slab_interp.py:sigma_table_plain, meso_sigma_plain.
//
// What bounds it on an H100.  The sigma reads both snapshots of the cell's 8
// corners and no weight, so it is a function of the cell and the met pair
// alone; the flagship holds 25 parcels a cell.  A kernel that gives each
// parcel the whole stencil (16 gathers of 16 bytes, 159 operations and three
// square roots, 64 live registers) repeats 96 % of its work and is held by the
// gather chain's latency at the occupancy those registers allow (3.2x its
// bound).  Here the stencil runs once per cell: consecutive threads are
// consecutive cells, so the corner reads are coalesced rows of the level-major
// table [npl, nx, ny, 8], shared through L1/L2.  What is left per step is a
// gather: 4 bytes of cell in, one table entry, 12 bytes out, a stream bound by
// bytes.  A thread takes 4 parcels (one int4 load, three float4 stores, with
// streaming hints: every byte of them is touched once); the table, which
// sorted neighbours share, goes through the read-only cache.  Where the
// stream is not 16-byte aligned (n not a multiple of 4) each thread takes its
// 4 parcels one by one.
//
// sigT is [ncell, 4] (su, sv, sw, 0): one 16-byte gather a parcel, 63.8 MB at
// 361x181x61.  A planar [3, ncell] table (47.8 MB, inside the 50 MB L2)
// streams as fast in the sorted order, but takes three sectors a parcel where
// this takes one, 2.5x the time in a random order, which the parcels drift
// towards between sorts.  var = msq - mean*mean cancels from ~1e3 down to ~1,
// which is why the file is compiled without multiply-add contraction: the
// plain version must round alike.

#include <cstdint>

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) sigma_table_kernel(
    const float* __restrict__ table, float4* __restrict__ sigT, int nx, int ny,
    int npl) {
  const int ncell = npl * nx * ny;
  const int c0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (c0 >= ncell) return;
  int sx, sy, sz;
  mptrac::clamped_strides(c0, nx, ny, npl, sx, sy, sz);
  float c[8][8];
  mptrac::load_cell_corners(table, c0, sx, sy, sz, c);
  float sig[3];
  mptrac::sigma16(c, sig);
  sigT[c0] = make_float4(sig[0], sig[1], sig[2], 0.0f);
}

// Thread q serves parcels 4q .. 4q+3: with `vec` (n a multiple of 4, cell
// and out 16-byte aligned) by one int4 load and three float4 stores, else one
// by one up to n.
__global__ void __launch_bounds__(256) meso_gather_kernel(
    const float4* __restrict__ sigT, const int* __restrict__ cell,
    float* __restrict__ out, long long n, bool vec) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i0 = 4 * q;
  if (i0 >= n) return;
  if (vec) {
    const long long n4 = n / 4;
    const int4 c = __ldcs(reinterpret_cast<const int4*>(cell) + q);
    const float4 a = __ldg(sigT + c.x), b = __ldg(sigT + c.y),
                 d = __ldg(sigT + c.z), e = __ldg(sigT + c.w);
    float4* o = reinterpret_cast<float4*>(out);
    __stcs(o + q, make_float4(a.x, b.x, d.x, e.x));
    __stcs(o + n4 + q, make_float4(a.y, b.y, d.y, e.y));
    __stcs(o + 2 * n4 + q, make_float4(a.z, b.z, d.z, e.z));
    return;
  }
  const long long end = i0 + 4 < n ? i0 + 4 : n;
  for (long long i = i0; i < end; ++i) {
    const float4 s = __ldg(sigT + __ldcs(cell + i));
    __stcs(out + i, s.x);
    __stcs(out + n + i, s.y);
    __stcs(out + 2 * n + i, s.z);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Both launch on `stream`, allocate nothing, do not synchronise and return
// cudaGetLastError().  sigT [ncell, 4] f32 is 16-byte aligned.

// table [npl, nx, ny, 8] f32 -> sigT, ncell = npl * nx * ny < 2^31
extern "C" int meso_sigma_table(const float* table, float* sigT, int nx,
                                int ny, int npl, void* stream) {
  const long long ncell = (long long)npl * nx * ny;
  if (ncell <= 0) return 0;
  if (ncell > 2147483647LL || !aligned16(sigT))
    return (int)cudaErrorInvalidValue;
  const int block = 256;
  sigma_table_kernel<<<(unsigned)mptrac::grid_blocks(ncell, block), block, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      table, reinterpret_cast<float4*>(sigT), nx, ny, npl);
  return (int)cudaGetLastError();
}

// out [3, n] = (sigma_u, sigma_v, sigma_w) of cell [n] i32 in [0, ncell)
extern "C" int meso_sigma(const float* sigT, const int* cell, float* out,
                          long long n, void* stream) {
  if (n <= 0) return 0;
  if (!aligned16(sigT)) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(cell) && aligned16(out);
  const int block = 256;
  const long long nblk = mptrac::grid_blocks((n + 3) / 4, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  meso_gather_kernel<<<dim3((unsigned)nblk), block, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(sigT), cell, out, n, vec);
  return (int)cudaGetLastError();
}
