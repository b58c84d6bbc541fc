// K5 meso_sigma: the 16-point subgrid wind sigma (8 corners x 2 snapshots of
// u, v, w) of each parcel's cell, one thread per parcel.
//
// Replaces the Pallas slab kernel mptrac_tpu/ops/slab_interp.py:_kernel in
// mode "meso" (launched by meso_sigma; math _meso_sigma_T).  Plain version:
// ops/slab_interp.py:meso_sigma_plain.
//
// What bounds it on an H100: bytes.  A parcel streams 16 bytes (int32 cell,
// three results) and gathers 8 x 32 bytes from the per-cell table
// [npl, nx, ny, 8]; sorted parcels of one cell (25 at the flagship's
// density) read the same 8 sectors.  var = msq - mean*mean cancels from ~1e3
// down to ~1, which is why the file is compiled without multiply-add
// contraction: the plain version must round alike.

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) meso_kernel(
    const float* __restrict__ table, const int* __restrict__ cell,
    float* __restrict__ out, long long n, int nx, int ny, int npl) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = cell[i];
  int sx, sy, sz;
  mptrac::clamped_strides(c0, nx, ny, npl, sx, sy, sz);
  float c[8][8];
  mptrac::load_cell_corners(table, c0, sx, sy, sz, c);
  float sig[3];
  mptrac::sigma16(c, sig);
  out[i] = sig[0];
  out[n + i] = sig[1];
  out[2 * n + i] = sig[2];
}

}  // namespace

// out [3, n] = (sigma_u, sigma_v, sigma_w).  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int meso_sigma(const float* table, const int* cell, float* out,
                          long long n, int nx, int ny, int npl,
                          void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  meso_kernel<<<dim3((unsigned)nblk), block, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(table, cell, out, n,
                                                          nx, ny, npl);
  return (int)cudaGetLastError();
}
