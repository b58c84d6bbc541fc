// K4 uvwt_interp: trilinear + time interpolation of u, v, w and T at located
// parcel positions, one thread per parcel.
//
// Replaces the Pallas slab kernel mptrac_tpu/ops/slab_interp.py:_kernel in
// mode "uvwt" (launched by interp_uvwt / uvwt_from_loc; math _trilerp_T).
// Plain version: ops/slab_interp.py:uvwt_interp_plain.
//
// What bounds it on an H100: bytes.  A parcel streams 36 bytes (int32 cell,
// four weights, four results, coalesced) and gathers 8 corners x 32 bytes
// from the per-cell table [npl, nx, ny, 8] (127.5 MB at 361x181x61, more than
// the L2).  The table is level-major like the sort key and a node is one
// 32-byte sector, so sorted neighbours share sectors; a thread gathers its
// own corners, so any order is served, only slower.

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) uvwt_kernel(
    const float* __restrict__ table, const int* __restrict__ cell,
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wz, const float* __restrict__ wt,
    float* __restrict__ out, long long n, int nx, int ny, int npl) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = cell[i];
  int sx, sy, sz;
  mptrac::clamped_strides(c0, nx, ny, npl, sx, sy, sz);
  float c[8][8];
  mptrac::load_cell_corners(table, c0, sx, sy, sz, c);
  const float x = wx[i], y = wy[i], z = wz[i], t = wt[i];
  out[i] = mptrac::trilerp_time(c, 0, 3, x, y, z, t);
  out[n + i] = mptrac::trilerp_time(c, 1, 4, x, y, z, t);
  out[2 * n + i] = mptrac::trilerp_time(c, 2, 5, x, y, z, t);
  out[3 * n + i] = mptrac::trilerp_time(c, 6, 7, x, y, z, t);
}

}  // namespace

// out [4, n] = (u, v, w, T).  Launches on `stream`, allocates nothing, does
// not synchronise; returns cudaGetLastError().
extern "C" int uvwt_interp(const float* table, const int* cell,
                           const float* wx, const float* wy, const float* wz,
                           const float* wt, float* out, long long n, int nx,
                           int ny, int npl, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  uvwt_kernel<<<dim3((unsigned)nblk), block, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      table, cell, wx, wy, wz, wt, out, n, nx, ny, npl);
  return (int)cudaGetLastError();
}
