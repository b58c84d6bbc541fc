// K7 uvw_rows_interp: trilinear + time interpolation of u, v, w from the
// 8-wide per-node table [ncell, 8] (u0 v0 w0 u1 v1 w1 0 0), corners at
// base + dx*ox + dy*oy + dz, one thread per parcel.
//
// Replaces the Pallas slab kernel mptrac_tpu/ops/pallas_interp.py:_kernel
// (launched by interp_uvw_sorted).  Plain version:
// ops/pallas_interp.py:interp_uvw_plain.
//
// What bounds it on an H100: bytes.  A parcel streams 32 bytes (int32 base,
// a 16-byte row of four weights, three results) and gathers 8 x 32 bytes.
// The table is x-major with the level fastest, so the two dz corners are
// neighbouring sectors.  The TPU kernel copies a slab of the table per block
// of 512 sorted parcels and flags parcels outside it; here a thread gathers
// its own corners, so every parcel in any order is served.  A corner past
// the table's last row (a base on the last node of an axis) reads the last
// row, as an indexed read of the table does in the JAX package.

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) uvw_rows_kernel(
    const float* __restrict__ pack, const int* __restrict__ base,
    const float4* __restrict__ w, float* __restrict__ out, long long n,
    int ox, int oy, long long ncell) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float c[8][8];
  mptrac::load_cell_corners<true>(pack, base[i], ox, oy, 1, c, ncell - 1);
  const float4 wi = w[i];       // (wx, wy, wz, wt)
  float* o = out + 3 * i;
  o[0] = mptrac::trilerp_time(c, 0, 3, wi.x, wi.y, wi.z, wi.w);
  o[1] = mptrac::trilerp_time(c, 1, 4, wi.x, wi.y, wi.z, wi.w);
  o[2] = mptrac::trilerp_time(c, 2, 5, wi.x, wi.y, wi.z, wi.w);
}

}  // namespace

// w [n, 4] = (wx, wy, wz, wt) per row; out [n, 3] = (u, v, w) per row.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int uvw_rows_interp(const float* pack, const int* base,
                               const float* w, float* out, long long n,
                               int ox, int oy, long long ncell,
                               void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  uvw_rows_kernel<<<dim3((unsigned)nblk), block, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      pack, base, reinterpret_cast<const float4*>(w), out, n, ox,
      oy, ncell);
  return (int)cudaGetLastError();
}
