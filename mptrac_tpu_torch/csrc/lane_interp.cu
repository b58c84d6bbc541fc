// K6 lane_interp: the functions of K4 (u, v, w, T) and K5 (subgrid sigma) on
// the 64-wide corner-block table [ncell, 64], one thread per parcel.
//
// Replaces the Pallas lane-gather kernel
// mptrac_tpu/ops/lane_interp.py:_kernel_body (launched by _lane_pass from
// interp_uvwt_sorted and meso_sigma_sorted; modes "interp" and "meso").
// Plain versions: ops/lane_interp.py:interp_uvwt_plain, meso_sigma_plain.
//
// What bounds it on an H100: bytes.  A row holds a cell's whole 2x2x2 corner
// block, so a parcel reads one contiguous 256-byte row (192 bytes for the
// sigma) instead of 8 scattered sectors, at the price of a table 8 times the
// per-cell one (1.02 GB at 361x181x61, read once when every cell holds
// parcels).  The row is the table of the JAX package's build_advect_pack64,
// row-major; the transposed [64, ncell] layout and its 128-cell windows
// exist for the TPU's lane gather and have no counterpart.  Any parcel order
// is served.

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) lane_uvwt_kernel(
    const float* __restrict__ table64, const int* __restrict__ base,
    const float* __restrict__ w, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float c[8][8];
  mptrac::load_row_corners<true>(table64, base[i], c);
  const float x = w[i], y = w[n + i], z = w[2 * n + i], t = w[3 * n + i];
  out[i] = mptrac::trilerp_time(c, 0, 3, x, y, z, t);
  out[n + i] = mptrac::trilerp_time(c, 1, 4, x, y, z, t);
  out[2 * n + i] = mptrac::trilerp_time(c, 2, 5, x, y, z, t);
  out[3 * n + i] = mptrac::trilerp_time(c, 6, 7, x, y, z, t);
}

__global__ void __launch_bounds__(256) lane_meso_kernel(
    const float* __restrict__ table64, const int* __restrict__ base,
    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float c[8][8];
  mptrac::load_row_corners<false>(table64, base[i], c);
  float sig[3];
  mptrac::sigma16(c, sig);
  out[i] = sig[0];
  out[n + i] = sig[1];
  out[2 * n + i] = sig[2];
}

}  // namespace

// w [4, n] = (wx, wy, wz, wt); out [4, n] = (u, v, w, T).  Both functions
// launch on `stream`, allocate nothing, do not synchronise and return
// cudaGetLastError().
extern "C" int lane_interp_uvwt(const float* table64, const int* base,
                                const float* w, float* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  lane_uvwt_kernel<<<dim3((unsigned)nblk), block, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(table64, base,
                                                               w, out, n);
  return (int)cudaGetLastError();
}

// out [3, n] = (sigma_u, sigma_v, sigma_w)
extern "C" int lane_meso_sigma(const float* table64, const int* base,
                               float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  lane_meso_kernel<<<dim3((unsigned)nblk), block, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(table64, base,
                                                               out, n);
  return (int)cudaGetLastError();
}
