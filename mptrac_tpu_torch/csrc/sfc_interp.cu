// K2 sfc_interp: bilinear + time interpolation of selected surface fields with
// the reference's non-finite fallbacks, one thread per parcel.
//
// Replaces the Pallas kernel mptrac_tpu/ops/slab_interp.py:_kernel in mode
// ("sfc", fields) (reached through interp_sfc / sfc_from_loc); the arithmetic
// is that module's _sfc_interp_T: per snapshot the bilinear value when all
// four corners are finite, else the nearest corner (wx < 0.5, wy < 0.5
// choices); over time the lerp when both snapshots are finite, else the
// nearer snapshot (wt < 0.5).  Compiled with -fmad=false so the plain PyTorch
// version (ops/slab_interp.py:sfc_interp_plain) rounds at the same places.
//
// What bounds it on an H100: bytes.  A parcel streams its cell index, three
// weights and one output per field; the gathered part is small, because the
// whole table of a 361x181 grid ([nx, ny, 2, 16] f32, 128 bytes a column,
// 8 MB) stays in the 50 MB L2.  A thread reads only the requested fields
// (4 corners x 2 snapshots x 4 bytes each), not the whole 128-byte column.

#include <cuda_runtime.h>
#include <math.h>

#include "interp_common.cuh"

namespace {

__global__ void __launch_bounds__(256) sfc_kernel(
    const float* __restrict__ table, const int* __restrict__ basexy,
    const float* __restrict__ wx_, const float* __restrict__ wy_,
    const float* __restrict__ wt_, float* __restrict__ out, long long n,
    int nx, int ny, int nfields, unsigned long long fields_packed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = basexy[i];
  const int ix = b / ny;
  const int iy = b - ix * ny;
  const mptrac::SfcCorners corners(ix, iy, nx, ny);
  const float wx = wx_[i], wy = wy_[i], wt = wt_[i];
  for (int f = 0; f < nfields; ++f) {
    const int fi = (int)((fields_packed >> (4 * f)) & 15ULL);
    out[(size_t)f * n + i] = corners.value(table, fi, wx, wy, wt);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().  `fields_packed` holds nfields <= 16 field numbers,
// 4 bits each, the first in the lowest bits; `out` is [nfields, n].
extern "C" int sfc_interp(const float* table, const int* basexy,
                          const float* wx, const float* wy, const float* wt,
                          float* out, long long n, int nx, int ny, int nfields,
                          unsigned long long fields_packed, void* stream) {
  if (n <= 0 || nfields <= 0) return 0;
  if (nfields > 16) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const long long nblk = (n + block - 1) / block;
  if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  sfc_kernel<<<dim3((unsigned)nblk), block, 0,
               reinterpret_cast<cudaStream_t>(stream)>>>(
      table, basexy, wx, wy, wt, out, n, nx, ny, nfields, fields_packed);
  return (int)cudaGetLastError();
}
