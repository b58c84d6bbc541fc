// Device code shared by the interpolation kernels: the corner loads, the
// trilinear + time interpolation and the 16-point subgrid wind sigma.
//
// Included by rk_fused.cu (K1), uvwt_interp.cu (K4), meso_sigma.cu (K5),
// lane_interp.cu (K6) and uvw_rows.cu (K7).  The arithmetic is the JAX
// package's ops/slab_interp.py:_trilerp_T and _meso_sigma_T in float32,
// operation for operation; every file that includes this header is compiled
// with -fmad=false, so no multiply-add is contracted and the plain PyTorch
// versions (ops/rk_fused.py:_plain_trilerp, _plain_sigma16) round alike.
//
// A parcel's working set is c[8][8]: 8 corners x 8 fields, corner
// k = dx*4 + dy*2 + dz, fields (u0, v0, w0, u1, v1, w1, t0, t1).  Every index
// into it is a compile-time constant after unrolling, so it lives in
// registers.  Two table layouts fill it:
//   * rows of 8 floats, one 32-byte sector per grid node (the per-cell
//     tables [npl, nx, ny, 8] and [ncell, 8]): 8 gathers of two 16-byte loads;
//   * rows of 64 floats holding a cell's whole corner block (the 64-wide
//     table [ncell, 64]): one contiguous 256-byte row, 16-byte loads.

#pragma once

#include <cuda_runtime.h>

namespace mptrac {

__device__ __forceinline__ float mix(float w, float a, float b) {
  return w * (a - b) + b;
}

// Corner (dx, dy, dz) is row `base + dx*sx + dy*sy + dz*sz` of a table of
// 8-float rows.  A stride of 0 repeats the lower node (edge clamp).  With
// CLAMP_LAST a corner past row `last` reads row `last` (for callers that
// know the strides but not the axes).
template <bool CLAMP_LAST = false>
__device__ __forceinline__ void load_cell_corners(const float* table,
                                                  long long base, int sx,
                                                  int sy, int sz,
                                                  float c[8][8],
                                                  long long last = 0) {
  const float4* tab = reinterpret_cast<const float4*>(table);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    long long row = base + dx * sx + dy * sy + dz * sz;
    if (CLAMP_LAST) row = row < last ? row : last;
    const size_t cc = (size_t)row;
    const float4 a = __ldg(tab + 2 * cc);
    const float4 b = __ldg(tab + 2 * cc + 1);
    c[k][0] = a.x; c[k][1] = a.y; c[k][2] = a.z; c[k][3] = a.w;
    c[k][4] = b.x; c[k][5] = b.y; c[k][6] = b.z; c[k][7] = b.w;
  }
}

// Row `base` of the 64-wide table: lane corner*6 + (u0,v0,w0,u1,v1,w1),
// lanes 48 + corner*2 + (t0,t1).  Without WITH_T only lanes 0-47 are read
// and c[k][6], c[k][7] stay unset.
template <bool WITH_T>
__device__ __forceinline__ void load_row_corners(const float* table64,
                                                 long long base,
                                                 float c[8][8]) {
  const float4* row =
      reinterpret_cast<const float4*>(table64) + (size_t)base * 16;
  constexpr int NV = WITH_T ? 16 : 12;
  float lane[4 * NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 a = __ldg(row + j);
    lane[4 * j] = a.x; lane[4 * j + 1] = a.y;
    lane[4 * j + 2] = a.z; lane[4 * j + 3] = a.w;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int f = 0; f < 6; ++f) c[k][f] = lane[k * 6 + f];
    if (WITH_T) {
      c[k][6] = lane[48 + 2 * k];
      c[k][7] = lane[48 + 2 * k + 1];
    }
  }
}

// field f at the parcel point: z, then y, then x
__device__ __forceinline__ float trilerp(const float c[8][8], int f, float wx,
                                         float wy, float wz) {
  const float a00 = mix(wz, c[0][f], c[1][f]);
  const float a01 = mix(wz, c[2][f], c[3][f]);
  const float a10 = mix(wz, c[4][f], c[5][f]);
  const float a11 = mix(wz, c[6][f], c[7][f]);
  const float a0 = mix(wy, a00, a01);
  const float a1 = mix(wy, a10, a11);
  return mix(wx, a0, a1);
}

// fields f0 (snapshot 0) and f1 (snapshot 1) in space, then in time
__device__ __forceinline__ float trilerp_time(const float c[8][8], int f0,
                                              int f1, float wx, float wy,
                                              float wz, float wt) {
  const float v0 = trilerp(c, f0, wx, wy, wz);
  const float v1 = trilerp(c, f1, wx, wy, wz);
  return mix(wt, v0, v1);
}

// Subgrid wind sigma of u, v, w over 8 corners x 2 snapshots in the
// reference's summation order: corner-major, snapshot 0 then 1.
__device__ __forceinline__ void sigma16(const float c[8][8], float sig[3]) {
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    float mean = 0.0f, msq = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int sn = 0; sn < 2; ++sn) {
        const float val = c[k][comp + 3 * sn];
        mean = mean + val;
        msq = msq + val * val;
      }
    }
    mean = mean * (1.0f / 16.0f);
    msq = msq * (1.0f / 16.0f);
    const float var = msq - mean * mean;
    sig[comp] = var > 0.0f ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
  }
}

// Edge-clamped corner strides of flat cell (iz*nx + ix)*ny + iy in the
// level-major per-cell table [npl, nx, ny, 8]: the upper corner of an axis
// repeats the last node, as the edge padding of the JAX tables does.
__device__ __forceinline__ void clamped_strides(int cell, int nx, int ny,
                                                int npl, int& sx, int& sy,
                                                int& sz) {
  const int iy = cell % ny;
  const int t = cell / ny;
  const int ix = t % nx;
  const int iz = t / nx;
  sx = ix < nx - 1 ? ny : 0;
  sy = iy < ny - 1 ? 1 : 0;
  sz = iz < npl - 1 ? nx * ny : 0;
}

// blocks of `block` threads for n parcels, or -1 if the grid would overflow
inline long long grid_blocks(long long n, int block) {
  const long long nblk = (n + block - 1) / block;
  return nblk > 2147483647LL ? -1 : nblk;
}

}  // namespace mptrac
