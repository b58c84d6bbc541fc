// Device code shared by the interpolation kernels: the corner loads, the
// trilinear + time interpolation and the 16-point subgrid wind sigma; the
// plain interpolation's horizontal locate and its surface arithmetic.
//
// Included by rk_fused.cu (K1), sfc_interp.cu (K2), uvwt_interp.cu (K4),
// meso_sigma.cu (K5), lane_interp.cu (K6), uvw_rows.cu (K7), plain_interp.cu
// and diff_turb.cu.  The arithmetic is the JAX
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
#include <math.h>

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

// ---- the plain interpolation (ops/interp.py): locate and surface fields
//
// Bit for bit the plain PyTorch chain on the card: torch.maximum and
// torch.minimum return a NaN operand (fmaxf/fminf would drop it); a float
// converted to int32 saturates and gives 0 for NaN (cvt.rzi), as PyTorch's
// cast does; PyTorch divides a CUDA tensor by a host scalar as a product with
// the scalar's float64 reciprocal rounded to the tensor's type, so fmod's
// x / 360 is x * (1/360 in float32).

// 1/360 rounded to float32, the reciprocal PyTorch multiplies by in x / 360.0
constexpr float INV360 = 1.0f / 360.0f;

// axes of up to this many floats in all are staged in shared memory
// (locate3d_kernel, diff_turb_kernel); physics/diffusion.py's
// SMEM_AXIS_FLOATS holds the same number
constexpr int SMEM_AXIS_FLOATS = 12288;

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ int clamp_i(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// locate_reg: floor((x - xx[0]) / (xx[1] - xx[0])) in [0, n-2], in float32
// whatever the axis' type (a float32 coordinate takes a float64 0-dim node
// as a float32 one, the node difference taken in the axis' type)
template <typename A>
__device__ __forceinline__ int locate_reg(const A* xx, int n, float x) {
  return clamp_i((int)floorf((x - (float)xx[0]) / (float)(xx[1] - xx[0])),
                 0, n - 2);
}

// locate_irr: the count of nodes at or below x (ascending axis) or above x
// (descending), 0 for NaN, less one, in [0, n-2]; the nodes compared in the
// coordinate's type X.  A binary search gives searchsorted's count on any
// monotonic axis, ties included.
template <typename X, typename A>
__device__ __forceinline__ int locate_irr(const A* xx, int n, X x) {
  int lo = 0, hi = n;
  if (xx[1] > xx[0]) {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((X)xx[mid] <= x) lo = mid + 1; else hi = mid;
    }
  } else {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((X)xx[mid] > x) lo = mid + 1; else hi = mid;
    }
  }
  if (isnan(x)) lo = 0;
  return clamp_i(lo - 1, 0, n - 2);
}

// _axis_vals: (xx[i], xx[i+1]), by arithmetic on an exactly regular axis
__device__ __forceinline__ void axis_vals(const float* xx, int i, bool reg,
                                          float& v0, float& v1) {
  if (reg) {
    const float d = xx[1] - xx[0];
    v0 = xx[0] + (float)i * d;
    v1 = v0 + d;
  } else {
    v0 = xx[i];
    v1 = xx[i + 1];
  }
}

// The horizontal part of locate_3d on the axes lons [nx], lats [ny]:
// check_lon_lat (or check_cartesian), then the cell and the weights of its
// lower nodes.
struct HorizontalGrid {
  const float* lons;
  const float* lats;
  int nx, ny;
  bool cartesian, reg_lon, reg_lat;
  float xlo, xhi, ylo, yhi;

  __device__ HorizontalGrid(const float* lons_, const float* lats_, int nx_,
                            int ny_, bool cartesian_, bool reg_lon_,
                            bool reg_lat_)
      : lons(lons_), lats(lats_), nx(nx_), ny(ny_), cartesian(cartesian_),
        reg_lon(reg_lon_), reg_lat(reg_lat_),
        xlo(nan_min(lons_[0], lons_[nx_ - 1])),
        xhi(nan_max(lons_[0], lons_[nx_ - 1])),
        ylo(nan_min(lats_[0], lats_[ny_ - 1])),
        yhi(nan_max(lats_[0], lats_[ny_ - 1])) {}

  __device__ __forceinline__ void locate(float lon, float lat, int& ix,
                                         int& iy, float& wx,
                                         float& wy) const {
    float lon2;
    if (cartesian) {   // check_cartesian
      lon2 = nan_min(nan_max(lon, xlo), xhi);
    } else {           // check_lon_lat, fmod as ops/thermo.fmod
      lon2 = lon - truncf(lon * INV360) * 360.0f;
      if (lon2 < lons[0]) lon2 = lon2 + 360.0f;
      if (lon2 > lons[nx - 1]) lon2 = lon2 - 360.0f;
    }
    const float lat2 = nan_min(nan_max(lat, ylo), yhi);
    ix = locate_reg(lons, nx, lon2);
    iy = locate_irr(lats, ny, lat2);
    float x0, x1, y0, y1;
    axis_vals(lons, ix, reg_lon, x0, x1);
    axis_vals(lats, iy, reg_lat, y0, y1);
    wx = (x1 - lon2) / (x1 - x0);
    wy = (y1 - lat2) / (y1 - y0);
  }
};

// interp_2d at one snapshot: bilinear where all four corners are finite, else
// the nearest corner
__device__ __forceinline__ float bilinear_nn(float a00, float a01, float a10,
                                             float a11, float wx, float wy) {
  const bool ok = isfinite(a00) && isfinite(a01) && isfinite(a10) &&
                  isfinite(a11);
  const float bilin = mix(wx, mix(wy, a00, a01), mix(wy, a10, a11));
  const float nn = wy < 0.5f ? (wx < 0.5f ? a11 : a01)
                             : (wx < 0.5f ? a10 : a00);
  return ok ? bilin : nn;
}

// interp_time_2d in time: the lerp where both snapshots are finite, else the
// nearer snapshot
__device__ __forceinline__ float time_nn(float v0, float v1, float wt) {
  const bool both = isfinite(v0) && isfinite(v1);
  return both ? mix(wt, v0, v1) : (wt < 0.5f ? v1 : v0);
}

// The four corner columns of cell (ix, iy) in K2's surface table
// [nx, ny, 2, SFC_TABLE_FIELDS], clamped at the grid's edge like the
// edge-padded table they replace; value() is one field of the table at the
// weights (wx, wy) of the lower nodes and wt of snapshot 0.
constexpr int SFC_TABLE_FIELDS = 16;

struct SfcCorners {
  size_t c00, c01, c10, c11;

  __device__ SfcCorners(int ix, int iy, int nx, int ny) {
    const int ix1 = min(ix + 1, nx - 1);
    const int iy1 = min(iy + 1, ny - 1);
    c00 = (size_t)(ix * ny + iy) * 2 * SFC_TABLE_FIELDS;
    c01 = (size_t)(ix * ny + iy1) * 2 * SFC_TABLE_FIELDS;
    c10 = (size_t)(ix1 * ny + iy) * 2 * SFC_TABLE_FIELDS;
    c11 = (size_t)(ix1 * ny + iy1) * 2 * SFC_TABLE_FIELDS;
  }

  __device__ __forceinline__ float value(const float* table, int field,
                                         float wx, float wy,
                                         float wt) const {
    float v[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int o = s * SFC_TABLE_FIELDS + field;
      v[s] = bilinear_nn(__ldg(table + c00 + o), __ldg(table + c01 + o),
                         __ldg(table + c10 + o), __ldg(table + c11 + o), wx,
                         wy);
    }
    return time_nn(v[0], v[1], wt);
  }
};

// time_weight: (t1 - t) / (t1 - t0) in float64 (inv_dt the reciprocal of
// t1 - t0, by which PyTorch multiplies), rounded once to float32
__device__ __forceinline__ float time_weight(double t, double t1,
                                             double inv_dt) {
  return (float)((t1 - t) * inv_dt);
}

// blocks of `block` threads for n parcels, or -1 if the grid would overflow
inline long long grid_blocks(long long n, int block) {
  const long long nblk = (n + block - 1) / block;
  return nblk > 2147483647LL ? -1 : nblk;
}

}  // namespace mptrac
