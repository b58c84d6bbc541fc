// K1 rk_fused_advect: fused Runge-Kutta advection with the final-position
// mesoscale wind sigma and temperature, one thread per parcel.
//
// Replaces the Pallas kernel mptrac_tpu/ops/rk_fused.py:_kernel (launched by
// _launch / advect_all).  The arithmetic is that of that module's rk_xla with
// _xla_locate, operation for operation, in float32: the file is compiled with
// -fmad=false so that no multiply-add is contracted and the plain PyTorch
// version (ops/rk_fused.py:rk_plain) follows the same rounding steps; only
// cosf may differ between math libraries.
//
// What bounds it on an H100: latency, then instructions.  A parcel
// streams 5 inputs and 7 outputs (48 bytes, coalesced) and gathers 8
// corners x 32 bytes per locate, (nstage + 1) locates a step; each locate
// depends on the wind of the one before, so a parcel's gather rounds are
// serial and only other warps hide them.  The design:
//   * the table is row-major [npl, nx, ny, 8] f32: one cell is one 32-byte
//     sector holding (u0,v0,w0,u1,v1,w1,t0,t1), read as two 16-byte loads;
//     it is level-major like the sort key, so parcels that are neighbours in
//     the sorted state read neighbouring sectors and share them in L1/L2;
//   * after the longitude wrap ix <= nx-2, so no corner crosses the seam and
//     the table needs no margin columns; every parcel is served here;
//   * the lat and p axes sit in shared memory; the level (and an irregular
//     latitude) is found by a binary search there, ceil(log2(n + 1)) steps
//     instead of a compare over every node (the same index on the strictly
//     monotonic axes that build_cell_pack admits);
//   * blocks of kBlock threads with the registers held for kMinBlocks of
//     them a multiprocessor, so 32 warps are resident to hide the gathers.
// The corner load, the interpolation and the sigma are interp_common.cuh's,
// shared with the unfused kernels (uvwt_interp.cu, meso_sigma.cu).

#include <math.h>

#include "interp_common.cuh"

namespace {

using mptrac::trilerp;
using mptrac::trilerp_time;

struct RkParams {
  const float* table;     // [npl, nx, ny, 8]
  const float* lat_axis;  // [ny]
  const float* p_axis;    // [npl]
  const float* lon;
  const float* lat;
  const float* p;
  const float* dt;
  const float* wt0;
  float* out;             // [7, n]: lon, lat, p, sig_u, sig_v, sig_w, T
  long long n;
  int nx, ny, npl;
  float lon0, dlon, lon_first, lon_last, lat_lo, lat_hi, inv_tden;
  int cartesian, lat_reg, lat_asc, p_asc;
};

// threads a block, and the blocks a multiprocessor that the register
// budget is set for: 8 x 128 threads, 32 warps a multiprocessor, holds
// ptxas to 64 registers (with a few hundred bytes of spill) where it would
// take 88-90 and fit 16 warps; the three gather rounds of a parcel are
// serial, so only other warps hide them
constexpr int kBlock = 128;
constexpr int kMinBlocks = 8;

// float32 roundings of the double products, as the plain version forms them
constexpr float kPiRe = (float)(3.14159265358979323846 * 6367.421);
constexpr float kDeg2Rad = (float)(3.14159265358979323846 / 180.0);
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kThird = (float)(2.0 / 6.0);

// (fraction of dt at which stage s samples, weight of stage s): Euler,
// midpoint, classical RK4 (reference mptrac.c:3654-3676)
template <int NSTAGE>
__device__ __forceinline__ float stage_frac(int s) {
  if (NSTAGE == 4) return s == 0 ? 0.0f : (s == 3 ? 1.0f : 0.5f);
  if (NSTAGE == 2) return s == 0 ? 0.0f : 0.5f;
  return 0.0f;
}

template <int NSTAGE>
__device__ __forceinline__ float stage_weight(int s) {
  if (NSTAGE == 4) return (s == 0 || s == 3) ? kSixth : kThird;
  if (NSTAGE == 2) return s == 0 ? 0.0f : 1.0f;
  return 1.0f;
}

struct Loc {
  int cell;
  float wx, wy, wz;
};

// The number of nodes with ax[i] <= x (ascending axis) or ax[i] > x
// (descending), the plain version's compare-count.  On a strictly
// monotonic axis (build_cell_pack raises on any other) those nodes are a
// prefix, so a binary search for the prefix's length gives the same
// integer in ceil(log2(n + 1)) steps; a NaN position fails every compare
// and counts 0 in both.
__device__ __forceinline__ int count_axis(const float* ax, int n, float x,
                                          bool asc) {
  int c = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    const int j = c + step;
    if (j <= n) {
      const float a = ax[j - 1];
      if (asc ? (a <= x) : (a > x)) c = j;
    }
  }
  return c;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// torch.clamp's (and jnp.clip's) float clamp: a NaN stays NaN, where
// fminf / fmaxf would return the bound
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ Loc locate(const RkParams& P, const float* s_lat,
                                      const float* s_p, float xlon, float xlat,
                                      float xp) {
  float lon2;
  if (P.cartesian) {
    lon2 = clampf(xlon, P.lon_first, P.lon_last);
  } else {
    lon2 = xlon - truncf(xlon / 360.0f) * 360.0f;
    if (lon2 < P.lon_first) lon2 = lon2 + 360.0f;
    if (lon2 > P.lon_last) lon2 = lon2 - 360.0f;
  }
  const float lat2 = clampf(xlat, P.lat_lo, P.lat_hi);
  const int ix = clampi((int)floorf((lon2 - P.lon0) / P.dlon), 0, P.nx - 2);
  int iy;
  if (P.lat_reg) {
    const float lat0 = s_lat[0];
    const float dlat = s_lat[1] - s_lat[0];
    iy = clampi((int)floorf((lat2 - lat0) / dlat), 0, P.ny - 2);
  } else {
    iy = clampi(count_axis(s_lat, P.ny, lat2, P.lat_asc != 0) - 1, 0,
                P.ny - 2);
  }
  const int iz = clampi(count_axis(s_p, P.npl, xp, P.p_asc != 0) - 1, 0,
                        P.npl - 2);
  const float x0 = P.lon0 + (float)ix * P.dlon;
  const float x1 = x0 + P.dlon;
  Loc L;
  L.wx = (x1 - lon2) / (x1 - x0);
  const float y0 = s_lat[iy], y1 = s_lat[iy + 1];
  L.wy = (y1 - lat2) / (y1 - y0);
  const float p0 = s_p[iz], p1 = s_p[iz + 1];
  L.wz = (p1 - xp) / (p1 - p0);
  L.cell = (iz * P.nx + ix) * P.ny + iy;
  return L;
}

__device__ __forceinline__ float dx2coord(float dxm, float lat, bool cart) {
  if (cart) return dxm;
  const bool pole = (lat < -89.999f) || (lat > 89.999f);
  const float den = kPiRe * cosf((pole ? 0.0f : lat) * kDeg2Rad);
  return pole ? 0.0f : ((dxm / 1000.0f) * 180.0f) / den;
}

__device__ __forceinline__ float dy2coord(float dym, bool cart) {
  if (cart) return dym;
  return ((dym / 1000.0f) * 180.0f) / kPiRe;
}

template <int NSTAGE>
__global__ void __launch_bounds__(kBlock, kMinBlocks) rk_kernel(RkParams P) {
  extern __shared__ float smem[];
  float* s_lat = smem;
  float* s_p = smem + P.ny;
  for (int j = threadIdx.x; j < P.ny; j += blockDim.x) s_lat[j] = P.lat_axis[j];
  for (int j = threadIdx.x; j < P.npl; j += blockDim.x) s_p[j] = P.p_axis[j];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const bool cart = P.cartesian != 0;

  const float lon = P.lon[i], lat = P.lat[i], p = P.p[i];
  const float dtp = P.dt[i], wt0 = P.wt0[i];

  float um = 0.0f, vm = 0.0f, wm = 0.0f;
  float uprev = 0.0f, vprev = 0.0f, wprev = 0.0f;
  float lat_node = lat;
  float c[8][8];
  const int oz = P.nx * P.ny;

#pragma unroll
  for (int s = 0; s < NSTAGE; ++s) {
    const float frac = stage_frac<NSTAGE>(s);
    const float kwt = stage_weight<NSTAGE>(s);
    float xlon = lon, xlat = lat, xp = p;
    if (s > 0) {
      const float dts = frac * dtp;
      xlon = lon + dx2coord(dts * uprev, lat, cart);
      xlat = lat + dy2coord(dts * vprev, cart);
      xp = p + dts * wprev;
    }
    const float wt = wt0 - (frac * dtp) * P.inv_tden;
    const Loc L = locate(P, s_lat, s_p, xlon, xlat, xp);
    mptrac::load_cell_corners(P.table, L.cell, P.ny, 1, oz, c);
    const float ui = trilerp_time(c, 0, 3, L.wx, L.wy, L.wz, wt);
    const float vi = trilerp_time(c, 1, 4, L.wx, L.wy, L.wz, wt);
    const float wi = trilerp_time(c, 2, 5, L.wx, L.wy, L.wz, wt);
    um = um + kwt * ui;
    vm = vm + kwt * vi;
    wm = wm + kwt * wi;
    uprev = ui; vprev = vi; wprev = wi;
    lat_node = xlat;
  }

  // the midpoint scheme converts the zonal step at the last node's latitude
  const float lat_dx = NSTAGE == 2 ? lat_node : lat;
  const float nlon = lon + dx2coord(dtp * um, lat_dx, cart);
  const float nlat = lat + dy2coord(dtp * vm, cart);
  const float np_ = p + dtp * wm;

  // final position: temperature and the 16-point subgrid wind sigma
  const float wtf = wt0 - dtp * P.inv_tden;
  const Loc Lf = locate(P, s_lat, s_p, nlon, nlat, np_);
  mptrac::load_cell_corners(P.table, Lf.cell, P.ny, 1, oz, c);
  const float T = trilerp_time(c, 6, 7, Lf.wx, Lf.wy, Lf.wz, wtf);
  float sig[3];
  mptrac::sigma16(c, sig);

  float* o = P.out + i;
  const long long n = P.n;
  o[0] = nlon;
  o[n] = nlat;
  o[2 * n] = np_;
  o[3 * n] = sig[0];
  o[4 * n] = sig[1];
  o[5 * n] = sig[2];
  o[6 * n] = T;
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for a bad nstage).
extern "C" int rk_fused_advect(
    int nstage, const float* table, const float* lat_axis, const float* p_axis,
    const float* lon, const float* lat, const float* p, const float* dt,
    const float* wt0, float* out, long long n, int nx, int ny, int npl,
    float lon0, float dlon, float lon_first, float lon_last, float lat_lo,
    float lat_hi, float inv_tden, int cartesian, int lat_reg, int lat_asc,
    int p_asc, void* stream) {
  if (n <= 0) return 0;
  RkParams P;
  P.table = table; P.lat_axis = lat_axis; P.p_axis = p_axis;
  P.lon = lon; P.lat = lat; P.p = p; P.dt = dt; P.wt0 = wt0; P.out = out;
  P.n = n; P.nx = nx; P.ny = ny; P.npl = npl;
  P.lon0 = lon0; P.dlon = dlon; P.lon_first = lon_first; P.lon_last = lon_last;
  P.lat_lo = lat_lo; P.lat_hi = lat_hi; P.inv_tden = inv_tden;
  P.cartesian = cartesian; P.lat_reg = lat_reg; P.lat_asc = lat_asc;
  P.p_asc = p_asc;
  const int block = kBlock;
  const long long nblk = mptrac::grid_blocks(n, block);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)(ny + npl) * sizeof(float);
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nblk);
  switch (nstage) {
    case 1: rk_kernel<1><<<grid, block, shmem, st>>>(P); break;
    case 2: rk_kernel<2><<<grid, block, shmem, st>>>(P); break;
    case 4: rk_kernel<4><<<grid, block, shmem, st>>>(P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// What the compiled kernel of `nstage` takes on this card: out[0] registers
// a thread, out[1] local memory a thread in bytes (spills and stack), out[2]
// resident blocks a multiprocessor at the launch's block size and shared
// memory for axes of ny + npl nodes.
extern "C" int rk_fused_attributes(int nstage, int ny, int npl, int* out) {
  const void* f;
  switch (nstage) {
    case 1: f = (const void*)rk_kernel<1>; break;
    case 2: f = (const void*)rk_kernel<2>; break;
    case 4: f = (const void*)rk_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], f, kBlock, (size_t)(ny + npl) * sizeof(float));
}
