// The plain interpolation of ops/interp.py on the card, one launch a call:
//   locate3d_kernel       locate_3d: each parcel's cell (ix, iy, iz) and the
//                         weights of its lower nodes (wx, wy, wz);
//   interp3d_time_kernel  interp_time_3d: a 3-D field of the met pair at the
//                         located cells, trilinear, then in time;
//   interp2d_time_kernel  interp_time_2d: a surface field of the pair,
//                         bilinear or the nearest corner where a corner is
//                         not finite, then in time or the nearer snapshot
//                         where a snapshot is not finite (K2's arithmetic,
//                         sfc_interp.cu, read from the field itself).
//
// Replaces no Pallas kernel: the JAX package's ops/interp.py is plain jnp, and
// so is the plain version here (ops/interp.py locate_3d_plain,
// interp_time_3d_plain, interp_time_2d_plain), which runs a call as 40-60
// eager gather and elementwise passes, each a full read and write of [N] or
// [2, N] temporaries.  The kernels were added because that layer took 74 % of
// the chemistry cell's step (chem.mem: 27 calls a step at 100,663,296
// parcels).
//
// What bounds them on an H100: streamed bytes.  A locate reads lon, lat, p and
// writes three int32 indices and three float32 weights (36 B a parcel); a 3-D
// interpolation reads the locator and the float64 time and writes one float
// (36 B); a 2-D one reads half the locator (28 B).  The axes are a few hundred
// floats, staged in shared memory; the gathered corners come from a field
// pair of 2 x 360x181x61 floats (31.8 MB), which stays in the 50 MB L2 while
// the parcels are sorted by cell.  The design therefore spends no byte on
// temporaries and makes one pass a call: every intermediate of the plain chain
// lives in registers, the per-parcel streams are read and written once with
// streaming (evict-first) accesses so that they do not push the field pair out
// of L2, and one thread handles one parcel in a grid-stride loop with an int64
// index.
//
// Each kernel reproduces its plain version bit for bit on the card, so every
// float operation is the plain chain's, in its order (-fmad=false keeps the
// compiler from contracting them):
//   * PyTorch divides a CUDA tensor by a host scalar as a product with the
//     scalar's reciprocal: ops/thermo.fmod's x / 360 is x * (1/360 in float32),
//     and time_weight's division by t1 - t0 a product with its float64
//     reciprocal (passed in as inv_dt).  Division by a tensor is IEEE division.
//   * torch.maximum / torch.minimum return a NaN operand; fmaxf/fminf would
//     drop it.
//   * A float converted to int32 saturates and gives 0 for NaN (cvt.rzi), as
//     PyTorch's cast does on the card.
//   * locate_irr's two searchsorted calls count #{xx <= x} on an ascending
//     axis and #{xx > x} on a descending one; a binary search over the staged
//     axis gives the same count on any monotonic axis, ties included.

#include <cuda_runtime.h>
#include <math.h>

#include "interp_common.cuh"

namespace {

using mptrac::bilinear_nn;
using mptrac::HorizontalGrid;
using mptrac::locate_irr;
using mptrac::time_nn;

using mptrac::SMEM_AXIS_FLOATS;

constexpr int BLOCK = 256;

template <bool SMEM>
__global__ void __launch_bounds__(BLOCK) locate3d_kernel(
    const float* __restrict__ lon_, const float* __restrict__ lat_,
    const float* __restrict__ p_, const float* __restrict__ lons_g,
    const float* __restrict__ lats_g, const float* __restrict__ ps_g, int nx,
    int ny, int npl, bool cartesian, bool reg_lon, bool reg_lat,
    int* __restrict__ ix_, int* __restrict__ iy_, int* __restrict__ iz_,
    float* __restrict__ wx_, float* __restrict__ wy_,
    float* __restrict__ wz_, long long n) {
  extern __shared__ float axes[];
  const float* lons = lons_g;
  const float* lats = lats_g;
  const float* ps = ps_g;
  if (SMEM) {
    for (int k = threadIdx.x; k < nx + ny + npl; k += BLOCK)
      axes[k] = k < nx ? lons_g[k]
                       : (k < nx + ny ? lats_g[k - nx] : ps_g[k - nx - ny]);
    __syncthreads();
    lons = axes;
    lats = axes + nx;
    ps = axes + nx + ny;
  }
  const HorizontalGrid grid(lons, lats, nx, ny, cartesian, reg_lon,
                            reg_lat);
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n;
       i += stride) {
    const float lon = __ldcs(lon_ + i), lat = __ldcs(lat_ + i),
                p = __ldcs(p_ + i);
    const int iz = locate_irr(ps, npl, p);
    int ix, iy;
    float wx, wy;
    grid.locate(lon, lat, ix, iy, wx, wy);
    const float p0 = ps[iz], p1 = ps[iz + 1];
    __stcs(ix_ + i, ix);
    __stcs(iy_ + i, iy);
    __stcs(iz_ + i, iz);
    __stcs(wx_ + i, wx);
    __stcs(wy_ + i, wy);
    __stcs(wz_ + i, (p1 - p) / (p1 - p0));
  }
}

// time_weight of the time of parcel i, or of the one time (ts_step 0)
__device__ __forceinline__ float parcel_time_weight(const double* ts,
                                                    long long i,
                                                    long long ts_step,
                                                    double t1,
                                                    double inv_dt) {
  return mptrac::time_weight(__ldcs(ts + i * ts_step), t1, inv_dt);
}

// field [2, nx, ny, npl]: corner k = dx*4 + dy*2 + dz of snapshot s is
// c[k][s]; the lerps of interp_3d (z, then y, then x) per snapshot, then
// interp_time_3d's in time
__global__ void __launch_bounds__(BLOCK) interp3d_time_kernel(
    const float* __restrict__ field, const int* __restrict__ ix_,
    const int* __restrict__ iy_, const int* __restrict__ iz_,
    const float* __restrict__ wx_, const float* __restrict__ wy_,
    const float* __restrict__ wz_, const double* __restrict__ ts,
    long long ts_step, double t1, double inv_dt, float* __restrict__ out,
    long long n, int ny, int npl, long long snap) {
  const long long sx = (long long)ny * npl;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n;
       i += stride) {
    const long long base =
        ((long long)__ldcs(ix_ + i) * ny + __ldcs(iy_ + i)) * npl +
        __ldcs(iz_ + i);
    float c[8][8];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int k = 0; k < 8; k += 2) {   // the pair iz, iz + 1
        const float* f = field + s * snap + base + (k >> 2) * sx +
                         ((k >> 1) & 1) * npl;
        c[k][s] = __ldg(f);
        c[k + 1][s] = __ldg(f + 1);
      }
    }
    const float wt = parcel_time_weight(ts, i, ts_step, t1, inv_dt);
    __stcs(out + i, mptrac::trilerp_time(c, 0, 1, __ldcs(wx_ + i),
                                         __ldcs(wy_ + i), __ldcs(wz_ + i),
                                         wt));
  }
}

// field [2, nx, ny]
__global__ void __launch_bounds__(BLOCK) interp2d_time_kernel(
    const float* __restrict__ field, const int* __restrict__ ix_,
    const int* __restrict__ iy_, const float* __restrict__ wx_,
    const float* __restrict__ wy_, const double* __restrict__ ts,
    long long ts_step, double t1, double inv_dt, float* __restrict__ out,
    long long n, int ny, long long snap) {
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n;
       i += stride) {
    const long long c00 = (long long)__ldcs(ix_ + i) * ny + __ldcs(iy_ + i);
    const float wx = __ldcs(wx_ + i), wy = __ldcs(wy_ + i);
    float v[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* f = field + s * snap + c00;
      v[s] = bilinear_nn(__ldg(f), __ldg(f + 1), __ldg(f + ny),
                         __ldg(f + ny + 1), wx, wy);
    }
    const float wt = parcel_time_weight(ts, i, ts_step, t1, inv_dt);
    __stcs(out + i, time_nn(v[0], v[1], wt));
  }
}

// Blocks of the grid-stride loop over n parcels: eight blocks on every SM, no
// more than the work needs.
unsigned grid_blocks(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + BLOCK - 1) / BLOCK;
  const long long most = 8LL * sms;
  return (unsigned)(need < most ? need : most);
}

}  // namespace

// Each launches one kernel on `stream`, allocates nothing, does not
// synchronise and returns cudaGetLastError(); nothing is launched for n <= 0.
// Every array is contiguous; the wrapper (ops/interp.py) checks dtypes, shapes
// and devices.  ts holds one time (ts_step 0) or one a parcel (ts_step 1).

// lon, lat, p [n] -> ix, iy, iz (int32), wx, wy, wz (float32) [n]; the axes
// lons [nx], lats [ny], ps [npl], each of at least two nodes
extern "C" int interp_locate3d(const float* lon, const float* lat,
                               const float* p, const float* lons,
                               const float* lats, const float* ps, int nx,
                               int ny, int npl, int cartesian, int reg_lon,
                               int reg_lat, int* ix, int* iy, int* iz,
                               float* wx, float* wy, float* wz, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  if (nx < 2 || ny < 2 || npl < 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long naxis = (long long)nx + ny + npl;
  if (naxis <= SMEM_AXIS_FLOATS)
    locate3d_kernel<true><<<grid_blocks(n), BLOCK, naxis * sizeof(float),
                            st>>>(lon, lat, p, lons, lats, ps, nx, ny, npl,
                                  cartesian, reg_lon, reg_lat, ix, iy, iz, wx,
                                  wy, wz, n);
  else
    locate3d_kernel<false><<<grid_blocks(n), BLOCK, 0, st>>>(
        lon, lat, p, lons, lats, ps, nx, ny, npl, cartesian, reg_lon, reg_lat,
        ix, iy, iz, wx, wy, wz, n);
  return (int)cudaGetLastError();
}

// field [2, nx, ny, npl] at the located cells -> out [n]
extern "C" int interp_time3d(const float* field, const int* ix, const int* iy,
                             const int* iz, const float* wx, const float* wy,
                             const float* wz, const double* ts,
                             long long ts_step, double t1, double inv_dt,
                             float* out, long long n, int nx, int ny, int npl,
                             void* stream) {
  if (n <= 0) return 0;
  interp3d_time_kernel<<<grid_blocks(n), BLOCK, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      field, ix, iy, iz, wx, wy, wz, ts, ts_step, t1, inv_dt, out, n, ny, npl,
      (long long)nx * ny * npl);
  return (int)cudaGetLastError();
}

// field [2, nx, ny] at the located columns -> out [n]
extern "C" int interp_time2d(const float* field, const int* ix, const int* iy,
                             const float* wx, const float* wy,
                             const double* ts, long long ts_step, double t1,
                             double inv_dt, float* out, long long n, int nx,
                             int ny, void* stream) {
  if (n <= 0) return 0;
  interp2d_time_kernel<<<grid_blocks(n), BLOCK, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      field, ix, iy, wx, wy, ts, ts_step, t1, inv_dt, out, n, ny,
      (long long)nx * ny);
  return (int)cudaGetLastError();
}
