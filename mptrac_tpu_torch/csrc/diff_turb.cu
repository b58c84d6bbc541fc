// The turbulent diffusion of physics/diffusion.py (module_diff_turb) on the
// card, one launch a call: diff_turb_kernel.
//
// Replaces no Pallas kernel: the JAX package's module_diff_turb
// (mptrac_tpu/physics/diffusion.py) is plain jnp, and so is the plain version
// here (module_diff_turb_plain), which runs a call as ~200 eager passes (the
// [3, n] normal draw, the locate, the surface lookup, the climatological
// tropopause, the blending weights at p, p + eps and p - eps, both
// displacements, ten reflections), each a full read and write of [n] float32
// or float64 temporaries.  The kernel was added because that chain took 45 %
// of the flagship's step (base.mem).
//
// What bounds it on an H100.  A parcel reads lon, lat, p, its float64 time and
// its float32 dt (24 B) and writes lon, lat, p (12 B): 36 B, 1.08 ms at
// 3.35 TB/s for 100,663,296 parcels.  The surface table's corners, the axes
// and the climatology's tables are small and stay in L1 and L2.  The work is
// larger: three Squares normals (~210 instructions), the float64 tropopause
// and three evaluations of the blending weights, some 500 instructions a
// parcel, ~1.5 ms at one instruction a lane a cycle.  So the design spends
// nothing on memory but the streams: one thread a parcel in a grid-stride
// loop with an int64 index, every intermediate in registers, the horizontal
// axes in shared memory (a grid of more than mptrac::SMEM_AXIS_FLOATS
// horizontal nodes is refused), the per-parcel streams read and written once
// with streaming accesses.  A parcel that does not move (masked, dt 0, in the
// boundary layer under the PBL scheme) skips the rest; a normal is drawn only
// where its displacement is used; the reflection loop stops at its fixed
// point.  None of these changes a result.
//
// Bit for bit the plain version on the card: every float operation is the
// plain chain's, in its order and in the type PyTorch's promotion gives it
// (-fmad=false keeps the compiler from contracting them):
//   * a float32 CUDA tensor times a host scalar takes the scalar rounded to
//     float32, and a division by a host scalar is a product with the scalar's
//     reciprocal, taken in float64 and rounded to float32 (the constants
//     below; 1/0.866877899 and 1/(pi RE) round otherwise than the float32
//     reciprocals of the rounded scalars);
//   * the time weight is the float64 ratio rounded to float32; the tropopause
//     is float64 from the float64 time, each of its table steps in float32,
//     the type of the climatology's tables in every float32 run
//     (astype_state), rounded to float32 at the end (clim_tropo_at);
//   * torch.maximum / torch.minimum keep a NaN; torch.clamp(k, min=0) is left
//     out, since k > 0 wherever its result is used;
//   * the draws are squares_normal3_f32's, row c of parcel i at counter
//     ctr + c*total + first + i of the [3, total] draw (squares.cuh).
// The locate and the surface lookup are those of locate3d_kernel
// (plain_interp.cu) and sfc_kernel (sfc_interp.cu), from interp_common.cuh.

#include <cuda_runtime.h>
#include <math.h>

#include "interp_common.cuh"
#include "squares.cuh"

namespace {

using mptrac::HorizontalGrid;
using mptrac::nan_max;
using mptrac::nan_min;
using mptrac::normal3_at;

constexpr int BLOCK = 256;

// climatology.py: _YEAR_S, and the float64 reciprocal t / _YEAR_S multiplies
// by
constexpr double YEAR_S = 365.25 * 86400.0;
constexpr double RCP_YEAR_S = 1.0 / YEAR_S;
// tropo_weight: pt * 0.866877899 and pt / 0.866877899
constexpr float TROPO_F = (float)0.866877899;
constexpr float RCP_TROPO_F = (float)(1.0 / 0.866877899);
// thermo.dz2dp: / H0 (7 km)
constexpr float RCP_H0 = (float)(1.0 / 7.0);
// dz2dp(eps_km, p) and dz2dp(-eps_km, p): -dz * p with eps_km 0.01
constexpr float EPS_UP = (float)-0.01;
constexpr float EPS_DN = (float)0.01;
// dkz_dz: / (2 eps_km 1e3)
constexpr float RCP_2EPS = (float)(1.0 / (2.0 * 0.01 * 1e3));
// w_drift: kz * (-1 / (1e3 H0))
constexpr float DRIFT = (float)(-1.0 / (1e3 * 7.0));
// thermo.dx2coord / dy2coord: / 1000 (m to km); dx2deg, dy2deg: pi RE, its
// reciprocal, deg2rad and the pole guard
constexpr float RCP_1000 = (float)(1.0 / 1000.0);
constexpr double PI = 3.141592653589793;
constexpr float PI_RE = (float)(PI * 6367.421);
constexpr float RCP_PI_RE = (float)(1.0 / (PI * 6367.421));
constexpr float DEG2RAD = (float)(PI / 180.0);
constexpr float POLE_LAT = (float)89.999;

struct Params {
  const float* lon;
  const float* lat;
  const float* p;
  const double* time;
  const float* dt;
  float* lon_out;
  float* lat_out;
  float* p_out;
  long long n, np_live;
  const float* lons;           // [nx]
  const float* lats;           // [ny]
  const float* ps;             // [npl]: ptop is its last node
  int nx, ny, npl;
  bool cartesian, reg_lon, reg_lat;
  const float* sfc;            // [nx, ny, 2, 16]: K2's surface table
  int f_pbl, f_ps;
  double t1, inv_dt;
  const float* tropo_time;     // [ntime]
  const float* tropo_lat;      // [nlat]
  const float* tropo;          // [ntime, nlat]
  int ntime, nlat;
  bool use_ref_lat;
  float ref_lat;
  bool pbl_scheme;
  float pbl_trans, dx_pbl, dx_trop, dx_strat, dz_pbl, dz_trop, dz_strat;
  unsigned long long ctr;
  long long first, total;
};

// clim_tropo at (t, lat): the float64 second of the year, the time row by
// locate_irr against it in float64, the latitude column by locate_reg in
// float32; the latitude weight and the rows in float32, the time step in
// float64 where sec - t0 makes it so; rounded to float32
__device__ __forceinline__ float clim_tropo_at(const Params& a, double t,
                                               float lat) {
  double sec = t - floor(t * RCP_YEAR_S) * YEAR_S;
  sec = sec < 0.0 ? sec + YEAR_S : sec;
  const int isec = mptrac::locate_irr<double>(a.tropo_time, a.ntime, sec);
  const int ilat = mptrac::locate_reg(a.tropo_lat, a.nlat, lat);
  const float la0 = __ldg(a.tropo_lat + ilat);
  const float la1 = __ldg(a.tropo_lat + ilat + 1);
  const float wlat = (lat - la0) / (la1 - la0);
  const float* r0 = a.tropo + (size_t)isec * a.nlat + ilat;
  const float* r1 = r0 + a.nlat;
  const float p00 = __ldg(r0), p01 = __ldg(r0 + 1);
  const float p10 = __ldg(r1), p11 = __ldg(r1 + 1);
  const float p0 = p00 + wlat * (p01 - p00);
  const float p1 = p10 + wlat * (p11 - p10);
  const float t0 = __ldg(a.tropo_time + isec);
  const float t1 = __ldg(a.tropo_time + isec + 1);
  const float slope = (p1 - p0) / (t1 - t0);
  return (float)((double)p0 + (double)slope * (sec - (double)t0));
}

// A parcel's blending weights (pbl_weight, tropo_weight): the boundary layer
// between p1 = pbl - trans (ps - pbl) and pbl, the tropopause layer between
// pt * 0.8669 and pt / 0.8669.
struct Weights {
  float pbl, pbl_p1, pt_lo, pt_hi;

  __device__ __forceinline__ float wpbl(float p) const {
    const float w = (p - pbl_p1) / (pbl != pbl_p1 ? pbl - pbl_p1 : 1.0f);
    return p > pbl ? 1.0f : (p < pbl_p1 ? 0.0f : w);
  }

  __device__ __forceinline__ float wtrop(float p) const {
    const float w = (p - pt_lo) / (pt_hi - pt_lo);
    return p > pt_hi ? 1.0f : (p < pt_lo ? 0.0f : w);
  }

  // (pbl, troposphere, stratosphere) weights at p, as kz_at builds them
  __device__ __forceinline__ void at(float p, float& w_pbl, float& w_trop,
                                     float& w_strat) const {
    w_pbl = wpbl(p);
    w_trop = wtrop(p) * (1.0f - w_pbl);
    w_strat = (1.0f - w_pbl) - w_trop;
  }

  __device__ __forceinline__ float blend(float p, float k_pbl, float k_trop,
                                         float k_strat) const {
    float w_pbl, w_trop, w_strat;
    at(p, w_pbl, w_trop, w_strat);
    return w_pbl * k_pbl + w_trop * k_trop + w_strat * k_strat;
  }
};

__global__ void __launch_bounds__(BLOCK) diff_turb_kernel(const Params a) {
  extern __shared__ float axes[];
  for (int k = threadIdx.x; k < a.nx + a.ny; k += BLOCK)
    axes[k] = k < a.nx ? a.lons[k] : a.lats[k - a.nx];
  __syncthreads();
  const HorizontalGrid grid(axes, axes + a.nx, a.nx, a.ny, a.cartesian,
                            a.reg_lon, a.reg_lat);
  const float ptop = __ldg(a.ps + a.npl - 1);
  const unsigned long long ctr0 =
      a.ctr + (unsigned long long)a.first;
  const unsigned long long row = (unsigned long long)a.total;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < a.n;
       i += stride) {
    const float lon = __ldcs(a.lon + i), lat = __ldcs(a.lat + i),
                p = __ldcs(a.p + i);
    float lon_new = lon, lat_new = lat, p_new = p;
    const float dt = __ldcs(a.dt + i);
    if (dt != 0.0f && i < a.np_live) {
      // pbl and ps: locate_3d's cell and weights, sfc_from_loc's lookup
      int ix, iy;
      float wx, wy;
      grid.locate(lon, lat, ix, iy, wx, wy);
      const double t = __ldcs(a.time + i);
      const float wt = mptrac::time_weight(t, a.t1, a.inv_dt);
      const mptrac::SfcCorners corners(ix, iy, a.nx, a.ny);
      const float pbl = corners.value(a.sfc, a.f_pbl, wx, wy, wt);
      const float ps = corners.value(a.sfc, a.f_ps, wx, wy, wt);
      if (!(a.pbl_scheme && p >= pbl)) {
        const float pt = clim_tropo_at(a, t, a.use_ref_lat ? a.ref_lat : lat);
        const Weights w{pbl, pbl - (ps - pbl) * a.pbl_trans, pt * TROPO_F,
                        pt * RCP_TROPO_F};
        float w_pbl, w_trop, w_strat;
        w.at(p, w_pbl, w_trop, w_strat);
        const float kz = w_pbl * a.dz_pbl + w_trop * a.dz_trop +
                         w_strat * a.dz_strat;
        const float kx = w_pbl * a.dx_pbl + w_trop * a.dx_trop +
                         w_strat * a.dx_strat;
        const float dt_abs = fabsf(dt);
        const unsigned long long c = ctr0 + (unsigned long long)i;

        // horizontal displacement: dx2coord, dy2coord
        if (kx > 0.0f) {
          const float sigma_h = sqrtf(2.0f * kx * dt_abs);
          const float dx = normal3_at(c) * sigma_h;
          const float dy = normal3_at(c + row) * sigma_h;
          if (a.cartesian) {
            lon_new = lon + dx;
            lat_new = lat + dy;
          } else {
            const float dxk = dx * RCP_1000;
            const bool pole = lat < -POLE_LAT || lat > POLE_LAT;
            const float denom = cosf((pole ? 0.0f : lat) * DEG2RAD) * PI_RE;
            lon_new = lon + (pole ? 0.0f : dxk * 180.0f / denom);
            lat_new = lat + dy * RCP_1000 * 180.0f * RCP_PI_RE;
          }
        }

        // vertical displacement with the drift correction, reflected at ps
        // and ptop (c:4643-4726)
        if (kz > 0.0f) {
          const float sigma_z = sqrtf(2.0f * kz * dt_abs) * 1e-3f;
          const float p_up =
              nan_min(nan_max(p + p * EPS_UP * RCP_H0, ptop), ps);
          const float p_dn =
              nan_min(nan_max(p + p * EPS_DN * RCP_H0, ptop), ps);
          const float dkz_dz =
              (w.blend(p_up, a.dz_pbl, a.dz_trop, a.dz_strat) -
               w.blend(p_dn, a.dz_pbl, a.dz_trop, a.dz_strat)) *
              RCP_2EPS;
          const float w_drift = dkz_dz + kz * DRIFT;
          const float dz_tot =
              normal3_at(c + 2 * row) * sigma_z + w_drift * dt_abs * 1e-3f;
          float pt_new = p + -dz_tot * p * RCP_H0;
          for (int k = 0; k < 10; ++k) {
            const bool above = pt_new > ps;
            if (above) pt_new = ps * ps / pt_new;
            const bool below = pt_new < ptop;
            if (below) pt_new = ptop * ptop / pt_new;
            if (!above && !below) break;
          }
          p_new = nan_min(nan_max(pt_new, ptop), ps);
        }
      }
    }
    __stcs(a.lon_out + i, lon_new);
    __stcs(a.lat_out + i, lat_new);
    __stcs(a.p_out + i, p_new);
  }
}

// Blocks of the grid-stride loop over n parcels: as many as the SMs hold at
// once, no more than the work needs.
unsigned grid_blocks(long long n, size_t smem) {
  int dev = 0, sms = 132, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, diff_turb_kernel, BLOCK, smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long need = (n + BLOCK - 1) / BLOCK;
  const long long most = (long long)per_sm * sms;
  return (unsigned)(need < most ? need : most);
}

}  // namespace

// Launches one kernel on `stream`, allocates nothing, does not synchronise
// and returns cudaGetLastError(); nothing is launched for n <= 0.  Every array
// is contiguous; the wrapper (physics/diffusion.py) checks dtypes, shapes and
// devices.  Parcel i < n moves where i < np_live and dt[i] != 0; the
// horizontal axes hold at most mptrac::SMEM_AXIS_FLOATS nodes in all; the
// draws are the columns first .. first+n-1 of a [3, total] draw from counter
// ctr.
extern "C" int diff_turb(const float* lon, const float* lat, const float* p,
                         const double* time, const float* dt, long long n,
                         long long np_live, const float* lons,
                         const float* lats, const float* ps, int nx, int ny,
                         int npl, int cartesian, int reg_lon, int reg_lat,
                         const float* sfc, int f_pbl, int f_ps, double t1,
                         double inv_dt, const float* tropo_time,
                         const float* tropo_lat, const float* tropo,
                         int ntime, int nlat, int use_ref_lat, float ref_lat,
                         int pbl_scheme, float pbl_trans, float dx_pbl,
                         float dx_trop, float dx_strat, float dz_pbl,
                         float dz_trop, float dz_strat,
                         unsigned long long ctr, long long first,
                         long long total, float* lon_out, float* lat_out,
                         float* p_out, void* stream) {
  if (n <= 0) return 0;
  const long long naxis = (long long)nx + ny;
  if (nx < 2 || ny < 2 || npl < 2 || ntime < 2 || nlat < 2 ||
      naxis > mptrac::SMEM_AXIS_FLOATS || first < 0 || total < first + n)
    return (int)cudaErrorInvalidValue;
  Params a;
  a.lon = lon; a.lat = lat; a.p = p; a.time = time; a.dt = dt;
  a.lon_out = lon_out; a.lat_out = lat_out; a.p_out = p_out;
  a.n = n; a.np_live = np_live;
  a.lons = lons; a.lats = lats; a.ps = ps;
  a.nx = nx; a.ny = ny; a.npl = npl;
  a.cartesian = cartesian; a.reg_lon = reg_lon; a.reg_lat = reg_lat;
  a.sfc = sfc; a.f_pbl = f_pbl; a.f_ps = f_ps;
  a.t1 = t1; a.inv_dt = inv_dt;
  a.tropo_time = tropo_time; a.tropo_lat = tropo_lat; a.tropo = tropo;
  a.ntime = ntime; a.nlat = nlat;
  a.use_ref_lat = use_ref_lat; a.ref_lat = ref_lat;
  a.pbl_scheme = pbl_scheme; a.pbl_trans = pbl_trans;
  a.dx_pbl = dx_pbl; a.dx_trop = dx_trop; a.dx_strat = dx_strat;
  a.dz_pbl = dz_pbl; a.dz_trop = dz_trop; a.dz_strat = dz_strat;
  a.ctr = ctr; a.first = first; a.total = total;
  const size_t smem = naxis * sizeof(float);
  diff_turb_kernel<<<grid_blocks(n, smem), BLOCK, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
