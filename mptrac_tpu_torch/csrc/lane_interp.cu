// K6 lane_interp: the functions of K4 (u, v, w, T) and K5 (subgrid sigma) on
// the 64-wide corner-block table [ncell, 64]: the interpolation one thread per
// parcel, the sigma once per run of parcels in one cell (below).
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
//
// The sigma mode: on sorted parcels many in a row share a cell, and a thread
// a parcel would load the same 48 wind lanes and run the same sigma16 (159
// operations) for each.  Grouping the equal cells of one warp instruction
// (__match_any_sync alone) would not help: a warp issues sigma16 once whether
// one lane or 32 run it.  So a warp takes a tile of MESO_TILE_K * 32
// consecutive parcels instead: it reads their cells (coalesced), marks the
// first parcel of each run of equal cells and numbers the runs with ballots
// and popcounts; then each lane takes a run, loads its row and computes
// sigma16 once, into shared memory, and every parcel writes its run's three
// sigmas (coalesced).  Just after a sort a tile holds one or two runs, one
// pass of sigma16 where there were eight; parcels that drifted into a
// neighbouring cell since the sort split a run into pieces; in a random order
// every parcel is a run and the warp does the eight passes it did before.
// (Merging the pieces of a split run through a window of the tile's last
// cells cost more bookkeeping a row than it saved: measured slower just after
// a sort and 5 % faster three steps after it.)  The sigma of a row is the
// same sigma16 on the same lanes, so the result is bit for bit the
// one-thread-a-parcel result.

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

// parcels of a warp's tile: MESO_TILE_K rows of 32; warps a block
constexpr int MESO_TILE_K = 8;
constexpr int MESO_TILE = 32 * MESO_TILE_K;
constexpr int MESO_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(32 * MESO_WARPS) lane_meso_kernel(
    const float* __restrict__ table64, const int* __restrict__ base,
    float* __restrict__ out, long long n) {
  // per warp: the cell of each run, then the three sigmas of each run
  __shared__ int run_cell[MESO_WARPS][MESO_TILE];
  __shared__ float run_sig[MESO_WARPS][3][MESO_TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile0 =
      ((long long)blockIdx.x * MESO_WARPS + warp) * MESO_TILE;
  if (tile0 >= n) return;  // the whole warp leaves together
  int* cells = run_cell[warp];
  float* sig = &run_sig[warp][0][0];
  const unsigned upto_lane = FULL_MASK >> (31 - lane);   // lanes <= lane

  // 1. runs of equal cells in parcel order; run[k] is the run of parcel
  //    tile0 + 32 k + lane
  int run[MESO_TILE_K];
  int nrun = 0;      // runs so far (the same in every lane)
  int prev = -1;     // cell of the last parcel of the previous row
#pragma unroll
  for (int k = 0; k < MESO_TILE_K; ++k) {
    const long long j = tile0 + 32 * k + lane;
    const bool live = j < n;
    const int b = live ? base[j] : -1;
    int before = __shfl_up_sync(FULL_MASK, b, 1);
    if (lane == 0) before = prev;
    const bool start = live && ((k == 0 && lane == 0) || b != before);
    const unsigned starts = __ballot_sync(FULL_MASK, start);
    run[k] = nrun + __popc(starts & upto_lane) - 1;
    if (start) cells[run[k]] = b;
    nrun += __popc(starts);
    prev = __shfl_sync(FULL_MASK, b, 31);
  }
  __syncwarp();

  // 2. one sigma16 a run, a run a lane
  for (int r = lane; r < nrun; r += 32) {
    float c[8][8];
    mptrac::load_row_corners<false>(table64, cells[r], c);
    float s3[3];
    mptrac::sigma16(c, s3);
    sig[r] = s3[0];
    sig[MESO_TILE + r] = s3[1];
    sig[2 * MESO_TILE + r] = s3[2];
  }
  __syncwarp();

  // 3. every parcel its run's sigmas
#pragma unroll
  for (int k = 0; k < MESO_TILE_K; ++k) {
    const long long j = tile0 + 32 * k + lane;
    if (j < n) {
      out[j] = sig[run[k]];
      out[n + j] = sig[MESO_TILE + run[k]];
      out[2 * n + j] = sig[2 * MESO_TILE + run[k]];
    }
  }
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
  const long long nblk = mptrac::grid_blocks(n, MESO_WARPS * MESO_TILE);
  if (nblk < 0) return (int)cudaErrorInvalidValue;
  lane_meso_kernel<<<dim3((unsigned)nblk), 32 * MESO_WARPS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(table64, base,
                                                               out, n);
  return (int)cudaGetLastError();
}
