// K3 permute_cols: out[c][i] = in[c][perm[i]] for every state column of the
// sort: up to 32 float32 columns and one float64 column.
//
// Replaces the Pallas kernel mptrac_tpu/ops/slab_interp.py:_kernel in mode
// "gather8" (reached through permute_f32_cols from sort._take_f32_pairs).
// That kernel serves only banded permutations and needs a guard and a
// fallback; both paths here read each output's own source index, so any
// permutation is exact and there is no guard.
//
// What bounds it on an H100: bytes, counted as 32-byte sectors.  A gather
// of one 4-byte value from a random place costs a whole sector, 8x its
// payload, in every column.  permute_count (a pass over every 8th block of
// perm) counts the sectors that a gather of one float32 column starts
// there, and the wrapper (ops/slab_interp.permute_plan) picks one of two
// paths:
//   * gather path, where neighbours in the new order mostly were
//     neighbours before (the identity, a re-sort of drifted parcels):
//     gather_kernel, one output a thread reading each column at its source.
//     Bound by the sectors that count.
//   * row path, where they were not (the first sort of a run): pack_kernel
//     writes the state in the old order as one row a parcel (the float64
//     first, then the float32 columns, 16-byte multiples), staged through
//     shared memory so the rows leave as contiguous 16-byte stores;
//     rows_kernel reads each output's source row with 16-byte loads (2
//     random sectors for the flagship's 48-byte row instead of 10) and
//     writes the columns coalesced.  Bound by those random row reads; the
//     rows are the caller's scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kBlock = 256;
// permute_count reads every kCountEvery-th block of kBlock outputs
constexpr int kCountEvery = 8;

struct PermArgs {
  const float* src[kMaxCols];
  float* dst[kMaxCols];
  const double* src64;
  double* dst64;
  int ncols;
};

// ---------------------------------------------------------------- count

// *count += the outputs, of every kCountEvery-th block of kBlock from the
// first, that start a 32-byte sector of a float32 column in the gather: the
// first of every 32 (a warp's first lane), and those whose source lies in
// another sector than the previous output's.  Block b of the grid-stride
// loop reads output block b * kCountEvery.
__global__ void __launch_bounds__(kBlock) count_kernel(
    const long long* __restrict__ perm, long long n,
    unsigned long long* __restrict__ count) {
  unsigned int c = 0;
  const long long nb = (n + kBlock - 1) / kBlock;
  for (long long b = blockIdx.x; b * kCountEvery < nb; b += gridDim.x) {
    const long long i = b * kCountEvery * kBlock + threadIdx.x;
    const bool fresh = i < n && (i % 32 == 0 || (__ldg(perm + i) >> 3) !=
                                                    (__ldg(perm + i - 1) >> 3));
    c += fresh ? 1u : 0u;
  }
  const unsigned int w = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) atomicAdd(count, (unsigned long long)w);
}

// ----------------------------------------------------------- gather path

__global__ void __launch_bounds__(kBlock) gather_kernel(
    PermArgs a, const long long* __restrict__ perm, long long n) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
#pragma unroll 8
  for (int c = 0; c < a.ncols; ++c) a.dst[c][i] = __ldg(a.src[c] + j);
  if (a.src64 != nullptr) a.dst64[i] = __ldg(a.src64 + j);
}

// ------------------------------------------------------------- row path

// Row layout: words [0, 2) the float64 column when there is one, then the
// float32 columns; `rw` words a row, a multiple of 4.  A block stages its
// kBlock rows in shared memory and stores them as one contiguous range.
__global__ void __launch_bounds__(kBlock) pack_kernel(
    PermArgs a, long long n, int rw, float* __restrict__ rows) {
  extern __shared__ float4 s_rows4[];
  float* s_rows = reinterpret_cast<float*>(s_rows4);
  const long long r0 = (long long)blockIdx.x * kBlock;
  const long long i = r0 + threadIdx.x;
  const int off = a.src64 != nullptr ? 2 : 0;
  if (i < n) {
    float* row = s_rows + threadIdx.x * rw;
    if (a.src64 != nullptr) {
      const double t = __ldg(a.src64 + i);
      row[0] = __int_as_float(__double2loint(t));
      row[1] = __int_as_float(__double2hiint(t));
    }
#pragma unroll 8
    for (int c = 0; c < a.ncols; ++c) row[off + c] = __ldg(a.src[c] + i);
  }
  __syncthreads();
  const int nrows = (int)min((long long)kBlock, n - r0);
  const int nvec = nrows * rw / 4;
  float4* dst = reinterpret_cast<float4*>(rows + r0 * rw);
  for (int q = threadIdx.x; q < nvec; q += kBlock) dst[q] = s_rows4[q];
}

// One output a thread: its source row as NV 16-byte loads, then each
// column's value to its own coalesced store.
template <int NV>
__global__ void __launch_bounds__(kBlock) rows_kernel(
    PermArgs a, const long long* __restrict__ perm, long long n,
    const float4* __restrict__ rows) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const long long j = __ldg(perm + i);
  float w[4 * NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 x = __ldg(rows + j * NV + v);
    w[4 * v] = x.x; w[4 * v + 1] = x.y; w[4 * v + 2] = x.z; w[4 * v + 3] = x.w;
  }
  int off = 0;
  if (a.src64 != nullptr) {
    a.dst64[i] = __hiloint2double(__float_as_int(w[1]), __float_as_int(w[0]));
    off = 2;
  }
#pragma unroll
  for (int c = 0; c < 4 * NV; ++c)
    if (c >= off && c - off < a.ncols) a.dst[c - off][i] = w[c];
}

}  // namespace

// count: one zeroed device counter (see count_kernel).  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int permute_count(const long long* perm, long long n,
                             unsigned long long* count, void* stream) {
  if (n <= 0) return 0;
  long long nblk = ((n + kBlock - 1) / kBlock + kCountEvery - 1) / kCountEvery;
  if (nblk > 132 * 16) nblk = 132 * 16;
  count_kernel<<<(unsigned)nblk, kBlock, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(perm, n, count);
  return (int)cudaGetLastError();
}

// `src32` / `dst32` are host arrays of ncols32 device pointers; `src64` /
// `dst64` may be null.  path 0: the gather path; path 1: the row path
// through `rows`, n rows of `rw` words (a multiple of 4 that holds the row;
// rows 16-byte aligned).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int permute_cols(const void* const* src32, void* const* dst32,
                            int ncols32, const void* src64, void* dst64,
                            const long long* perm, long long n, int path,
                            int rw, void* rows, void* stream) {
  if (n <= 0) return 0;
  if (ncols32 < 0 || ncols32 > kMaxCols) return (int)cudaErrorInvalidValue;
  if (ncols32 == 0 && src64 == nullptr) return 0;
  PermArgs a;
  for (int c = 0; c < kMaxCols; ++c) {
    a.src[c] = c < ncols32 ? static_cast<const float*>(src32[c]) : nullptr;
    a.dst[c] = c < ncols32 ? static_cast<float*>(dst32[c]) : nullptr;
  }
  a.src64 = static_cast<const double*>(src64);
  a.dst64 = static_cast<double*>(dst64);
  a.ncols = ncols32;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long nblk = (n + kBlock - 1) / kBlock;
  if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  const unsigned g = (unsigned)nblk;
  if (path == 0) {
    gather_kernel<<<g, kBlock, 0, st>>>(a, perm, n);
    return (int)cudaGetLastError();
  }
  if (path != 1 || rows == nullptr || rw % 4 != 0
      || rw < ncols32 + (src64 != nullptr ? 2 : 0) || rw > 36)
    return (int)cudaErrorInvalidValue;
  pack_kernel<<<g, kBlock, kBlock * rw * sizeof(float), st>>>(
      a, n, rw, static_cast<float*>(rows));
  const float4* r = static_cast<const float4*>(rows);
  switch (rw / 4) {
    case 1: rows_kernel<1><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 2: rows_kernel<2><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 3: rows_kernel<3><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 4: rows_kernel<4><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 5: rows_kernel<5><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 6: rows_kernel<6><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 7: rows_kernel<7><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 8: rows_kernel<8><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    case 9: rows_kernel<9><<<g, kBlock, 0, st>>>(a, perm, n, r); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
