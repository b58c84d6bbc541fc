// Native met-file loader: decode of the binary met container and a
// decode-ahead thread, for mptrac_tpu_torch/native_loader.py.
//
// Host counterpart of the reference's met ingest (mptrac.c read_met_bin
// c:8563, compress_pck c:986, and the page-cache prefetch
// `cat file > /dev/null &` in mptrac_get_met c:6222).  The library decodes
// the MPTRAC binary container (version 104, raw or PCK-quantized
// payloads) with OpenMP-parallel unpacking, and a background thread
// decodes the *next* file while the current met interval integrates.
// The fields come back unclamped; the Python side clamps them to the
// container's bounds on the device, as it does after its own reader.
//
// Built at first use by native_loader.build() with
//   g++ -O3 -fopenmp -ffp-contract=off -shared -fPIC metloader.cc lz4codec.cc
// (-ffp-contract=off: PCK's s * scl + off rounds twice, as numpy does).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kVersion = 104;
constexpr int kN2d = 24;
constexpr int kN3d = 13;

struct MetData {
  double time = 0;
  int nx = 0, ny = 0, np = 0;
  std::vector<double> lon, lat, p;
  // 2-D fields [kN2d][nx*ny], 3-D fields [kN3d][nx*ny*np]
  std::vector<std::vector<float>> f2d;
  std::vector<std::vector<float>> f3d;
  std::string error;
  bool ok = false;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

// Decode one file into `out`.  met_type: 1 = raw float payloads,
// 2 = PCK 16-bit per-level quantization.
void decode_file(const char* path, int met_type, MetData* out) {
  out->ok = false;
  FILE* f = fopen(path, "rb");
  if (!f) {
    out->error = "cannot open file";
    return;
  }
  int ftype = 0, version = 0;
  if (!read_exact(f, &ftype, 4) || !read_exact(f, &version, 4) ||
      ftype != met_type || version != kVersion) {
    out->error = "bad header";
    fclose(f);
    return;
  }
  if (!read_exact(f, &out->time, 8)) { fclose(f); return; }
  if (!read_exact(f, &out->nx, 4) || !read_exact(f, &out->ny, 4) ||
      !read_exact(f, &out->np, 4)) { fclose(f); return; }
  const size_t nx = out->nx, ny = out->ny, np = out->np;
  if (nx < 2 || ny < 2 || np < 2 || nx > 10000 || ny > 10000 ||
      np > 1000) {
    out->error = "bad dimensions";
    fclose(f);
    return;
  }
  out->lon.resize(nx);
  out->lat.resize(ny);
  out->p.resize(np);
  if (!read_exact(f, out->lon.data(), nx * 8) ||
      !read_exact(f, out->lat.data(), ny * 8) ||
      !read_exact(f, out->p.data(), np * 8)) { fclose(f); return; }

  const size_t nxy = nx * ny;
  out->f2d.assign(kN2d, {});
  for (int i = 0; i < kN2d; i++) {
    out->f2d[i].resize(nxy);
    if (!read_exact(f, out->f2d[i].data(), nxy * 4)) {
      out->error = "truncated 2-D field";
      fclose(f);
      return;
    }
  }
  const size_t n3 = nxy * np;
  out->f3d.assign(kN3d, {});
  for (int i = 0; i < kN3d; i++) {
    out->f3d[i].resize(n3);
    if (met_type == 1) {
      if (!read_exact(f, out->f3d[i].data(), n3 * 4)) {
        out->error = "truncated 3-D field";
        fclose(f);
        return;
      }
    } else if (met_type == 2) {
      // PCK payload: scl[np] f64, off[np] f64, samples u16[nxy*np]
      std::vector<double> scl(np), off(np);
      std::vector<uint16_t> s(n3);
      if (!read_exact(f, scl.data(), np * 8) ||
          !read_exact(f, off.data(), np * 8) ||
          !read_exact(f, s.data(), n3 * 2)) {
        out->error = "truncated PCK payload";
        fclose(f);
        return;
      }
      float* dst = out->f3d[i].data();
#pragma omp parallel for
      for (long ixy = 0; ixy < (long)nxy; ixy++)
        for (size_t iz = 0; iz < np; iz++)
          dst[ixy * np + iz] =
              (float)(s[ixy * np + iz] * scl[iz] + off[iz]);
    } else {
      out->error = "unsupported met_type";
      fclose(f);
      return;
    }
  }
  int final_marker = 0;
  if (!read_exact(f, &final_marker, 4) || final_marker != 999) {
    out->error = "missing end marker";
    fclose(f);
    return;
  }
  fclose(f);
  out->ok = true;
}

// ---- Prefetch manager -----------------------------------------------------

struct Loader {
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::string pending_path;
  int pending_type = 1;
  bool has_request = false;
  bool stop = false;
  MetData result;
  bool result_ready = false;

  Loader() {
    worker = std::thread([this] { run(); });
  }
  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    worker.join();
  }
  void run() {
    for (;;) {
      std::string path;
      int met_type;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return has_request || stop; });
        if (stop) return;
        path = pending_path;
        met_type = pending_type;
        has_request = false;
      }
      MetData data;
      decode_file(path.c_str(), met_type, &data);
      {
        std::lock_guard<std::mutex> lk(mu);
        result = std::move(data);
        result_ready = true;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* metloader_create() { return new Loader(); }

void metloader_destroy(void* h) { delete static_cast<Loader*>(h); }

// Start decoding `path` in the background.
void metloader_prefetch(void* h, const char* path, int met_type) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->pending_path = path;
    L->pending_type = met_type;
    L->has_request = true;
    L->result_ready = false;
  }
  L->cv.notify_all();
}

// Block until the prefetched file is decoded; returns 1 on success and
// fills the dimension outputs.
int metloader_wait_dims(void* h, double* time, int* nx, int* ny,
                        int* np) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [L] { return L->result_ready; });
  if (!L->result.ok) return 0;
  *time = L->result.time;
  *nx = L->result.nx;
  *ny = L->result.ny;
  *np = L->result.np;
  return 1;
}

// Copy the decoded data into caller-provided buffers (numpy arrays).
// axes: lon[nx] lat[ny] p[np]; f2d: kN2d contiguous blocks of nx*ny;
// f3d: kN3d contiguous blocks of nx*ny*np.
int metloader_copy(void* h, double* lon, double* lat, double* p,
                   float* f2d, float* f3d) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  if (!L->result_ready || !L->result.ok) return 0;
  const MetData& m = L->result;
  memcpy(lon, m.lon.data(), m.lon.size() * 8);
  memcpy(lat, m.lat.data(), m.lat.size() * 8);
  memcpy(p, m.p.data(), m.p.size() * 8);
  const size_t nxy = (size_t)m.nx * m.ny;
  for (int i = 0; i < kN2d; i++)
    memcpy(f2d + (size_t)i * nxy, m.f2d[i].data(), nxy * 4);
  const size_t n3 = nxy * m.np;
  for (int i = 0; i < kN3d; i++)
    memcpy(f3d + (size_t)i * n3, m.f3d[i].data(), n3 * 4);
  return 1;
}

// Synchronous decode convenience (no background thread involved).
int metloader_decode_sync(const char* path, int met_type, double* time,
                          int* nx, int* ny, int* np) {
  MetData data;
  decode_file(path, met_type, &data);
  if (!data.ok) return 0;
  *time = data.time;
  *nx = data.nx;
  *ny = data.ny;
  *np = data.np;
  return 1;
}

}  // extern "C"
