"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into
one shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library goes to
``build/mptrac_tpu_torch/<hash>/`` beside the package, keyed by a hash
of the sources and flags: an edit rebuilds, a second process reuses.
Nothing here runs when the module is imported; a failure to find or run
``nvcc`` raises with the compiler's output.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from mptrac_tpu_torch.utils import timers

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "mptrac_tpu_torch")

#: one translation unit per kernel; interp_common.cuh holds the device
#: code that the interpolation kernels share
SOURCES = ("rk_fused.cu", "sfc_interp.cu", "permute_cols.cu",
           "uvwt_interp.cu", "meso_sigma.cu", "lane_interp.cu",
           "uvw_rows.cu", "probe.cu", "squares_rng.cu", "plain_interp.cu")

#: -fmad=false: no multiply-add contraction, so each kernel rounds where
#: its plain PyTorch version rounds (the kernels are bound by bytes, or,
#: the Squares draws, by integer work that the flag does not touch: it
#: costs nothing measurable); -Xptxas -v: registers and spills go to the
#: build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the device function that each launch count's wrapper launches (the
#: name a profiler's trace gives the kernel).  K3's wrapper permute_cols
#: launches permute_gather, or permute_pack and permute_rows, and its
#: plan launches permute_count; K5 is meso_sigma_table (once per met
#: pair) and meso_sigma (the gather from that table); the interp_* are
#: ops/interp's locate_3d, interp_time_3d and interp_time_2d
DEVICE_FUNCTIONS = {
    "rk_fused_advect": "rk_kernel", "sfc_interp": "sfc_kernel",
    "permute_gather": "gather_kernel", "permute_pack": "pack_kernel",
    "permute_rows": "rows_kernel", "permute_count": "count_kernel",
    "uvwt_interp": "uvwt_kernel", "meso_sigma_table": "sigma_table_kernel",
    "meso_sigma": "meso_gather_kernel", "lane_interp_uvwt": "lane_uvwt_kernel",
    "lane_meso_sigma": "lane_meso_kernel",
    "uvw_rows_interp": "uvw_rows_kernel", "probe_lane": "probe_lane_kernel",
    "probe_grid": "probe_grid_kernel", "probe_small": "probe_small_kernel",
    "squares_normal3": "squares_normal3_kernel",
    "squares_uniform": "squares_uniform_kernel",
    "squares_pairs": "squares_pairs_kernel",
    "interp_locate3d": "locate3d_kernel",
    "interp_time3d": "interp3d_time_kernel",
    "interp_time2d": "interp2d_time_kernel"}

#: launches per kernel since the last reset (the tracer's counters,
#: ``utils.timers.counters``): ``launch`` adds one where a wrapper
#: launches the kernel and nowhere else
launch_counts = timers.counters
launch_counts.update(dict.fromkeys(DEVICE_FUNCTIONS, 0))


def launch(name: str) -> None:
    """Count a launch of ``name`` (a key of ``launch_counts``); while
    tracing, stamp it with its device function.  Called just before the
    launch."""
    timers.count(name)
    timers.stamp(DEVICE_FUNCTIONS[name])


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def find_nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels of mptrac_tpu_torch cannot be "
        "built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _source_hash(), "libmptrac_kernels.so")


def build_log_path() -> str:
    return os.path.join(os.path.dirname(library_path()), "build.log")


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns the library's path.  Objects are compiled in
    parallel (one ``nvcc`` per source), then linked."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp_build_", dir=out_dir)
    log = []
    try:
        t0 = time.time()
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src),
                   "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            log.append("$ " + " ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n" + "\n".join(log))
            objs.append(obj)
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp_lib, *objs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(cmd) + "\n" + link.stdout)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n" + "\n".join(log))
        log.append(f"built in {time.time() - t0:.1f} s")
        with open(build_log_path(), "w") as f:
            f.write("\n".join(log))
        os.replace(tmp_lib, lib)    # atomic: readers see all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.rk_fused_advect.restype = i32
    lib.rk_fused_advect.argtypes = (
        [i32] + [vp] * 9 + [i64, i32, i32, i32] + [f32] * 7 + [i32] * 4
        + [vp])
    lib.rk_fused_attributes.restype = i32
    lib.rk_fused_attributes.argtypes = [i32, i32, i32, vp]
    lib.sfc_interp.restype = i32
    lib.sfc_interp.argtypes = (
        [vp] * 6 + [i64, i32, i32, i32, ctypes.c_ulonglong, vp])
    lib.permute_cols.restype = i32
    lib.permute_cols.argtypes = [
        ctypes.POINTER(vp), ctypes.POINTER(vp), i32, vp, vp, vp, i64, i32,
        i32, vp, vp]
    lib.permute_count.restype = i32
    lib.permute_count.argtypes = [vp, i64, vp, vp]
    lib.uvwt_interp.restype = i32
    lib.uvwt_interp.argtypes = [vp] * 7 + [i64, i32, i32, i32, vp]
    lib.meso_sigma_table.restype = i32
    lib.meso_sigma_table.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.meso_sigma.restype = i32
    lib.meso_sigma.argtypes = [vp] * 3 + [i64, vp]
    lib.lane_interp_uvwt.restype = i32
    lib.lane_interp_uvwt.argtypes = [vp] * 4 + [i64, vp]
    lib.lane_meso_sigma.restype = i32
    lib.lane_meso_sigma.argtypes = [vp] * 3 + [i64, vp]
    lib.uvw_rows_interp.restype = i32
    lib.uvw_rows_interp.argtypes = [vp] * 4 + [i64, i32, i32, i64, vp]
    lib.probe_lane.restype = i32
    lib.probe_lane.argtypes = [vp] * 4 + [i64, i64, vp]
    lib.probe_grid.restype = i32
    lib.probe_grid.argtypes = [vp, vp, i64, i32, vp]
    lib.probe_small.restype = i32
    lib.probe_small.argtypes = [vp] * 3 + [i64, vp]
    u64 = ctypes.c_ulonglong
    lib.squares_normal3.restype = i32
    lib.squares_normal3.argtypes = [vp, u64, i64, i64, i64, vp]
    lib.squares_uniform.restype = i32
    lib.squares_uniform.argtypes = [vp, u64, i64, i64, vp]
    lib.squares_pairs.restype = i32
    lib.squares_pairs.argtypes = [vp, u64, i64, i64, vp]
    f64 = ctypes.c_double
    lib.interp_locate3d.restype = i32
    lib.interp_locate3d.argtypes = [vp] * 6 + [i32] * 6 + [vp] * 6 + [i64, vp]
    lib.interp_time3d.restype = i32
    lib.interp_time3d.argtypes = (
        [vp] * 8 + [i64, f64, f64, vp, i64, i32, i32, i32, vp])
    lib.interp_time2d.restype = i32
    lib.interp_time2d.argtypes = (
        [vp] * 6 + [i64, f64, f64, vp, i64, i32, i32, vp])
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} was refused at launch (cudaError {code})")


def require_f32_cuda(name: str, t, shape=None) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor (of
    ``shape`` when given)."""
    import torch
    if not (isinstance(t, torch.Tensor) and t.is_cuda
            and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 CUDA "
                         f"tensor, got {t!r:.200}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def require_i32_cuda(name: str, t, shape=None) -> None:
    """Raise unless ``t`` is a contiguous int32 CUDA tensor (of
    ``shape`` when given)."""
    import torch
    if not (isinstance(t, torch.Tensor) and t.is_cuda
            and t.dtype == torch.int32 and t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous int32 CUDA "
                         f"tensor, got {t!r:.200}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def current_stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
