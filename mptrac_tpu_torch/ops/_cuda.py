"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into
one shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library goes to
``build/mptrac_tpu_torch/<hash>/`` beside the package, keyed by a hash
of the sources and flags: an edit rebuilds, a second process reuses.
Nothing here runs when the module is imported; a failure to find or run
``nvcc`` raises with the compiler's output.  There is no fallback.

``ENTRIES`` declares each C entry point once: its source, the launch
counters and device functions it runs and its argument types.  A
wrapper checks each tensor it passes with ``ptr`` and launches with
``call``, which counts the launch and runs it on the device's current
stream.
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
from typing import Dict, NamedTuple

import torch

from mptrac_tpu_torch.utils import timers

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "mptrac_tpu_torch")

#: -fmad=false: no multiply-add contraction, so each kernel rounds where
#: its plain PyTorch version rounds (the kernels are bound by bytes, or,
#: the Squares draws, by integer work that the flag does not touch: it
#: costs nothing measurable); -Xptxas -v: registers and spills go to the
#: build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Entry(NamedTuple):
    """A C entry point of the library: its source under ``csrc/``, the
    launch counters it can add, each with the device function it
    launches (the name a profiler's trace gives the kernel; none for an
    entry that launches nothing), and the ctypes of its parameters, the
    trailing stream of a launch left out."""
    source: str
    kernels: Dict[str, str]
    argtypes: tuple


vp, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_ulonglong)
f32, f64, vpp = ctypes.c_float, ctypes.c_double, ctypes.POINTER(vp)


def _entries(*rows) -> Dict[str, Entry]:
    """The table from rows (entry point, source, kernels, argtypes);
    kernels a device function names the entry's one counter, under the
    entry's own name."""
    return {name: Entry(src, {name: k} if isinstance(k, str) else k, args)
            for name, src, k, args in rows}


#: every C entry point of the library, the one place each is declared.
#: K3's permute_cols launches permute_gather, or permute_pack and
#: permute_rows, as its plan says, and the plan's count pass is
#: permute_count; K5 is meso_sigma_table (once per met pair) and
#: meso_sigma (the gather from that table); the interp_* are
#: ops/interp's locate_3d, interp_time_3d and interp_time_2d;
#: rk_fused_attributes reads the compiled K1 and launches nothing.
#: diff_turb is physics/diffusion's module_diff_turb.  interp_common.cuh
#: holds the device code that the interpolation kernels share, squares.cuh
#: the Squares draws that squares_rng.cu and diff_turb.cu share.
ENTRIES = _entries(
    ("rk_fused_advect", "rk_fused.cu", "rk_kernel",
     (i32,) + (vp,) * 9 + (i64, i32, i32, i32) + (f32,) * 7 + (i32,) * 4),
    ("rk_fused_attributes", "rk_fused.cu", {}, (i32, i32, i32, vp)),
    ("sfc_interp", "sfc_interp.cu", "sfc_kernel",
     (vp,) * 6 + (i64, i32, i32, i32, u64)),
    ("permute_cols", "permute_cols.cu",
     {"permute_gather": "gather_kernel", "permute_pack": "pack_kernel",
      "permute_rows": "rows_kernel"},
     (vpp, vpp, i32, vp, vp, vp, i64, i32, i32, vp)),
    ("permute_count", "permute_cols.cu", "count_kernel", (vp, i64, vp)),
    ("uvwt_interp", "uvwt_interp.cu", "uvwt_kernel",
     (vp,) * 7 + (i64, i32, i32, i32)),
    ("meso_sigma_table", "meso_sigma.cu", "sigma_table_kernel",
     (vp, vp, i32, i32, i32)),
    ("meso_sigma", "meso_sigma.cu", "meso_gather_kernel", (vp, vp, vp, i64)),
    ("lane_interp_uvwt", "lane_interp.cu", "lane_uvwt_kernel",
     (vp,) * 4 + (i64,)),
    ("lane_meso_sigma", "lane_interp.cu", "lane_meso_kernel",
     (vp,) * 3 + (i64,)),
    ("uvw_rows_interp", "uvw_rows.cu", "uvw_rows_kernel",
     (vp,) * 4 + (i64, i32, i32, i64)),
    ("probe_lane", "probe.cu", "probe_lane_kernel", (vp,) * 4 + (i64, i64)),
    ("probe_grid", "probe.cu", "probe_grid_kernel", (vp, vp, i64, i32)),
    ("probe_small", "probe.cu", "probe_small_kernel", (vp,) * 3 + (i64,)),
    ("squares_normal3", "squares_rng.cu", "squares_normal3_kernel",
     (vp, u64, i64, i64, i64)),
    ("squares_uniform", "squares_rng.cu", "squares_uniform_kernel",
     (vp, u64, i64, i64)),
    ("squares_pairs", "squares_rng.cu", "squares_pairs_kernel",
     (vp, u64, i64, i64)),
    ("interp_locate3d", "plain_interp.cu", "locate3d_kernel",
     (vp,) * 6 + (i32,) * 6 + (vp,) * 6 + (i64,)),
    ("interp_time3d", "plain_interp.cu", "interp3d_time_kernel",
     (vp,) * 8 + (i64, f64, f64, vp, i64, i32, i32, i32)),
    ("interp_time2d", "plain_interp.cu", "interp2d_time_kernel",
     (vp,) * 6 + (i64, f64, f64, vp, i64, i32, i32)),
    ("diff_turb", "diff_turb.cu", "diff_turb_kernel",
     (vp,) * 5 + (i64, i64) + (vp,) * 3 + (i32,) * 6
     + (vp, i32, i32, f64, f64) + (vp,) * 3 + (i32,) * 3 + (f32, i32)
     + (f32,) * 7 + (u64, i64, i64) + (vp,) * 3))

#: one translation unit per kernel file
SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values()))

#: the device function of each launch counter
DEVICE_FUNCTIONS = {c: k for e in ENTRIES.values()
                    for c, k in e.kernels.items()}

#: launches per kernel since the last reset (the tracer's counters,
#: ``utils.timers.counters``): ``launch`` adds one where ``call``
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
    for name, e in ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(e.argtypes) + ([vp] if e.kernels else [])
    return lib


def call(name: str, device, *args, counters=None) -> None:
    """Call the entry point ``name`` with ``args``.  An entry that
    launches runs on ``device``'s current stream, with ``device``
    current, and counts each of ``counters`` (default: its own) just
    before; an entry that launches nothing takes ``args`` alone.  Raises
    on a non-zero ``cudaGetLastError()``."""
    kernels = ENTRIES[name].kernels
    fn = getattr(load(), name)
    if not kernels:
        code = fn(*args)
    else:
        with torch.cuda.device(device):
            for c in kernels if counters is None else counters:
                launch(c)
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} was refused at launch (cudaError {code})")


def ptr(name: str, label: str, t, dtype, shape, device) -> int:
    """The data pointer of ``t``, the argument ``label`` of the entry
    point ``name``, checked to be what the kernel reads or writes: a
    contiguous tensor of ``dtype`` on ``device``, of ``shape`` (a tuple)
    unless that is None."""
    if not (isinstance(t, torch.Tensor) and t.device == device
            and t.dtype == dtype and t.is_contiguous()
            and (shape is None or t.shape == shape)):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}, contiguous "
               f"{t.is_contiguous()}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        of = "" if shape is None else f" of shape {tuple(shape)}"
        raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                         f"tensor{of} on {device}, got {got}")
    return t.data_ptr()
