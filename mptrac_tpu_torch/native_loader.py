"""The host library of the met readers: decode-ahead and LZ4.

Counterpart of the JAX package's ``native_loader.py``.  The C++ sources
(``csrc/host/metloader.cc``, ``csrc/host/lz4codec.cc``, this package's
own copies) are compiled with ``g++`` at first use into
``build/mptrac_tpu_torch/<hash>/libmetloader.so`` beside the package,
next to the CUDA library of ``ops/_cuda.py`` and keyed the same way by a
hash of the sources and flags, and loaded through ``ctypes``.  A failed
build raises with the compiler's output; nothing falls back to another
route.

``AsyncMetLoader`` decodes MET_TYPE 1 and 2 containers (without
``MET_PCK_ZSTD``) on a C++ thread while the device integrates: the next
met interval's file is read and unpacked in the background (reference
analog: the page-cache prefetch of mptrac_get_met, c:6222).  The native
decoder does not clamp the 3-D fields to ``BIN_3D``'s bounds;
``met/bin_io.finish_raw`` clamps them on the device, after either route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from mptrac_tpu_torch.met.bin_io import BIN_2D, BIN_3D
from mptrac_tpu_torch.utils.timers import stage

_PKG = os.path.dirname(os.path.abspath(__file__))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "mptrac_tpu_torch")
SOURCES = ("metloader.cc", "lz4codec.cc")

#: C++ compiler
CXX = "g++"
#: -ffp-contract=off: PCK's ``s * scl + off`` rounds after the product
#: and after the sum, as numpy does (GNU C++ may otherwise contract it
#: into one multiply-add)
CXX_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-std=c++17", "-Wall",
             "-Wextra", "-shared", "-fPIC")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(HOST_SRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _source_hash(), "libmetloader.so")


def build() -> str:
    """Compile the library if the one for the current sources is
    missing; returns its path.  Raises with the compiler's output when
    the compiler is missing or fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH: the host library of "
                           "mptrac_tpu_torch's met readers cannot be built")
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp_build_", dir=out_dir)
    try:
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, *(os.path.join(HOST_SRC, s) for s in SOURCES),
               "-o", tmp_lib]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}) building the met loader "
                f"library:\n$ {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp_lib, lib)    # atomic: readers see all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def get_library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(build())
    vp = ctypes.c_void_p
    lib.metloader_create.restype = vp
    lib.metloader_create.argtypes = []
    lib.metloader_destroy.restype = None
    lib.metloader_destroy.argtypes = [vp]
    lib.metloader_prefetch.restype = None
    lib.metloader_prefetch.argtypes = [vp, ctypes.c_char_p, ctypes.c_int]
    lib.metloader_wait_dims.restype = ctypes.c_int
    lib.metloader_wait_dims.argtypes = [
        vp, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.metloader_copy.restype = ctypes.c_int
    lib.metloader_copy.argtypes = [vp] + \
        [np.ctypeslib.ndpointer(np.float64)] * 3 + \
        [np.ctypeslib.ndpointer(np.float32)] * 2
    lib.mt_lz4_bound.restype = ctypes.c_size_t
    lib.mt_lz4_bound.argtypes = [ctypes.c_size_t]
    lib.mt_lz4_compress.restype = ctypes.c_size_t
    lib.mt_lz4_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, np.ctypeslib.ndpointer(np.uint8)]
    lib.mt_lz4_decompress.restype = ctypes.c_size_t
    lib.mt_lz4_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_size_t]
    return lib


class AsyncMetLoader:
    """Decode-ahead reader of MET_TYPE 1 and 2 binary containers."""

    def __init__(self):
        self._lib = get_library()
        self._h = self._lib.metloader_create()

    def close(self):
        """Stop the decode thread (it finishes the file in hand)."""
        if getattr(self, "_h", None):
            self._lib.metloader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def prefetch(self, path: str, met_type: int = 1):
        """Begin decoding ``path`` in the background."""
        self._lib.metloader_prefetch(self._h, path.encode(), met_type)

    def wait(self, timings=None):
        """Block for the decode and return the raw met dict with host
        arrays (the 3-D fields not clamped yet).  ``timings``, when
        given, gets the seconds blocked (``wait``) and of the copy out of
        the loader (``copy``) added; both are spans of those names."""
        time = ctypes.c_double()
        nx, ny, npl = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with stage("wait", timings):
            ok = self._lib.metloader_wait_dims(
                self._h, ctypes.byref(time), ctypes.byref(nx),
                ctypes.byref(ny), ctypes.byref(npl))
        if not ok:
            raise IOError("native met decode failed")
        with stage("copy", timings):
            nx, ny, npl = nx.value, ny.value, npl.value
            lon = np.empty(nx, np.float64)
            lat = np.empty(ny, np.float64)
            p = np.empty(npl, np.float64)
            nxy, n3 = nx * ny, nx * ny * npl
            f2flat = np.empty(len(BIN_2D) * nxy, np.float32)
            f3flat = np.empty(len(BIN_3D) * n3, np.float32)
            ok = self._lib.metloader_copy(self._h, lon, lat, p, f2flat,
                                          f3flat)
        if not ok:
            raise IOError("native met copy failed")
        f2 = {name: f2flat[i * nxy:(i + 1) * nxy].reshape(nx, ny)
              for i, name in enumerate(BIN_2D)}
        f3 = {name: f3flat[i * n3:(i + 1) * n3].reshape(nx, ny, npl)
              for i, (name, _, _) in enumerate(BIN_3D)}
        return dict(time=time.value, lon=lon, lat=lat, p=p,
                    hybrid=np.zeros(npl), fields2d=f2, fields3d=f3,
                    npl_ml=0)
