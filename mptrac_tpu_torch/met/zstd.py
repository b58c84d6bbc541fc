"""ZSTD frames of the met containers, through the system's libzstd.

The containers MET_TYPE 2 with ``MET_PCK_ZSTD``, 3, 4, 5 and 7 wrap their
payloads in ZSTD frames (reference compress_zstd, mptrac.c:1624-1740).
The JAX package uses the ``zstandard`` Python module; this package binds
the C library ``libzstd.so.1`` through ``ctypes`` instead, so that it
needs no Python package beyond torch, numpy and scipy (a system may
have the library and not the module).  The frames are the standard
format either way: each side decodes the other's.  The compressed bytes
depend on the library's release (the JAX package's module bundles its
own), the decoded bytes do not.  A missing library raises naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

#: ZSTD_CONTENTSIZE_UNKNOWN and ZSTD_CONTENTSIZE_ERROR (zstd.h)
_SIZE_UNKNOWN = 2 ** 64 - 1
_SIZE_ERROR = 2 ** 64 - 2


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            f"libzstd ({name}) cannot be loaded: the met containers "
            "MET_TYPE 2 with MET_PCK_ZSTD, 3, 4, 5 and 7 need it") from e
    sz, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_versionString.restype = ctypes.c_char_p
    lib.ZSTD_compressBound.restype = sz
    lib.ZSTD_compressBound.argtypes = [sz]
    lib.ZSTD_compress.restype = sz
    lib.ZSTD_compress.argtypes = [vp, sz, ctypes.c_char_p, sz, ctypes.c_int]
    lib.ZSTD_decompress.restype = sz
    lib.ZSTD_decompress.argtypes = [vp, sz, ctypes.c_char_p, sz]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, sz]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [sz]
    return lib


def version() -> str:
    """The bound library's release, e.g. ``1.5.5``."""
    return _lib().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise IOError(f"ZSTD {what} failed: "
                      f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 3) -> bytes:
    """One ZSTD frame of ``data`` (content size in the frame header)."""
    lib = _lib()
    out = np.empty(lib.ZSTD_compressBound(len(data)), np.uint8)
    n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.size, data,
                                      len(data), level), "compression")
    return out[:n].tobytes()


def decompress(data: bytes, max_output_size: int) -> np.ndarray:
    """The decoded bytes of the ZSTD frame ``data`` as a writable uint8
    array: as many as its header states, or at most ``max_output_size``
    where it states none."""
    lib = _lib()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _SIZE_ERROR:
        raise IOError("ZSTD decompression failed: not a ZSTD frame")
    cap = max_output_size if size == _SIZE_UNKNOWN else size
    if cap > max_output_size:
        raise IOError(f"ZSTD frame of {size} B exceeds the {max_output_size} "
                      "B expected")
    out = np.empty(cap, np.uint8)
    n = _check(lib, lib.ZSTD_decompress(out.ctypes.data, cap, data,
                                        len(data)), "decompression")
    return out[:n]
