"""LZ4 raw-block codec for MET_TYPE 8 binary met containers.

Counterpart of the JAX package's ``met/lz4.py``.  The reference wraps
each 3-D field payload in LZ4_compress_default / LZ4_decompress_safe
blocks (compress_lz4, mptrac.c:1740-1857; framing: size_t length, then
the block).  ``compress`` and ``decompress`` run the native codec of the
host library (``csrc/host/lz4codec.cc``, built by ``native_loader``); a
failed build raises.  ``_compress_py`` and ``_decompress_py`` are the
plain versions that the tests hold the native codec to; they are not a
fallback.
"""

from __future__ import annotations

import numpy as np


def _native():
    from mptrac_tpu_torch.native_loader import get_library
    return get_library()


def compress(data: bytes) -> bytes:
    lib = _native()
    out = np.empty(int(lib.mt_lz4_bound(len(data))), np.uint8)
    n = lib.mt_lz4_compress(data, len(data), out)
    if n == 0 and len(data):
        raise IOError("LZ4 compression failed!")
    return out[:n].tobytes()


def decompress(data: bytes, dlen: int) -> np.ndarray:
    """The ``dlen`` decoded bytes as a writable uint8 array."""
    lib = _native()
    out = np.empty(dlen, np.uint8)
    n = lib.mt_lz4_decompress(data, len(data), out, dlen)
    if n != dlen:
        raise IOError("LZ4 decompression failed or size mismatch!")
    return out


def _compress_py(data: bytes) -> bytes:
    """Literal-only LZ4 stream (valid but uncompressed)."""
    out = bytearray()
    n = len(data)
    if n >= 15:
        out.append(15 << 4)
        rem = n - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    else:
        out.append(n << 4)
    out += data
    return bytes(out)


def _decompress_py(data: bytes, dlen: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        token = data[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                b = data[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        out += data[i:i + litlen]
        i += litlen
        if i >= n:
            break
        offset = data[i] | (data[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise IOError("LZ4 stream corrupt!")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = data[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        for _ in range(mlen):          # overlapping copies are legal
            out.append(out[-offset])
    if len(out) != dlen:
        raise IOError("LZ4 decompressed size mismatch!")
    return bytes(out)
