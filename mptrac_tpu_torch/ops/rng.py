"""Parallel random number generation.

Counterpart of the JAX package's ``ops/rng.py``: the **Squares**
counter-based RNG (Widynski 2022) of the reference ``module_rng``
(mptrac.c:5598-5667, RNG_TYPE 1), bit for bit: same key, same counter
advance, same Box-Muller pairing with the reference's single-precision
cos/sin quirk.

PyTorch has next to no unsigned 64-bit operators, so the chain runs on
``int64``: products and sums wrap mod 2^64 exactly like ``uint64``, but
``>>`` is an arithmetic shift, so every right shift is followed by a
mask.  The counter itself is a Python int kept mod 2^64 on the host.

RNG_TYPE 2 is the JAX package's ``jax.random`` threefry stream
(``threefry2x32`` with 20 rounds, ``fold_in`` of the counter's low word
into ``PRNGKey(0)``, the partitionable bit layout, JAX's uniform and
normal), on ``int64`` words held in [0, 2^32).  Its bits and uniforms
are JAX's bit for bit; the normals are ``sqrt(2) * erfinv(u)`` with
PyTorch's ``erfinv``, which is not XLA's polynomial.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

#: Squares key (reference mptrac.c:5601, fixed, do not change)
SQUARES_KEY = 0xC8E4FD154CE32F6D

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF

#: parcels per pass of the f32 bit chain: each int64 temporary of a
#: pass is 8 bytes a parcel, so the chain's peak stays at a few hundred
#: MB whatever the ensemble size
RNG_CHUNK = 1 << 24


def _signed(x: int) -> int:
    """Two's-complement int64 value of a Python int taken mod 2^64."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


_KEY = _signed(SQUARES_KEY)


def _rot32(x):
    """Rotate a 64-bit pattern held in int64 by 32 bits."""
    return ((x >> 32) & _M32) | (x << 32)


def _squares_core(ctr64):
    """Squares rounds over counter values (int64 bit patterns); returns
    the 64 output bits as (hi, lo) int64 tensors in [0, 2^32)."""
    x = ctr64 * _KEY
    y = x
    z = y + _KEY
    x = _rot32(x * x + y)
    x = _rot32(x * x + z)
    x = _rot32(x * x + y)
    t = x * x + z
    x = _rot32(t)
    r = t ^ (((x * x + y) >> 32) & _M32)
    return (r >> 32) & _M32, r & _M32


def _counters(ctr: int, start: int, count: int, device):
    """int64 bit patterns of ctr+start .. ctr+start+count-1 (mod 2^64)."""
    return (torch.arange(count, dtype=torch.int64, device=device)
            + _signed(ctr + start))


def squares_bits(ctr: int, n: int, device="cuda"):
    """Raw Squares bits for counters ctr..ctr+n as (hi, lo) int64
    tensors holding 32-bit values (reference c:5598-5630)."""
    return _squares_core(_counters(ctr, 0, n + 1, device))


def squares_uniform(ctr: int, n: int, device="cuda"
                    ) -> Tuple[torch.Tensor, int]:
    """``n + 1`` uniform doubles in [0, 1) and the advanced counter
    (reference c:5598-5630: the loop runs ``i <= n`` and the counter
    advances by ``n + 1``)."""
    hi32, lo32 = squares_bits(ctr, n, device)
    # hi*2^32 is exact and the sum rounds to nearest, like the C cast
    # of the uint64; the words are non-negative, so the int64 -> double
    # conversion never sees a sign
    u = (hi32.to(torch.float64) * 4294967296.0
         + lo32.to(torch.float64)) * (0.5 ** 64)
    return u, (ctr + n + 1) & _M64


def squares_normal(ctr: int, n: int, device="cuda", start: int = 0
                   ) -> Tuple[torch.Tensor, int]:
    """``n`` standard-normal doubles via the reference's Box-Muller
    transform (c:5632-5648): pairs (r cos phi, r sin phi) with phi
    evaluated in single precision (``cosf((float) phi)``).  ``start``
    > 0 gives the normals ``start .. start+n-1`` of a longer draw (each
    pair is a function of its two counters alone); the returned counter
    is then that of a draw of ``n`` from ``ctr``."""
    m0 = start // 2
    m = (start + n + 1) // 2 - m0             # pairs that cover the range
    u = _uniform_at(ctr, 2 * m0, 2 * m, device)
    evens = u[0::2]
    odds = u[1::2]
    r = torch.sqrt(-2.0 * torch.log(evens))
    phif = (2.0 * math.pi * odds).to(torch.float32)
    out_e = r * torch.cos(phif).to(torch.float64)
    out_o = r * torch.sin(phif).to(torch.float64)
    k = start - 2 * m0
    out = torch.stack([out_e, out_o], dim=1).reshape(-1)[k:k + n]
    return out, (ctr + n + 1) & _M64


def _uniform_at(ctr: int, start: int, count: int, device):
    """The uniform doubles of counters ctr+start .. ctr+start+count-1
    (squares_uniform's values)."""
    hi32, lo32 = _squares_core(_counters(ctr, start, count, device))
    return (hi32.to(torch.float64) * 4294967296.0
            + lo32.to(torch.float64)) * (0.5 ** 64)


def squares_uniform_f32(ctr: int, n: int, device="cuda", start: int = 0
                        ) -> Tuple[torch.Tensor, int]:
    """``n + 1`` float32 uniforms from the same Squares bit stream (fp32
    compute mode): the top 24 bits of each 64-bit draw, scaled by
    2^-24.  Same counter advance as ``squares_uniform``.  The chain runs
    in passes of ``RNG_CHUNK`` draws, which bounds its int64
    temporaries.  ``start`` shifts the counters (a slice of a longer
    draw)."""
    dev = torch.device(device)
    out = torch.empty(n + 1, dtype=torch.float32, device=dev)
    for s in range(0, n + 1, RNG_CHUNK):
        cnt = min(RNG_CHUNK, n + 1 - s)
        hi, _ = _squares_core(_counters(ctr, start + s, cnt, dev))
        torch.mul((hi >> 8).to(torch.float32), 0.5 ** 24,
                  out=out[s:s + cnt])
        del hi
    return out, (ctr + n + 1) & _M64


def squares_normal_f32(ctr: int, n: int, device="cuda", start: int = 0
                       ) -> Tuple[torch.Tensor, int]:
    """``n`` float32 Box-Muller normals over the float32 uniform stream
    (fp32 compute mode; the pairing of ``squares_normal``).  ``start``
    gives the normals ``start .. start+n-1`` of a longer draw, as
    ``squares_normal``."""
    m0 = start // 2
    m = (start + n + 1) // 2 - m0             # pairs that cover the range
    u, _ = squares_uniform_f32(ctr, 2 * m - 1, device, start=2 * m0)
    evens = torch.clamp(u[0::2], min=0.5 ** 25)
    odds = u[1::2]
    r = torch.sqrt(-2.0 * torch.log(evens))
    phi = (2.0 * 3.141592653589793) * odds   # the factor rounds to float32
    out_e = r * torch.cos(phi)
    out_o = r * torch.sin(phi)
    k = start - 2 * m0
    out = torch.stack([out_e, out_o], dim=1).reshape(-1)[k:k + n]
    return out, (ctr + n + 1) & _M64


def squares_normal3_f32(ctr: int, n: int, device="cuda",
                        part: Tuple[int, int] = None
                        ) -> Tuple[torch.Tensor, int]:
    """Three component-major float32 normal streams from the Squares
    counter (fp32 compute mode).

    Each (component c, parcel p) takes one 64-bit draw at counter
    ``ctr + c*n + p``; the Box-Muller radius comes from its high 24
    bits, the phase from the low 24 bits of the low word.  Counter
    advance stays ``3n + 1`` like the reference.  The integer chain is
    bit-identical to the JAX package's; only the transcendentals may
    differ by ulps between math libraries.  ``part`` = (first, total):
    the parcels first .. first+n-1 of a draw for ``total`` parcels.
    """
    dev = torch.device(device)
    first, total = (0, n) if part is None else part
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    two_pi = 2.0 * 3.141592653589793     # rounds to float32 in the product
    for c in range(3):
        for s in range(0, n, RNG_CHUNK):
            cnt = min(RNG_CHUNK, n - s)
            hi, lo = _squares_core(_counters(ctr, c * total + first + s,
                                             cnt, dev))
            u_r = torch.clamp((hi >> 8).to(torch.float32) * (0.5 ** 24),
                              min=0.5 ** 25)
            u_phi = (lo >> 8).to(torch.float32) * (0.5 ** 24)
            del hi, lo
            r = torch.sqrt(-2.0 * torch.log(u_r))
            torch.mul(r, torch.cos(two_pi * u_phi), out=out[c, s:s + cnt])
    return out, (ctr + 3 * total + 1) & _M64


#: rotation distances of threefry2x32's two groups of four rounds
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x0, x1):
    """The Threefry-2x32 hash with 20 rounds (JAX ``prng.py``
    ``_threefry2x32_lowering``) of the words ``x0``, ``x1`` under the key
    ``(k1, k2)``.  The words are Python ints or int64 tensors holding
    values in [0, 2^32); so are the results."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_key(ctr: int):
    """``jax.random.fold_in(PRNGKey(0), uint32(ctr))``: the counter's low
    word hashed under the zero key as the count pair (0, word)."""
    return threefry2x32(0, 0, 0, ctr & _M32)


def threefry_bits(key, start: int, count: int, width: int, device="cuda"):
    """JAX's random bits (``_threefry_random_bits_partitionable``) of the
    flat indices ``start .. start+count-1`` of a draw: each index, as a
    64-bit count split into (hi, lo) words, hashed under ``key``.  Width
    32 gives ``hi ^ lo`` of the hash in [0, 2^32), width 64 the int64
    pattern of ``hi << 32 | lo``."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], (i >> 32) & _M32, i & _M32)
    del i
    return b1 ^ b2 if width == 32 else (b1 << 32) | b2


def _bits_to_unit(bits, dtype):
    """JAX's ``_uniform`` mantissa trick: the top mantissa bits under the
    exponent of 1.0, as floats in [0, 1)."""
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    else:
        f = (((bits >> 12) & ((1 << 52) - 1))
             | 0x3FF0000000000000).view(torch.float64)
    return f - 1.0


def threefry_draw(ctr: int, n: int, shape, normal: bool, dtype,
                  device="cuda", ranges=None) -> torch.Tensor:
    """``jax.random.uniform`` (``normal`` False) or ``jax.random.normal``
    of ``shape`` (``n`` elements) under the key of ``ctr``, in passes of
    ``RNG_CHUNK`` elements.  float32 takes 32-bit draws, float64 64-bit
    ones.  The normal is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
    ``(nextafter(-1, 0), 1)``, as JAX's ``_normal_real``.  ``ranges``,
    (first, count) pairs of flat indices that add up to ``n``, take those
    elements of a larger draw, in order (one shard's slice)."""
    dev = torch.device(device)
    key = threefry_key(ctr)
    width = 32 if dtype == torch.float32 else 64
    out = torch.empty(n, dtype=dtype, device=dev)
    lo = float(np.nextafter(np.array(-1.0, _NP[dtype]),
                            np.array(0.0, _NP[dtype])))
    # (1 - lo) rounds to 2.0 in both precisions, so u = 2 f + lo exactly
    scale = float(np.array(1.0, _NP[dtype]) - np.array(lo, _NP[dtype]))
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=dev)
    o = 0
    for first, count in ((0, n),) if ranges is None else ranges:
        for s in range(0, count, RNG_CHUNK):
            cnt = min(RNG_CHUNK, count - s)
            f = _bits_to_unit(threefry_bits(key, first + s, cnt, width, dev),
                              dtype)
            if normal:
                u = torch.clamp(f * scale + lo, min=lo)
                torch.mul(sqrt2, torch.special.erfinv(u),
                          out=out[o:o + cnt])
            else:
                torch.clamp(f, min=0.0, out=out[o:o + cnt])
            o += cnt
    return out.reshape(shape)


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def module_rng(ctl_rng_type: int, ctr: int, n: int, method: int,
               dtype=torch.float64, device="cuda", part=None
               ) -> Tuple[torch.Tensor, int]:
    """``n`` uniform (``method`` 0) or standard-normal (1) draws and the
    advanced counter, as the reference ``module_rng`` (c:5535) draws
    them with the Squares generator.  float32 uses the float32
    formulations (``squares_uniform_f32``, ``squares_normal_f32``),
    float64 the reference's stream.  RNG_TYPE 2 draws from threefry
    (``threefry_draw``) and advances the counter by ``n + 1`` too.
    ``part`` = (first, total) (``Cache.rng_part``): the draws first ..
    first+n-1 of a draw of ``total``, and the counter of that draw."""
    first, total = (0, n) if part is None else part
    adv = (ctr + total + 1) & _M64
    if ctl_rng_type not in (0, 1):
        return (threefry_draw(ctr, n, (n,), method != 0, dtype, device,
                              ranges=[(first, n)]), adv)
    if dtype == torch.float32:
        if method == 0:
            u, _ = squares_uniform_f32(ctr, n, device, start=first)
            return u[:n], adv
        return squares_normal_f32(ctr, n, device, start=first)[0], adv
    if method == 0:
        return _uniform_at(ctr, first, n, device).to(dtype), adv
    rs, _ = squares_normal(ctr, n, device, start=first)
    return rs.to(dtype), adv


def module_rng3(ctl_rng_type: int, ctr: int, n: int,
                dtype=torch.float64, device="cuda", part=None
                ) -> Tuple[torch.Tensor, int]:
    """Draw 3 standard normals per parcel as a component-major [3, n]
    tensor.

    RNG_TYPE 0 and 1 (Squares): f64 (parity mode) reproduces the
    reference's exact interleaved stream (module_rng method 1,
    c:5632-5648) and transposes; f32 uses the contiguous formulation
    (squares_normal3_f32).  RNG_TYPE 2: JAX's threefry normals of shape
    [3, n] (``threefry_draw``).  The counter advances by ``3n + 1``
    either way.  ``part`` = (first, total) (``Cache.rng_part``): the
    columns first .. first+n-1 of the [3, total] draw, and the counter
    advanced by ``3 total + 1``."""
    first, total = (0, n) if part is None else part
    adv = (ctr + 3 * total + 1) & _M64
    if ctl_rng_type not in (0, 1):
        return (threefry_draw(ctr, 3 * n, (3, n), True, dtype, device,
                              ranges=[(c * total + first, n)
                                      for c in range(3)]), adv)
    if dtype == torch.float32:
        return squares_normal3_f32(ctr, n, device, part=(first, total))
    rs, _ = squares_normal(ctr, 3 * n, device, start=3 * first)
    return rs.to(dtype).reshape(n, 3).T, adv
