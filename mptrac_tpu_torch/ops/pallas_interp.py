"""Wind interpolation from the 8-wide per-node table.

Counterpart of the JAX package's ``ops/pallas_interp.py``:
``interp_uvw_sorted`` interpolates u, v, w in space and time from the
table of ``ops.fast_interp.build_advect_pack`` (``[ncell, 8]`` rows
(u0 v0 w0 u1 v1 w1 0 0)), the eight corners at
``base + dx*ox + dy*oy + dz``.

What differs from the JAX package by design: the TPU kernel copies a
slab of the table per block of 512 sorted parcels and flags the
parcels outside it for the caller to redo; here a thread gathers its
own parcel's corners, so parcels may come in any order (the name keeps
``_sorted`` for the caller's sake), every parcel is served and ``ok``
is all true.  (The module keeps the JAX module's name; nothing here is
Pallas.)

CUDA tensors go to the kernel in ``csrc/uvw_rows.cu`` (or raise); CPU
tensors to the plain version, which repeats the kernel's arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mptrac_tpu_torch.ops import _cuda, rk_fused

LANES = 8            # packed row width


def interp_uvw_plain(pack, base, weights, strides: Tuple[int, int]):
    """Plain PyTorch version of the kernel: [n, 3]."""
    ox, oy = strides
    b = base.to(torch.int64)
    last = pack.shape[0] - 1
    vals = [pack[torch.clamp(b + dx * ox + dy * oy + dz, max=last)]
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    u, v, w, _ = rk_fused._plain_uvwt(vals, weights[:, 0], weights[:, 1],
                                      weights[:, 2], weights[:, 3])
    return torch.stack([u, v, w], dim=1)


def interp_uvw_sorted(pack, base, weights, strides: Tuple[int, int]):
    """Interpolate (u, v, w) at located parcel positions.

    pack:     [ncell, 8] f32 packed wind table
    base:     [n] int32 table row of the lower corner
    weights:  [n, 4] f32 (wx, wy, wz, wt)
    strides:  (ox, oy) = (ny*npl, npl); a corner past the table's last
              row (base on the last node of an axis) reads the last row
    Returns (uvw [n, 3] f32, ok [n] bool), ok all true.
    """
    if pack.dim() != 2 or pack.shape[1] != LANES:
        raise ValueError("interp_uvw_sorted: expected a [ncell, 8] table, "
                         f"got {tuple(pack.shape)}")
    ox, oy = (int(s) for s in strides)
    n = base.shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=pack.device)
    if not pack.is_cuda:
        return interp_uvw_plain(pack, base, weights, (ox, oy)), ok
    return _uvw_cuda(pack, base, weights, ox, oy), ok


def _uvw_cuda(pack, base, weights, ox, oy):
    n = base.shape[0]
    dev, f32, name = pack.device, torch.float32, "uvw_rows_interp"
    t = _cuda.ptr(name, "pack", pack, f32, None, dev)
    b = _cuda.ptr(name, "base", base, torch.int32, (n,), dev)
    w = _cuda.ptr(name, "weights", weights, f32, (n, 4), dev)
    if pack.numel() >= 2 ** 31 or w % 16:
        raise ValueError("interp_uvw_sorted: table too large for 32-bit "
                         "row arithmetic, or weights not 16-byte aligned")
    out = torch.empty((n, 3), dtype=f32, device=dev)
    _cuda.call(name, dev, t, b, w, out.data_ptr(), n, ox, oy, pack.shape[0])
    return out
