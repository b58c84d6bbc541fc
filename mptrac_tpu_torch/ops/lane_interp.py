"""Interpolation and subgrid sigma from the 64-wide corner-block table.

Counterpart of the JAX package's ``ops/lane_interp.py``:
``interp_uvwt_sorted`` and ``meso_sigma_sorted`` compute what
``ops.slab_interp.interp_uvwt`` and ``meso_sigma`` compute, from the
table of ``ops.fast_interp.build_advect_pack64`` (``[ncell, 64]``, one
row holds a cell's whole 2x2x2 corner block of both snapshots), so a
parcel reads one contiguous 256-byte row instead of eight 32-byte
nodes, from a table eight times as large.

What differs from the JAX package by design: the table is read
row-major.  Its transposed copy ``[64, ncell]``, the 128-cell windows
and the straggler repair exist for the TPU's lane gather; here a thread
reads its own parcel's row, parcels may come in any order (the names
keep ``_sorted`` for the caller's sake), every parcel is served and the
served fraction is the constant 1.0.  ``base`` is the row
``(ix*ny + iy)*npl + iz`` of the parcel's cell.

CUDA tensors go to the kernels in ``csrc/lane_interp.cu`` (or raise);
CPU tensors to the plain versions, which repeat the kernels'
arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mptrac_tpu_torch.ops import _cuda, rk_fused
from mptrac_tpu_torch.ops.fast_interp import build_advect_pack64
from mptrac_tpu_torch.types import Met

LANES = 64          # table row width


class LaneTables(NamedTuple):
    """The packed table of the lane kernels."""
    pack64: torch.Tensor        # [ncell, 64] f32


def build_lane_tables(met01: Met) -> LaneTables:
    return LaneTables(pack64=build_advect_pack64(met01))


def _corner_rows(pack64, base):
    """8 corner rows [n, 8] (u0,v0,w0,u1,v1,w1,t0,t1) out of each
    parcel's table row."""
    rows = pack64[base.to(torch.int64)]                # [n, 64]
    return [torch.cat([rows[:, 6 * k:6 * k + 6],
                       rows[:, 48 + 2 * k:50 + 2 * k]], dim=1)
            for k in range(8)]


def interp_uvwt_plain(pack64, base, weights):
    """Plain PyTorch version of the kernel's interpolation mode:
    [4, n] (u, v, w, T)."""
    return torch.stack(rk_fused._plain_uvwt(
        _corner_rows(pack64, base), weights[0], weights[1], weights[2],
        weights[3]))


def meso_sigma_plain(pack64, base):
    """Plain PyTorch version of the kernel's sigma mode: [3, n]."""
    return torch.stack(rk_fused._plain_sigma16(_corner_rows(pack64, base)))


def _require_tables(name, tables):
    pack64 = tables.pack64
    if pack64.dim() != 2 or pack64.shape[1] != LANES:
        raise ValueError(f"{name}: expected a [ncell, {LANES}] table, got "
                         f"{tuple(pack64.shape)}")
    return pack64


def _uvwt_cuda(pack64, base, weights):
    n = base.shape[0]
    dev, f32, name = pack64.device, torch.float32, "lane_interp_uvwt"
    t = _cuda.ptr(name, "pack64", pack64, f32, None, dev)
    b = _cuda.ptr(name, "base", base, torch.int32, None, dev)
    w = _cuda.ptr(name, "weights", weights, f32, (4, n), dev)
    out = torch.empty((4, n), dtype=f32, device=dev)
    _cuda.call(name, dev, t, b, w, out.data_ptr(), n)
    return out


def _sigma_cuda(pack64, base):
    n = base.shape[0]
    dev, f32, name = pack64.device, torch.float32, "lane_meso_sigma"
    t = _cuda.ptr(name, "pack64", pack64, f32, None, dev)
    b = _cuda.ptr(name, "base", base, torch.int32, None, dev)
    out = torch.empty((3, n), dtype=f32, device=dev)
    _cuda.call(name, dev, t, b, out.data_ptr(), n)
    return out


def interp_uvwt_sorted(tables: LaneTables, base, weights):
    """(u, v, w) and T at located parcel positions.

    base [n] int32 table row of the parcel's cell; weights [4, n] f32
    (wx, wy, wz, wt).  Returns (uvw [3, n] f32, t [n] f32, served) with
    served == 1.0."""
    pack64 = _require_tables("interp_uvwt_sorted", tables)
    if pack64.is_cuda:
        out = _uvwt_cuda(pack64, base, weights)
    else:
        out = interp_uvwt_plain(pack64, base, weights)
    return out[0:3], out[3], 1.0


def meso_sigma_sorted(tables: LaneTables, base):
    """Subgrid wind sigma (u, v, w) of each parcel's cell:
    (sig [3, n] f32, served) with served == 1.0."""
    pack64 = _require_tables("meso_sigma_sorted", tables)
    if pack64.is_cuda:
        return _sigma_cuda(pack64, base), 1.0
    return meso_sigma_plain(pack64, base), 1.0
