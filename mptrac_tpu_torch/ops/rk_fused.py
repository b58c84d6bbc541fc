"""Fused RK advection: one kernel launch per timestep.

Counterpart of the JAX package's ``ops/rk_fused.py``.  For every parcel
one launch performs every RK stage (Euler / midpoint / RK4): locate,
2x2x2 corner gather from the per-cell table, trilinear + time
interpolation and the position update; then, at the final position, the
mesoscale subgrid wind sigma (16 corner values, reference summation
order) and the temperature.

What differs from the JAX package by design: a GPU thread gathers its
own corners, so there are no slabs, windows, anchors, margin columns or
fallback tiers, and every parcel is served (``served`` is the constant
1.0).  The table is row-major ``[npl, nx, ny, 8]`` float32 with fields
(u0, v0, w0, u1, v1, w1, t0, t1) at the cell's own node, level-major
like the sort key.

fp32 only: positions and weights in float32; the time weight is
``wt0 - frac*dt/(t1-t0)`` in float32, as in the JAX kernel.

``advect_all`` launches the CUDA kernel ``csrc/rk_fused.cu`` for CUDA
tensors and takes ``rk_plain``, the same arithmetic in plain PyTorch,
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.ops.thermo import dx2coord, dy2coord
from mptrac_tpu_torch.types import Met, grid_axes


@dataclass
class CellPack:
    """Per-cell gather table + locate parameters for one met pair."""
    table: torch.Tensor     # [npl, nx, ny, 8] f32, see module docstring
    lat_axis: torch.Tensor  # [ny] f32
    p_axis: torch.Tensor    # [npl] f32
    # --- host-side values (read once when the pack is built) ---
    nx: int = 0
    ny: int = 0
    npl: int = 0
    lon0: float = 0.0        # first longitude (f32 value)
    dlon: float = 0.0        # longitude spacing (f32 value)
    lon_last: float = 0.0
    lat_lo: float = 0.0
    lat_hi: float = 0.0
    inv_tden: float = 0.0    # 1 / (t1 - t0) (f32 value)
    lat_asc: bool = True
    lat_reg: bool = False    # lat axis exactly arithmetic
    p_asc: bool = False
    cartesian: bool = False


def build_cell_table(met01: Met) -> torch.Tensor:
    """[npl, nx, ny, 8] float32 per-cell table of a stacked met pair
    (see module docstring); also the wind table of the unfused kernels
    (ops.slab_interp.interp_uvwt, meso_sigma)."""
    f3 = met01.fields3d
    u, v, w = f3["u"], f3["v"], f3["w"]
    t = f3.get("t")
    flds = [u[0], v[0], w[0], u[1], v[1], w[1]]
    flds += [t[0], t[1]] if t is not None else [torch.zeros_like(u[0])] * 2
    # [nx, ny, npl, 8] -> level-major [npl, nx, ny, 8]
    return (torch.stack([f.to(torch.float32) for f in flds], dim=-1)
            .permute(2, 0, 1, 3).contiguous())


def build_cell_pack(met01: Met) -> CellPack:
    """Build the per-cell table and read the axis parameters to the
    host.  Call once per met interval (this is the one place that waits
    for the device)."""
    table = build_cell_table(met01)
    npl, nx, ny = table.shape[:3]

    lons, lats, ps = grid_axes(met01)
    f32 = np.float32
    lon_np = lons.detach().cpu().numpy()
    lat_np = lats.detach().cpu().numpy().astype(f32)
    p_np = ps.detach().cpu().numpy().astype(f32)
    # the kernel's locate finds the cell by a binary search, which gives
    # the compare-count's index only on a strictly monotonic axis (a
    # deliberate difference from the JAX package, whose compare-count has
    # no meaning on another axis either)
    for name, ax in (("latitude", lat_np), ("pressure", p_np)):
        d = np.diff(ax)
        if not (np.all(d > 0) or np.all(d < 0)):
            raise ValueError(f"build_cell_pack: the {name} axis of the met "
                             f"pair is not strictly monotonic in float32: "
                             f"{ax.tolist()}")
    times = np.asarray(met01.time, np.float64)
    return CellPack(
        table=table,
        lat_axis=lats.to(torch.float32).contiguous(),
        p_axis=ps.to(torch.float32).contiguous(),
        nx=nx, ny=ny, npl=npl,
        lon0=float(f32(lon_np[0])),
        # spacing in the axis dtype, then float32 (as the JAX package)
        dlon=float(f32(lon_np[1] - lon_np[0])),
        lon_last=float(f32(lon_np[-1])),
        lat_lo=float(min(lat_np[0], lat_np[-1])),
        lat_hi=float(max(lat_np[0], lat_np[-1])),
        inv_tden=float(f32(1.0 / (times[1] - times[0]))),
        lat_asc=bool(lat_np[1] > lat_np[0]),
        lat_reg=bool(np.all(lat_np == lat_np[0]
                            + np.arange(ny, dtype=f32)
                            * (lat_np[1] - lat_np[0]))),
        p_asc=bool(p_np[1] > p_np[0]),
        cartesian=met01.coord_type != 0)


def _rk_fracs(nstage: int):
    """(dts_frac, weight) per stage (reference c:3654-3676)."""
    if nstage == 4:
        return ((0.0, 1 / 6), (0.5, 2 / 6), (0.5, 2 / 6), (1.0, 1 / 6))
    if nstage == 2:
        return ((0.0, 0.0), (0.5, 1.0))
    if nstage == 1:
        return ((0.0, 1.0),)
    raise ValueError(f"nstage must be 1, 2 or 4, got {nstage}")


# ------------------------------------------------------ plain version

def locate_plain(pack: CellPack, xlon, xlat, xp):
    """float32 locate with the index and weight semantics of
    ops.interp.locate_3d; compare-count on the irregular axes."""
    if pack.cartesian:
        lon2 = torch.clamp(xlon, pack.lon0, pack.lon_last)
    else:
        lon2 = xlon - torch.trunc(xlon / 360.0) * 360.0
        lon2 = torch.where(lon2 < pack.lon0, lon2 + 360.0, lon2)
        lon2 = torch.where(lon2 > pack.lon_last, lon2 - 360.0, lon2)
    lat2 = torch.clamp(xlat, pack.lat_lo, pack.lat_hi)
    ix = torch.clamp(torch.floor((lon2 - pack.lon0) / pack.dlon)
                     .to(torch.int64), 0, pack.nx - 2)
    latv, pv = pack.lat_axis, pack.p_axis
    if pack.lat_reg:
        lat0 = latv[0]
        dlat = latv[1] - latv[0]
        iy = torch.clamp(torch.floor((lat2 - lat0) / dlat)
                         .to(torch.int64), 0, pack.ny - 2)
    elif pack.lat_asc:
        iy = torch.clamp((latv <= lat2[:, None]).sum(-1) - 1, 0,
                         pack.ny - 2)
    else:
        iy = torch.clamp((latv > lat2[:, None]).sum(-1) - 1, 0,
                         pack.ny - 2)
    if pack.p_asc:
        iz = (pv <= xp[:, None]).sum(-1)
    else:
        iz = (pv > xp[:, None]).sum(-1)
    iz = torch.clamp(iz - 1, 0, pack.npl - 2)
    x0 = pack.lon0 + ix.to(torch.float32) * pack.dlon
    x1 = x0 + pack.dlon
    wx = (x1 - lon2) / (x1 - x0)
    y0, y1 = latv[iy], latv[iy + 1]
    wy = (y1 - lat2) / (y1 - y0)
    p0, p1 = pv[iz], pv[iz + 1]
    wz = (p1 - xp) / (p1 - p0)
    cell = (iz * pack.nx + ix) * pack.ny + iy
    return cell, wx, wy, wz


def _cell_corner_rows(table, cell):
    """8 corner rows [n, 8] of the per-cell table at flat level-major
    cells, corner order (dx, dy, dz) lexicographic, the upper corner
    clamped at the last node of its axis (a located cell never needs
    the clamp: its indices stop one node short)."""
    npl, nx, ny = table.shape[:3]
    c = cell.to(torch.int64)
    iy = c % ny
    t = torch.div(c, ny, rounding_mode="floor")
    ix = t % nx
    iz = torch.div(t, nx, rounding_mode="floor")
    sx = torch.where(ix < nx - 1, ny, 0)
    sy = torch.where(iy < ny - 1, 1, 0)
    sz = torch.where(iz < npl - 1, nx * ny, 0)
    rows = table.reshape(-1, 8)
    return [rows[c + dx * sx + dy * sy + dz * sz]
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _plain_trilerp(vals, wx, wy, wz):
    def L(w, a, b):
        return w[:, None] * (a - b) + b
    a00 = L(wz, vals[0], vals[1])
    a01 = L(wz, vals[2], vals[3])
    a10 = L(wz, vals[4], vals[5])
    a11 = L(wz, vals[6], vals[7])
    a0 = L(wy, a00, a01)
    a1 = L(wy, a10, a11)
    return L(wx, a0, a1)                               # [n, 8]


def _plain_uvwt(vals, wx, wy, wz, wt):
    """(u, v, w, T) [n] from 8 corner rows [n, 8]: each field in space
    (z, y, x), then in time, ``w * (a - b) + b`` throughout."""
    f = _plain_trilerp(vals, wx, wy, wz)
    return tuple(wt * (f[:, a] - f[:, b]) + f[:, b]
                 for a, b in ((0, 3), (1, 4), (2, 5), (6, 7)))


def _plain_sigma16(vals):
    """(su, sv, sw) [n] from 8 corner rows [n, >= 6]: mean and mean
    square over 8 corners x 2 snapshots in the reference's order
    (corner outer, snapshot inner)."""
    sigs = []
    for comp in range(3):
        mean = torch.zeros_like(vals[0][:, 0])
        msq = torch.zeros_like(mean)
        for k in range(8):
            for s in (0, 1):
                val = vals[k][:, comp + 3 * s]
                mean = mean + val
                msq = msq + val * val
        mean = mean * (1.0 / 16.0)
        msq = msq * (1.0 / 16.0)
        var = msq - mean * mean
        sigs.append(torch.where(var > 0,
                                torch.sqrt(torch.clamp(var, min=0.0)),
                                torch.zeros_like(var)))
    return sigs


def rk_plain(pack: CellPack, nstage: int, lon, lat, p, dtp, wt0):
    """Plain PyTorch version of the kernel's arithmetic (float32), the
    counterpart of the JAX package's ``rk_xla``.  Returns
    (nlon, nlat, np, su, sv, sw, T)."""
    cart = pack.cartesian
    inv_tden = pack.inv_tden
    um = vm = wm = 0.0
    uprev = vprev = wprev = None
    lat_node = lat
    for i, (frac, kwt) in enumerate(_rk_fracs(nstage)):
        if i == 0:
            xlon, xlat, xp = lon, lat, p
        else:
            dts = frac * dtp
            xlon = lon + dx2coord(dts * uprev, lat, cart)
            xlat = lat + dy2coord(dts * vprev, cart)
            xp = p + dts * wprev
        wt = wt0 - (frac * dtp) * inv_tden
        cell, wx, wy, wz = locate_plain(pack, xlon, xlat, xp)
        f = _plain_trilerp(_cell_corner_rows(pack.table, cell), wx, wy, wz)
        ui = wt * (f[:, 0] - f[:, 3]) + f[:, 3]
        vi = wt * (f[:, 1] - f[:, 4]) + f[:, 4]
        wi = wt * (f[:, 2] - f[:, 5]) + f[:, 5]
        um = um + kwt * ui
        vm = vm + kwt * vi
        wm = wm + kwt * wi
        uprev, vprev, wprev = ui, vi, wi
        lat_node = xlat
    lat_dx = lat_node if nstage == 2 else lat
    nlon = lon + dx2coord(dtp * um, lat_dx, cart)
    nlat = lat + dy2coord(dtp * vm, cart)
    np_ = p + dtp * wm
    wtf = wt0 - dtp * inv_tden
    cellf, wxf, wyf, wzf = locate_plain(pack, nlon, nlat, np_)
    valsf = _cell_corner_rows(pack.table, cellf)
    ff = _plain_trilerp(valsf, wxf, wyf, wzf)
    T = wtf * (ff[:, 6] - ff[:, 7]) + ff[:, 7]
    sigs = _plain_sigma16(valsf)
    return nlon, nlat, np_, sigs[0], sigs[1], sigs[2], T


# ------------------------------------------------------------ wrapper

def _rk_cuda(pack: CellPack, nstage: int, lon, lat, p, dtp, wt0):
    n = lon.shape[0]
    dev, f32, name = lon.device, torch.float32, "rk_fused_advect"
    args = [_cuda.ptr(name, "table", pack.table, f32,
                      (pack.npl, pack.nx, pack.ny, 8), dev),
            _cuda.ptr(name, "lat_axis", pack.lat_axis, f32, (pack.ny,), dev),
            _cuda.ptr(name, "p_axis", pack.p_axis, f32, (pack.npl,), dev)]
    args += [_cuda.ptr(name, k, t, f32, (n,), dev) for k, t in (
        ("lon", lon), ("lat", lat), ("p", p), ("dt", dtp), ("wt0", wt0))]
    if pack.table.numel() >= 2 ** 31:
        raise ValueError("rk_fused_advect: table too large for 32-bit "
                         "cell arithmetic")
    _rk_fracs(nstage)       # raises on an unsupported scheme
    out = torch.empty((7, n), dtype=f32, device=dev)
    _cuda.call(name, dev, nstage, *args, out.data_ptr(), n, pack.nx,
               pack.ny, pack.npl, pack.lon0, pack.dlon, pack.lon0,
               pack.lon_last, pack.lat_lo, pack.lat_hi, pack.inv_tden,
               int(pack.cartesian), int(pack.lat_reg), int(pack.lat_asc),
               int(pack.p_asc))
    return tuple(out[r] for r in range(7))


def kernel_attributes(pack: CellPack, nstage: int) -> dict:
    """What the compiled CUDA kernel of ``nstage`` takes on the current
    card: registers and local memory (spills, stack) a thread, and
    resident blocks a multiprocessor at its launch configuration."""
    _rk_fracs(nstage)
    out = (ctypes.c_int * 3)()
    _cuda.call("rk_fused_attributes", None, nstage, pack.ny, pack.npl, out)
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def advect_all(pack: CellPack, nstage: int, lon, lat, p, dtp, wt0
               ) -> Tuple[tuple, float]:
    """Fused advect + final-position sigma/T.

    Inputs float32 [n] (wt0 = time weight at the parcel's current
    time).  Returns ((nlon, nlat, np, su, sv, sw, T), served) with
    served == 1.0: every parcel is computed by the kernel.  CUDA
    tensors go to the CUDA kernel (or raise); CPU tensors to the plain
    version."""
    if lon.is_cuda:
        rows = _rk_cuda(pack, nstage, lon, lat, p, dtp, wt0)
    else:
        rows = rk_plain(pack, nstage, lon, lat, p, dtp, wt0)
    return rows, 1.0
