"""4-D meteo interpolation core (exact path).

Counterpart of the JAX package's ``ops/interp.py`` (reference
``locate_reg`` c:3559, ``locate_irr`` c:3495, ``intpol_check_lon_lat``
c:2755, ``intpol_check_cartesian`` c:2783, ``intpol_met_space_3d``
c:2985, ``intpol_met_space_2d`` c:3048, ``intpol_met_time_3d`` c:3112,
``intpol_met_time_2d`` c:3141 and the model-level
``intpol_met_4d_zeta`` c:2808).

Every function works on whole parcel batches: one ``Locator`` holds the
per-parcel cell indices and weights, computed once and reused across
fields.  Weight convention as in the reference: ``w`` is the weight of
the *lower* index, ``val = w * (a[lo] - a[hi]) + a[hi]``.

Each public locate and interpolation function is the span ``interp``
(``utils.timers``), recorded for the outermost call only, so that the
span's time is the plain interpolation's whoever calls it.

On a CUDA device ``locate_3d``, ``interp_time_3d`` and
``interp_time_2d`` are one launch of a hand-written kernel each
(``csrc/plain_interp.cu``) where their coordinates, axes, weights and
fields are float32 and their time float64; their ``*_plain`` versions
run the same arithmetic as eager PyTorch passes and serve CPU tensors,
the float64 exact path and calls of mixed dtypes.  On the card both
give the same values bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.ops.thermo import fmod
from mptrac_tpu_torch.types import Met, grid_axes
from mptrac_tpu_torch.utils.timers import span


@span("interp", outermost=True)
def locate_reg(xx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cell index on a regular axis (reference locate_reg, c:3559):
    floor((x - xx[0]) / dx) clipped to [0, n-2]."""
    n = xx.shape[0]
    i = torch.floor((x - xx[0]) / (xx[1] - xx[0])).to(torch.int32)
    return torch.clamp(i, 0, n - 2)


@span("interp", outermost=True)
def locate_irr(xx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cell index on an irregular (ascending or descending) axis
    (reference locate_irr, c:3495): ilo in [0, n-2] with
    xx[ilo] <= x < xx[ilo+1] for ascending axes (mirrored for
    descending), clamped at the ends.

    The JAX package counts comparisons (``sum(xx <= x) - 1`` ascending,
    ``sum(xx > x) - 1`` descending) and selects by the axis direction.
    A binary search gives the same counts on a monotonic axis without
    the [n, len(xx)] intermediate: ascending
    ``searchsorted(xx, x, right=True)``; descending, on the negated
    axis, ``searchsorted(-xx, -x, right=False)`` (negation is exact, so
    ties fall on the same side).  Both are evaluated and the direction
    selects on the device, so no value is read back to the host; the
    search on the wrongly ordered axis is discarded.  A NaN coordinate
    compares false with every node, so the count is 0 and the cell the
    first; the search would sort it past the last node, hence the
    explicit select.
    """
    n = xx.shape[0]
    dt = torch.promote_types(xx.dtype, x.dtype)
    xx = xx.to(dt)
    xq = x.to(dt).contiguous()
    cnt_le = torch.searchsorted(xx, xq, right=True, out_int32=True)
    cnt_gt = torch.searchsorted(-xx, -xq, right=False, out_int32=True)
    cnt = torch.where(xx[1] > xx[0], cnt_le, cnt_gt)
    cnt = torch.where(torch.isnan(xq), 0, cnt)
    return torch.clamp(cnt - 1, 0, n - 2)


def check_lon_lat(lons, lats, lon, lat):
    """Wrap longitude into the grid span and clamp latitude
    (reference intpol_check_lon_lat, c:2755)."""
    lon2 = fmod(lon, 360.0)
    lon2 = torch.where(lon2 < lons[0], lon2 + 360.0, lon2)
    lon2 = torch.where(lon2 > lons[-1], lon2 - 360.0, lon2)
    lo = torch.minimum(lats[0], lats[-1])
    hi = torch.maximum(lats[0], lats[-1])
    lat2 = torch.minimum(torch.maximum(lat, lo), hi)
    return lon2, lat2


def check_cartesian(lons, lats, lon, lat):
    """Clamp Cartesian coordinates into the grid box
    (reference intpol_check_cartesian, c:2783)."""
    xlo = torch.minimum(lons[0], lons[-1])
    xhi = torch.maximum(lons[0], lons[-1])
    ylo = torch.minimum(lats[0], lats[-1])
    yhi = torch.maximum(lats[0], lats[-1])
    return (torch.minimum(torch.maximum(lon, xlo), xhi),
            torch.minimum(torch.maximum(lat, ylo), yhi))


@dataclass
class Locator:
    """Per-parcel interpolation state (reference ci/cw arrays,
    mptrac.h:964 INTPOL_INIT).  All members are [np]-shaped."""
    ix: torch.Tensor
    iy: torch.Tensor
    iz: torch.Tensor
    wx: torch.Tensor   # weight of the lower lon index
    wy: torch.Tensor   # weight of the lower lat index
    wz: torch.Tensor   # weight of the lower level index


@span("interp", outermost=True)
def locate_3d(met: Met, lon, lat, p) -> Locator:
    """Cell indices + weights for 3-D pressure-level interpolation
    (reference intpol_met_space_3d init branch, c:2995).  ``met`` may
    be a single snapshot or a stacked [2,...] pair.  On the card, with
    float32 coordinates and axes, one launch of ``interp_locate3d``."""
    lons, lats, ps = grid_axes(met)
    if _f32_cuda(lon, lat, p, lons, lats, ps):
        return _locate_3d_cuda(met, lons, lats, ps, lon, lat, p)
    return locate_3d_plain(met, lon, lat, p)


def locate_3d_plain(met: Met, lon, lat, p) -> Locator:
    """Plain PyTorch version of ``locate_3d``."""
    lons, lats, ps = grid_axes(met)
    if met.coord_type == 0:
        lon2, lat2 = check_lon_lat(lons, lats, lon, lat)
    else:
        lon2, lat2 = check_cartesian(lons, lats, lon, lat)
    iz = locate_irr(ps, p)
    ix = locate_reg(lons, lon2)
    iy = locate_irr(lats, lat2)
    p0, p1 = ps[iz], ps[iz + 1]
    x0, x1 = _axis_vals(lons, ix, met.reg_lon)
    y0, y1 = _axis_vals(lats, iy, met.reg_lat)
    wz = (p1 - p) / (p1 - p0)
    wx = (x1 - lon2) / (x1 - x0)
    wy = (y1 - lat2) / (y1 - y0)
    return Locator(ix=ix, iy=iy, iz=iz, wx=wx, wy=wy, wz=wz)


def _axis_vals(xx, i, regular: bool):
    """(xx[i], xx[i+1]): arithmetic when the axis is known to be
    exactly arithmetic (bit-identical to the lookup), else a lookup."""
    if regular:
        d = xx[1] - xx[0]
        v0 = xx[0] + i * d
        return v0, v0 + d
    return xx[i], xx[i + 1]


def _gather3(field: torch.Tensor, ix, iy, iz) -> torch.Tensor:
    """field[..., ix, iy, iz] for per-parcel index vectors; leading
    axes (the stacked time axis) broadcast."""
    nx, ny, npl = field.shape[-3:]
    flat = field.reshape(field.shape[:-3] + (nx * ny * npl,))
    idx = (ix * ny + iy) * npl + iz
    return flat[..., idx]


@span("interp", outermost=True)
def interp_3d(field: torch.Tensor, loc: Locator, dtype=None):
    """Trilinear interpolation of one 3-D field at the located cells
    (reference intpol_met_space_3d, c:3025-3046).  ``field``:
    [..., nx, ny, npl]; returns [..., np] in ``dtype`` (defaults to the
    weight dtype)."""
    dtype = dtype or loc.wz.dtype
    ix, iy, iz = loc.ix, loc.iy, loc.iz
    wz, wy, wx = loc.wz, loc.wy, loc.wx

    def g(dx, dy, dz):
        return _gather3(field, ix + dx, iy + dy, iz + dz).to(dtype)

    aux00 = wz * (g(0, 0, 0) - g(0, 0, 1)) + g(0, 0, 1)
    aux01 = wz * (g(0, 1, 0) - g(0, 1, 1)) + g(0, 1, 1)
    aux10 = wz * (g(1, 0, 0) - g(1, 0, 1)) + g(1, 0, 1)
    aux11 = wz * (g(1, 1, 0) - g(1, 1, 1)) + g(1, 1, 1)
    aux0 = wy * (aux00 - aux01) + aux01
    aux1 = wy * (aux10 - aux11) + aux11
    return wx * (aux0 - aux1) + aux1


@span("interp", outermost=True)
def interp_2d(field: torch.Tensor, loc: Locator, dtype=None):
    """Bilinear interpolation of a 2-D surface field with the
    reference's nearest-neighbour fallback for non-finite corners
    (intpol_met_space_2d, c:3084-3110).  ``field``: [..., nx, ny]."""
    dtype = dtype or loc.wy.dtype
    ix, iy = loc.ix, loc.iy
    wy, wx = loc.wy, loc.wx
    nx, ny = field.shape[-2:]
    flat = field.reshape(field.shape[:-2] + (nx * ny,))

    def g(dx, dy):
        return flat[..., (ix + dx) * ny + (iy + dy)].to(dtype)

    a00, a01, a10, a11 = g(0, 0), g(0, 1), g(1, 0), g(1, 1)
    ok = (torch.isfinite(a00) & torch.isfinite(a01)
          & torch.isfinite(a10) & torch.isfinite(a11))
    aux0 = wy * (a00 - a01) + a01
    aux1 = wy * (a10 - a11) + a11
    bilin = wx * (aux0 - aux1) + aux1
    nn = torch.where(
        wy < 0.5,
        torch.where(wx < 0.5, a11, a01),
        torch.where(wx < 0.5, a10, a00))
    return torch.where(ok, bilin, nn)


def time_weight(met01: Met, ts) -> torch.Tensor:
    """wt = (t1 - ts) / (t1 - t0): weight of snapshot 0 (reference
    intpol_met_time_3d, c:3130).  The difference is taken in the time
    dtype (float64, jsec values need it) and the ratio is cast to the
    grid-axis dtype so that fp32 mode stays float32 downstream."""
    t0, t1 = float(met01.time[0]), float(met01.time[1])
    return ((t1 - ts) / (t1 - t0)).to(met01.lon.dtype)


@span("interp", outermost=True)
def interp_time_3d(met01: Met, name: str, ts, loc: Locator, dtype=None):
    """Time + space interpolation of a stacked 3-D field
    (reference intpol_met_time_3d, c:3112).  On the card, with a float32
    field, grid and locator, a float64 time and a float32 result, one
    launch of ``interp_time3d``."""
    field = met01.fields3d[name]
    if (dtype in (None, torch.float32) and _time_kernel_takes(met01, ts)
            and _f32_cuda(field, loc.wx, loc.wy, loc.wz)
            and _i32(loc.ix, loc.iy, loc.iz)):
        return _interp_time_cuda("interp_time3d", met01, field, ts, loc)
    return interp_time_3d_plain(met01, name, ts, loc, dtype)


def interp_time_3d_plain(met01: Met, name: str, ts, loc: Locator,
                         dtype=None):
    """Plain PyTorch version of ``interp_time_3d``."""
    var01 = interp_3d(met01.fields3d[name], loc, dtype)
    wt = time_weight(met01, ts)
    return wt * (var01[0] - var01[1]) + var01[1]


@span("interp", outermost=True)
def interp_time_2d(met01: Met, name: str, ts, loc: Locator, dtype=None):
    """Time + space interpolation of a stacked 2-D surface field with
    non-finite fallback (reference intpol_met_time_2d, c:3141).  On the
    card, as ``interp_time_3d``, one launch of ``interp_time2d``."""
    field = met01.fields2d[name]
    if (dtype in (None, torch.float32) and _time_kernel_takes(met01, ts)
            and _f32_cuda(field, loc.wx, loc.wy) and _i32(loc.ix, loc.iy)):
        return _interp_time_cuda("interp_time2d", met01, field, ts, loc)
    return interp_time_2d_plain(met01, name, ts, loc, dtype)


def interp_time_2d_plain(met01: Met, name: str, ts, loc: Locator,
                         dtype=None):
    """Plain PyTorch version of ``interp_time_2d``."""
    var01 = interp_2d(met01.fields2d[name], loc, dtype)
    wt = time_weight(met01, ts)
    v0, v1 = var01[0], var01[1]
    both = torch.isfinite(v0) & torch.isfinite(v1)
    return torch.where(both, wt * (v0 - v1) + v1,
                       torch.where(wt < 0.5, v1, v0))


# ---------------------------------------------------------------------------
# The kernels of csrc/plain_interp.cu
# ---------------------------------------------------------------------------

def _f32_cuda(first, *rest) -> bool:
    """Whether ``first`` is a CUDA tensor and it and ``rest`` are all
    float32 tensors: the calls the kernels take (devices are checked at
    the launch)."""
    return (isinstance(first, torch.Tensor) and first.is_cuda
            and all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    for t in (first, *rest)))


def _i32(*ts) -> bool:
    return all(t.dtype == torch.int32 for t in ts)


def _time_kernel_takes(met01: Met, ts) -> bool:
    """A float64 time and a float32 grid: ``time_weight`` is then the
    float64 ratio rounded to float32, which the kernels compute."""
    return (isinstance(ts, torch.Tensor) and ts.dtype == torch.float64
            and met01.lon.dtype == torch.float32)


def _locate_3d_cuda(met: Met, lons, lats, ps, lon, lat, p) -> Locator:
    """``locate_3d`` as one launch of ``interp_locate3d``."""
    lon, lat, p = (t.contiguous() for t in torch.broadcast_tensors(lon, lat,
                                                                   p))
    dev, shape = lon.device, lon.shape
    nx, ny, npl = lons.numel(), lats.numel(), ps.numel()
    if min(nx, ny, npl) < 2:
        raise ValueError(f"locate_3d: axes of {nx}, {ny}, {npl} nodes; "
                         "each needs two")
    f32, name = torch.float32, "interp_locate3d"
    ins = [_cuda.ptr(name, k, t, f32, s, dev) for k, t, s in (
        ("lon", lon, shape), ("lat", lat, shape), ("p", p, shape),
        ("lons", lons, (nx,)), ("lats", lats, (ny,)), ("ps", ps, (npl,)))]
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for dt in (torch.int32,) * 3 + (f32,) * 3]
    if lon.numel():
        _cuda.call(name, dev, *ins, nx, ny, npl, int(met.coord_type != 0),
                   int(met.reg_lon), int(met.reg_lat),
                   *(t.data_ptr() for t in outs), lon.numel())
    return Locator(*outs)


def _interp_time_cuda(name: str, met01: Met, field, ts, loc: Locator):
    """``interp_time_3d`` (``name`` "interp_time3d", ``field`` [2, nx,
    ny, npl]) or ``interp_time_2d`` ("interp_time2d", [2, nx, ny]) as
    one launch of the kernel ``name``.  ``ts`` holds one time or one a
    parcel."""
    three = name == "interp_time3d"
    dev, shape = loc.ix.device, loc.ix.shape
    if field.dim() != (4 if three else 3) or field.shape[0] != 2:
        raise ValueError(f"{name}: the field must be a stacked pair "
                         f"[2, nx, ny{', npl' if three else ''}], got "
                         f"{tuple(field.shape)}")
    ts = ts.contiguous()
    one_time = ts.numel() == 1
    members = ("ix", "iy", "iz", "wx", "wy", "wz") if three else (
        "ix", "iy", "wx", "wy")
    loc_t = [getattr(loc, k).contiguous() for k in members]
    ins = [_cuda.ptr(name, "field", field, torch.float32, field.shape, dev)]
    ins += [_cuda.ptr(name, k, t, torch.int32 if k[0] == "i"
                      else torch.float32, shape, dev)
            for k, t in zip(members, loc_t)]
    ins.append(_cuda.ptr(name, "ts", ts, torch.float64,
                         ts.shape if one_time else shape, dev))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.call(name, dev, *ins, 0 if one_time else 1,
                   *time_weight_args(met01), out.data_ptr(), out.numel(),
                   *field.shape[1:])
    return out


def time_weight_args(met01: Met):
    """(t1, inv_dt): ``time_weight`` as the kernels take it, t1 and the
    float64 reciprocal of t1 - t0 that PyTorch multiplies by in its
    division (host floats: nothing is read from the card)."""
    t0, t1 = float(met01.time[0]), float(met01.time[1])
    dt = t1 - t0
    return t1, 1.0 / dt if dt != 0.0 else math.copysign(math.inf, dt)


# ---------------------------------------------------------------------------
# Model-level (zeta/eta) interpolation: intpol_met_4d_zeta (c:2808)
# ---------------------------------------------------------------------------

@dataclass
class ZetaLocator:
    """Per-parcel state of an interpolation in a column-dependent
    vertical coordinate: the column of the cell's lower corner
    (``ix * ny + iy``), the weights of snapshot 1 (``wt1``), of the
    upper longitude and latitude (``wx1``, ``wy1``), the level index
    ``iz`` and the weight ``wzeta`` of level ``iz + 1``."""
    col: torch.Tensor
    wt1: torch.Tensor
    wx1: torch.Tensor
    wy1: torch.Tensor
    ny: int
    npl_f: int
    dtype: torch.dtype
    iz: torch.Tensor = None
    wzeta: torch.Tensor = None


def _zeta_level(flat: torch.Tensor, loc: ZetaLocator, k: torch.Tensor):
    """A field ``[2, nx*ny*npl_f]`` at level ``k`` of each parcel's
    column, interpolated in the JAX function's order: time at each of
    the four corners, then latitude, then longitude."""
    npl_f, ny = loc.npl_f, loc.ny
    base = loc.col * npl_f + k

    def corner(off):
        idx = base + off if off else base
        p0 = flat[0][idx].to(loc.dtype)
        p1 = flat[1][idx].to(loc.dtype)
        return loc.wt1 * (p1 - p0) + p0

    h00, h01 = corner(0), corner(npl_f)
    h0 = loc.wy1 * (h01 - h00) + h00
    del h00, h01
    h10, h11 = corner(ny * npl_f), corner((ny + 1) * npl_f)
    h1 = loc.wy1 * (h11 - h10) + h10
    del h10, h11
    return loc.wx1 * (h1 - h0) + h0


@span("interp", outermost=True)
def locate_zeta(met01: Met, heights_name: str, ts, height, lon, lat,
                dtype=torch.float64) -> ZetaLocator:
    """Cell, weights and level of each parcel for an interpolation in the
    vertical coordinate ``heights_name`` ("zetal" or "pl"): the part of
    ``interp_4d_zeta`` that does not depend on the interpolated field.

    The JAX package interpolates the whole height profile of every
    parcel's column (``[N, npl]``) and counts, with ``locate_irr``, the
    levels at or below (ascending column) or above (descending) the
    parcel.  Here a binary search over the level index finds the same
    count, evaluating only the levels it probes, each from its eight
    values (four corners, two times) in the JAX arithmetic order.  The
    direction of the count is each parcel's own, from levels 0 and 1, as
    in ``locate_irr``; the search runs in the direction of the column's
    end levels, and the count in the other direction is ``npl`` minus
    it.  On a monotonic column (ties included) this is the JAX count; on
    a column out of order the two can differ.  A NaN height goes to cell
    0, the index is clamped to ``[0, npl - 2]`` and ``npl`` is
    ``npl_ml`` when that is set."""
    heights = met01.fields3d[heights_name]            # [2, nx, ny, npl_f]
    lons, lats, _ = grid_axes(met01)
    nx, ny, npl_f = heights.shape[-3:]
    npl = met01.npl_ml if met01.npl_ml > 0 else npl_f
    if met01.coord_type == 0:
        lon2, lat2 = check_lon_lat(lons, lats, lon, lat)
    else:
        lon2, lat2 = check_cartesian(lons, lats, lon, lat)
    ix = locate_reg(lons, lon2)
    iy = locate_irr(lats, lat2)
    t0, t1 = met01.time
    x0, x1 = _axis_vals(lons, ix, met01.reg_lon)
    y0, y1 = _axis_vals(lats, iy, met01.reg_lat)
    loc = ZetaLocator(
        col=ix.to(torch.int64) * ny + iy, wt1=(ts - t0) / (t1 - t0),
        wx1=(lon2 - x0) / (x1 - x0), wy1=(lat2 - y0) / (y1 - y0),
        ny=ny, npl_f=npl_f, dtype=dtype)
    del ix, iy, x0, x1, y0, y1, lon2, lat2
    flat = heights.reshape(2, nx * ny * npl_f)

    def level(k):
        if isinstance(k, int):
            k = torch.full_like(loc.col, k)
        return _zeta_level(flat, loc, k)

    h_0, h_1, h_last = level(0), level(1), level(npl - 1)
    count_asc = h_1 > h_0            # locate_irr's direction
    search_asc = h_last >= h_0       # the column's direction
    del h_0, h_1, h_last
    # lo ends as the number of leading levels with h_k <= height on a
    # column that ascends, with h_k > height on one that descends
    lo = torch.zeros_like(loc.col)
    hi = torch.full_like(loc.col, npl)
    for _ in range(math.ceil(math.log2(npl + 1))):
        mid = (lo + hi) // 2
        h_mid = level(torch.clamp(mid, max=npl - 1))
        below = torch.where(search_asc, h_mid <= height, h_mid > height)
        del h_mid
        active = lo < hi
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
        del mid, below, active
    cnt = torch.where(count_asc == search_asc, lo, npl - lo)
    cnt = torch.where(torch.isnan(height), 0, cnt)
    del lo, hi, count_asc, search_asc
    loc.iz = torch.clamp(cnt - 1, 0, npl - 2)
    h_bot, h_top = level(loc.iz), level(loc.iz + 1)
    loc.wzeta = (height - h_bot) / (h_top - h_bot)
    return loc


@span("interp", outermost=True)
def interp_zeta(met01: Met, loc: ZetaLocator, array_name: str):
    """Field ``array_name`` at the located parcels: the two levels
    around each parcel, weighted by ``wzeta``."""
    field = met01.fields3d[array_name]
    if field.shape[-1] != loc.npl_f:
        raise ValueError(f"interp_zeta: {array_name} has {field.shape[-1]} "
                         f"levels, the located coordinate {loc.npl_f}")
    flat = field.reshape(2, -1)
    a_bot = _zeta_level(flat, loc, loc.iz)
    a_top = _zeta_level(flat, loc, loc.iz + 1)
    return loc.wzeta * (a_top - a_bot) + a_bot


@span("interp", outermost=True)
def interp_4d_zeta(met01: Met, heights_name: str, array_name: str, ts,
                   height, lon, lat, dtype=torch.float64) -> torch.Tensor:
    """4-D interpolation in a column-dependent vertical coordinate
    (reference intpol_met_4d_zeta, c:2808): ``heights_name`` selects the
    3-D coordinate field (e.g. "zetal" or "pl"), ``array_name`` the
    field to interpolate; computed in ``dtype`` (float64 by default,
    whatever the state's dtype).  ``locate_zeta`` says how; no
    ``[N, npl]`` tensor is built."""
    return interp_zeta(met01, locate_zeta(met01, heights_name, ts, height,
                                          lon, lat, dtype), array_name)
