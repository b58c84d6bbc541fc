"""Stochastic turbulent and mesoscale diffusion.

Reference: module_diff_turb (mptrac.c:4580-4730), module_diff_meso
(c:4258-4335), pbl_weight (c:8034), tropo_weight (c:12424).
Counterpart of the JAX package's ``physics/diffusion.py``.  Random
numbers come from the Squares counter RNG in the reference's per-module
order (3*np normals + counter advance).

On the card, with a float32 state, the Squares generator (``RNG_TYPE``
0 or 1) and the surface table of a pack, ``module_diff_turb`` is one
launch of a hand-written kernel (``csrc/diff_turb.cu``) that draws its
normals, locates its parcel, looks up pbl and ps, computes the
tropopause and both displacements in registers; its plain version
``module_diff_turb_plain`` serves every other call (CPU tensors,
float64, threefry, the exact path without a surface table).  On the
card both give the same values bit for bit.
"""

from __future__ import annotations

import torch

from mptrac_tpu_torch.climatology import clim_tropo
from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import H0
from mptrac_tpu_torch.ops import _cuda, interp
from mptrac_tpu_torch.ops.rng import _M64, module_rng3
from mptrac_tpu_torch.ops.slab_interp import SFC_FIELDS
from mptrac_tpu_torch.ops.thermo import dx2coord, dy2coord, dz2dp
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met, grid_axes
from mptrac_tpu_torch.utils.timers import span

#: the kernel stages the horizontal axes in shared memory, of at most
#: this many nodes in all (csrc/interp_common.cuh's SMEM_AXIS_FLOATS)
SMEM_AXIS_FLOATS = 12288


def pbl_weight(ctl: Ctl, p, pbl, ps):
    """PBL blending weight (reference pbl_weight, c:8034)."""
    p1 = pbl - ctl.turb_pbl_trans * (ps - pbl)
    p0 = pbl
    w = (p - p1) / torch.where(p0 != p1, p0 - p1, 1.0)
    return torch.where(p > p0, 1.0, torch.where(p < p1, 0.0, w))


def tropo_weight(ctl: Ctl, clim: Clim, time, lat, p, pt=None):
    """Troposphere blending weight around the climatological tropopause
    (reference tropo_weight, c:12424).  Pass ``pt`` to reuse an
    already-computed tropopause pressure (clim_tropo only depends on
    time and latitude, not on the probed pressure)."""
    if pt is None:
        lat_ref = lat if ctl.met_coord_type == 0 else ctl.met_utm_ref_lat
        pt = clim_tropo(clim, time, lat_ref)
    p1 = pt * 0.866877899
    p0 = pt / 0.866877899
    w = (p - p1) / (p0 - p1)
    return torch.where(p > p0, 1.0, torch.where(p < p1, 0.0, w))


@span("diff_turb")
def module_diff_turb(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                     atm: Atm, sfcT=None):
    """Langevin random-walk diffusion with well-mixed vertical drift
    correction (reference c:4580-4730).  ``sfcT`` is the surface table
    of the surface kernel (ops.slab_interp); without it pbl and ps come
    from the exact ``interp_time_2d``.  One launch of ``diff_turb``
    where ``kernel_takes``, else ``module_diff_turb_plain``."""
    if kernel_takes(ctl, atm, sfcT):
        return _diff_turb_cuda(ctl, cache, clim, met01, atm, sfcT)
    return module_diff_turb_plain(ctl, cache, clim, met01, atm, sfcT)


def kernel_takes(ctl: Ctl, atm: Atm, sfcT) -> bool:
    """Whether ``module_diff_turb`` launches its kernel: a float32 state
    on the card, the Squares generator and a surface table.  The
    kernel's other arguments are checked at the launch, which raises on
    what it does not take."""
    return (atm.lon.is_cuda and atm.lon.dtype == torch.float32
            and ctl.rng_type in (0, 1) and sfcT is not None)


def module_diff_turb_plain(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                           atm: Atm, sfcT=None):
    """Plain PyTorch version of ``module_diff_turb``."""
    n = atm.npmax
    rs, ctr = module_rng3(ctl.rng_type, cache.rng_ctr, n,
                          dtype=atm.lon.dtype, device=atm.lon.device,
                          part=cache.rng_part)
    cache = cache.replace(rng_ctr=ctr)

    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    # (a float32 temporary is 0.4 GB at 100M parcels: the ``del``s below
    # drop each one as soon as it is dead)
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    if sfcT is not None:
        from mptrac_tpu_torch.ops import slab_interp
        v2 = slab_interp.sfc_from_loc(sfcT, met01, ("pbl", "ps"),
                                      atm.time, loc)
        pbl, ps = v2["pbl"], v2["ps"]
    else:
        pbl = interp.interp_time_2d(met01, "pbl", atm.time, loc)
        ps = interp.interp_time_2d(met01, "ps", atm.time, loc)
    del loc
    if ctl.turb_pbl_scheme > 0:
        active = active & ~(atm.p >= pbl)
    ptop = grid_axes(met01)[2][-1]

    lat_ref = (atm.lat if ctl.met_coord_type == 0
               else torch.full_like(atm.lat, ctl.met_utm_ref_lat))
    pt_clim = clim_tropo(clim, atm.time, lat_ref)

    def kz_at(p):
        wpbl = pbl_weight(ctl, p, pbl, ps)
        wtrop = tropo_weight(ctl, clim, atm.time, atm.lat, p,
                             pt=pt_clim) * (1.0 - wpbl)
        wstrat = 1.0 - wpbl - wtrop
        return (wpbl * ctl.turb_dz_pbl + wtrop * ctl.turb_dz_trop
                + wstrat * ctl.turb_dz_strat), wpbl, wtrop, wstrat

    kz, wpbl, wtrop, wstrat = kz_at(atm.p)
    kx = (wpbl * ctl.turb_dx_pbl + wtrop * ctl.turb_dx_trop
          + wstrat * ctl.turb_dx_strat)
    del wpbl, wtrop, wstrat
    dt_abs = torch.abs(dt)

    # Horizontal displacement
    cart = met01.coord_type != 0
    sigma_h = torch.sqrt(2.0 * torch.clamp(kx, min=0.0) * dt_abs)
    do_h = active & (kx > 0)
    lon = torch.where(do_h, atm.lon + dx2coord(rs[0] * sigma_h, atm.lat,
                                               cart), atm.lon)
    lat = torch.where(do_h, atm.lat + dy2coord(rs[1] * sigma_h, cart),
                      atm.lat)
    del sigma_h, do_h, kx

    # Vertical displacement with drift correction (c:4643-4726)
    sigma_z = torch.sqrt(2.0 * torch.clamp(kz, min=0.0) * dt_abs) * 1e-3
    eps_km = 0.01

    def clip(x):
        return torch.minimum(torch.maximum(x, ptop), ps)

    p_up = clip(atm.p + dz2dp(eps_km, atm.p))
    p_dn = clip(atm.p + dz2dp(-eps_km, atm.p))
    kz_up = kz_at(p_up)[0]
    kz_dn = kz_at(p_dn)[0]
    del p_up, p_dn
    dkz_dz = (kz_up - kz_dn) / (2.0 * eps_km * 1e3)
    del kz_up, kz_dn
    w_drift = dkz_dz + kz * (-1.0 / (1e3 * H0))
    dz_tot = rs[2] * sigma_z + w_drift * dt_abs * 1e-3
    del rs, sigma_z, w_drift, dkz_dz
    ptrial = atm.p + dz2dp(dz_tot, atm.p)
    for _ in range(10):
        ptrial = torch.where(ptrial > ps, ps * ps / ptrial, ptrial)
        ptrial = torch.where(ptrial < ptop, ptop * ptop / ptrial, ptrial)
    ptrial = clip(ptrial)
    do_v = active & (kz > 0)
    p_new = torch.where(do_v, ptrial, atm.p)

    return atm.replace(lon=lon, lat=lat, p=p_new), cache


def _diff_turb_cuda(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                    atm: Atm, sfcT):
    """``module_diff_turb`` as one launch of ``diff_turb``: the draws at
    the counters of ``squares_normal3_f32`` (the columns of
    ``cache.rng_part`` where it is set), the counter advanced on the
    host as the draw advances it.  The top of the grid is read on the
    card, from the last node of the pressure axis.  The climatology's
    tables are float32, as every float32 run holds them."""
    name, f32, n = "diff_turb", torch.float32, atm.npmax
    dev = atm.lon.device
    lons, lats, ps = grid_axes(met01)
    nx, ny, npl = lons.numel(), lats.numel(), ps.numel()
    first, total = (0, n) if cache.rng_part is None else cache.rng_part
    tropo = clim.tropo
    if (min(nx, ny, npl) < 2 or nx + ny > SMEM_AXIS_FLOATS
            or tropo.dim() != 2 or min(tropo.shape) < 2
            or first < 0 or first + n > total):
        raise ValueError(
            f"{name}: axes of {nx}, {ny}, {npl} nodes (each needs two, "
            f"lons and lats {SMEM_AXIS_FLOATS} at most), a tropopause "
            f"table of {tuple(tropo.shape)} (at least 2 x 2), parcels {n} "
            f"of the draw's ({first}, {total})")
    ntime, nlat = tropo.shape
    ins = [_cuda.ptr(name, k, t, dt, (m,), dev) for k, t, dt, m in (
        ("lon", atm.lon, f32, n), ("lat", atm.lat, f32, n),
        ("p", atm.p, f32, n), ("time", atm.time, torch.float64, n),
        ("dt", cache.dt, f32, n))]
    axes = [_cuda.ptr(name, k, t, f32, (m,), dev) for k, t, m in (
        ("lons", lons, nx), ("lats", lats, ny), ("ps", ps, npl))]
    sfc = _cuda.ptr(name, "sfcT", sfcT, f32, (nx, ny, 2, len(SFC_FIELDS)),
                    dev)
    tables = [_cuda.ptr(name, k, t, f32, s, dev) for k, t, s in (
        ("tropo_time", clim.tropo_time, (ntime,)),
        ("tropo_lat", clim.tropo_lat, (nlat,)),
        ("tropo", tropo, (ntime, nlat)))]
    out = [torch.empty(n, dtype=f32, device=dev) for _ in range(3)]
    if n:
        _cuda.call(name, dev, *ins, n, atm.np, *axes, nx, ny, npl,
                   int(met01.coord_type != 0), int(met01.reg_lon),
                   int(met01.reg_lat), sfc, SFC_FIELDS.index("pbl"),
                   SFC_FIELDS.index("ps"), *interp.time_weight_args(met01),
                   *tables, ntime, nlat,
                   int(ctl.met_coord_type != 0), ctl.met_utm_ref_lat,
                   int(ctl.turb_pbl_scheme > 0), ctl.turb_pbl_trans,
                   ctl.turb_dx_pbl, ctl.turb_dx_trop, ctl.turb_dx_strat,
                   ctl.turb_dz_pbl, ctl.turb_dz_trop, ctl.turb_dz_strat,
                   cache.rng_ctr & _M64, first, total,
                   *(t.data_ptr() for t in out))
    cache = cache.replace(rng_ctr=(cache.rng_ctr + 3 * total + 1) & _M64)
    return atm.replace(lon=out[0], lat=out[1], p=out[2]), cache


def _meso_sigma_exact(met01: Met, ix, iy, iz):
    """(usig, vsig, wsig): the 16-point stencil on the met fields
    themselves, accumulated in float32 in the reference's order
    (c:4280-4304)."""
    n = ix.shape[0]
    ix, iy, iz = ix.to(torch.int64), iy.to(torch.int64), iz.to(torch.int64)

    def sig(field):
        nx, ny, npl = field.shape[-3:]
        flat = field.reshape(2, nx * ny * npl)
        mean = torch.zeros(n, dtype=torch.float32, device=field.device)
        msq = torch.zeros_like(mean)
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    idx = ((ix + di) * ny + (iy + dj)) * npl + (iz + dk)
                    for t in (0, 1):
                        val = flat[t][idx]
                        mean = mean + val
                        msq = msq + val * val
        var = msq / 16.0 - (mean / 16.0) ** 2
        return torch.where(var > 0, torch.sqrt(var), 0.0).to(torch.float32)

    f3 = met01.fields3d
    return sig(f3["u"]), sig(f3["v"]), sig(f3["w"])


@span("diff_meso")
def module_diff_meso(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                     packT=None, sig=None, sigT=None):
    """Mesoscale wind fluctuations: AR(1) colored noise scaled to the
    local subgrid wind variance (reference c:4258-4335).

    ``sig`` supplies (usig, vsig, wsig) from the fused RK kernel
    (ops.rk_fused).  Without it the 16-point variance of the parcel's
    cell is computed here: through the sigma kernel
    (ops.slab_interp.meso_sigma) when ``packT``, its wind table, is
    given, gathered from ``sigT``, the sigma table of the pack, where
    there is one; else on the met fields.  The cell is located on the raw
    position (no longitude wrap, no latitude clamp), as the reference
    does in this module."""
    n = atm.npmax
    rs, ctr = module_rng3(ctl.rng_type, cache.rng_ctr, n,
                          dtype=atm.lon.dtype, device=atm.lon.device,
                          part=cache.rng_part)
    cache = cache.replace(rng_ctr=ctr)

    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    if sig is not None:
        usig, vsig, wsig = sig
    else:
        lons, lats, ps = grid_axes(met01)
        ix = interp.locate_reg(lons, atm.lon)
        iy = interp.locate_irr(lats, atm.lat)
        iz = interp.locate_irr(ps, atm.p)
        if packT is not None:
            from mptrac_tpu_torch.ops import slab_interp
            nx, ny = lons.shape[0], lats.shape[0]
            cell = ((iz * nx + ix) * ny + iy).to(torch.int32)
            del ix, iy, iz
            usig, vsig, wsig = slab_interp.meso_sigma(packT, cell, sigT)
            del cell
        else:
            usig, vsig, wsig = _meso_sigma_exact(met01, ix, iy, iz)

    r = 1.0 - 2.0 * torch.abs(dt) / ctl.dt_met
    r2 = torch.sqrt(1.0 - r * r)

    cart = met01.coord_type != 0
    uvwp = cache.uvwp
    lon, lat, p = atm.lon, atm.lat, atm.p
    f32 = torch.float32
    if ctl.turb_mesox > 0:
        u_new = (r * uvwp[0] + r2 * rs[0] * ctl.turb_mesox
                 * usig).to(f32)
        v_new = (r * uvwp[1] + r2 * rs[1] * ctl.turb_mesox
                 * vsig).to(f32)
        u_new = torch.where(active, u_new, uvwp[0])
        v_new = torch.where(active, v_new, uvwp[1])
        lon = torch.where(active,
                          lon + dx2coord(u_new.to(lon.dtype) * dt,
                                         atm.lat, cart), lon)
        lat = torch.where(active,
                          lat + dy2coord(v_new.to(lat.dtype) * dt, cart),
                          lat)
    else:
        u_new, v_new = uvwp[0], uvwp[1]
    if ctl.turb_mesoz > 0:
        w_new = (r * uvwp[2] + r2 * rs[2] * ctl.turb_mesoz
                 * wsig).to(f32)
        w_new = torch.where(active, w_new, uvwp[2])
        p = torch.where(active, p + w_new.to(p.dtype) * dt, p)
    else:
        w_new = uvwp[2]

    cache = cache.replace(uvwp=torch.stack([u_new, v_new, w_new]))
    return atm.replace(lon=lon, lat=lat, p=p), cache
