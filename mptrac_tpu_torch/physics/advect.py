"""Advection: Euler / midpoint / RK4 integration of the wind field
(reference module_advect, mptrac.c:3598-3789).  Counterpart of the JAX
package's ``physics/advect.py``: the fused path
(``module_advect_fused``) and the unfused kinematic path on pressure
levels (``module_advect``, one interpolation per RK node through the
uvwt kernel or the exact ``interp_time_3d``), on model levels
(``ADVECT_VERT_COORD 2``, omega on the ``pl`` columns) and the
diabatic advection in zeta or eta (``ADVECT_VERT_COORD`` 1 or 3), with
``module_advect_init``.  The model-level paths interpolate with
``ops.interp.locate_zeta`` / ``interp_zeta``: one column search per RK
node serves all three wind components, where the JAX package calls
``interp_4d_zeta`` for each (the same numbers: the search does not
depend on the field)."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp, rk_fused
from mptrac_tpu_torch.ops.thermo import dx2coord, dy2coord
from mptrac_tpu_torch.types import Atm, Cache, Met
from mptrac_tpu_torch.utils.timers import span


@span("advect")
def module_advect(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                  packT=None):
    """Unfused advection; returns (atm, cache).  ``packT`` is the wind
    table of the uvwt kernel (ops.slab_interp), used on pressure levels
    only; without it the exact interpolation runs."""
    if ctl.advect_vert_coord in (0, 2):
        return _advect_plev(ctl, cache, met01, atm,
                            packT if ctl.advect_vert_coord == 0
                            else None), cache
    return _advect_zeta(ctl, cache, met01, atm), cache


@span("advect")
def module_advect_fused(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                        cell: rk_fused.CellPack):
    """Fused advect via the single-pass RK kernel (ops.rk_fused):
    positions advance AND the final-position mesoscale subgrid sigma
    and temperature come out of the same kernel launch.

    Returns (atm, cache, (su, sv, sw), T).  sigma/T are evaluated at
    the post-advect position (the unfused pipeline of the JAX package
    evaluates them after the turbulent-diffusion displacement).  fp32
    only."""
    dt = cache.dt
    active = (dt != 0.0) & atm.mask
    wt0 = interp.time_weight(met01, atm.time).to(torch.float32)
    (nlon, nlat, np_, su, sv, sw, T), served = rk_fused.advect_all(
        cell, ctl.advect, atm.lon, atm.lat, atm.p,
        dt.to(torch.float32), wt0)
    if cache.served_min is not None:
        cache = cache.replace(served_min=min(cache.served_min, served))
    new_time = atm.time + dt
    atm = atm.replace(
        time=torch.where(active, new_time, atm.time),
        lon=torch.where(active, nlon, atm.lon),
        lat=torch.where(active, nlat, atm.lat),
        p=torch.where(active, np_, atm.p))
    return atm, cache, (su, sv, sw), T


def _rk_weight(ctl: Ctl, i: int) -> float:
    if ctl.advect == 2:
        return 0.0 if i == 0 else 1.0
    if ctl.advect == 4:
        return 1.0 / 6.0 if i in (0, 3) else 2.0 / 6.0
    return 1.0


def _advect_plev(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                 packT=None) -> Atm:
    """Kinematic advection with omega on pressure levels
    (ADVECT_VERT_COORD 0) or on model levels (2): a loop over the RK
    nodes, each one locate and one interpolation of u, v, w over all
    parcels."""
    cart = met01.coord_type != 0
    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    um = vm = wm = 0.0
    u = v = w = None
    for i in range(ctl.advect):
        if i == 0:
            dts = 0.0
            x = (atm.lon, atm.lat, atm.p)
        else:
            dts = (1.0 if i == 3 else 0.5) * dt
            x = (atm.lon + dx2coord(dts * u, atm.lat, cart),
                 atm.lat + dy2coord(dts * v, cart),
                 atm.p + dts * w)
        tm = atm.time + dts
        if ctl.advect_vert_coord == 2:
            loc = interp.locate_zeta(met01, "pl", tm, x[2], x[0], x[1])
            u, v, w = (interp.interp_zeta(met01, loc, name)
                       for name in ("ul", "vl", "wl"))
        elif packT is not None:
            from mptrac_tpu_torch.ops import slab_interp
            loc = interp.locate_3d(met01, x[0], x[1], x[2])
            u, v, w, _ = slab_interp.uvwt_from_loc(packT, met01, tm, loc)
        else:
            loc = interp.locate_3d(met01, x[0], x[1], x[2])
            u = interp.interp_time_3d(met01, "u", tm, loc)
            v = interp.interp_time_3d(met01, "v", tm, loc)
            w = interp.interp_time_3d(met01, "w", tm, loc)
        del loc, tm
        k = _rk_weight(ctl, i)
        um = um + k * u
        vm = vm + k * v
        wm = wm + k * w
        lat_node = x[1]
        del x

    # The reference converts the final zonal step at the last RK
    # node's latitude under the midpoint scheme (c:3674).
    lat_for_dx = lat_node if ctl.advect == 2 else atm.lat
    new_time = atm.time + dt
    new_lon = atm.lon + dx2coord(dt * um, lat_for_dx, cart)
    new_lat = atm.lat + dy2coord(dt * vm, cart)
    new_p = atm.p + dt * wm
    return _write_back(atm, active, new_time, new_lon, new_lat, new_p)


def _write_back(atm: Atm, active, new_time, new_lon, new_lat, new_p,
                q=None) -> Atm:
    """The advanced position where ``active``, in the state's dtype (the
    model-level interpolation computes in float64)."""
    def keep(new, old):
        return torch.where(active, new.to(old.dtype), old)

    return atm.replace(
        time=keep(new_time, atm.time), lon=keep(new_lon, atm.lon),
        lat=keep(new_lat, atm.lat), p=keep(new_p, atm.p),
        q=atm.q if q is None else q)


def _advect_zeta(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    """Diabatic advection in the zeta (ADVECT_VERT_COORD 1) or eta (3)
    vertical coordinate (reference c:3684-3764): the vertical position
    is carried in the quantity ``zeta`` or ``eta``, and the pressure is
    diagnosed from it after the step."""
    cart = met01.coord_type != 0
    qnt = "zeta" if ctl.advect_vert_coord == 1 else "eta"
    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    # Convert the current pressure to the vertical coordinate
    zeta0 = interp.interp_4d_zeta(met01, "pl", "zetal", atm.time, atm.p,
                                  atm.lon, atm.lat)

    um = vm = wdm = 0.0
    u = v = wdot = None
    for i in range(ctl.advect):
        if i == 0:
            dts = 0.0
            x = (atm.lon, atm.lat, zeta0)
        else:
            dts = (1.0 if i == 3 else 0.5) * dt
            x = (atm.lon + dx2coord(dts * u, atm.lat, cart),
                 atm.lat + dy2coord(dts * v, cart),
                 zeta0 + dts * wdot)
        tm = atm.time + dts
        loc = interp.locate_zeta(met01, "zetal", tm, x[2], x[0], x[1])
        u, v, wdot = (interp.interp_zeta(met01, loc, name)
                      for name in ("ul", "vl", "zeta_dotl"))
        del loc, tm
        k = _rk_weight(ctl, i)
        um = um + k * u
        vm = vm + k * v
        wdm = wdm + k * wdot
        lat_node = x[1]
        del x

    # The reference converts the final zonal step at the last RK
    # node's latitude under the midpoint scheme (c:3674).
    lat_for_dx = lat_node if ctl.advect == 2 else atm.lat
    new_time = atm.time + dt
    new_lon = atm.lon + dx2coord(dt * um, lat_for_dx, cart)
    new_lat = atm.lat + dy2coord(dt * vm, cart)
    new_zeta = zeta0 + dt * wdm
    new_p = interp.interp_4d_zeta(met01, "zetal", "pl", new_time, new_zeta,
                                  new_lon, new_lat)
    q = dict(atm.q)
    if qnt in q:
        q[qnt] = torch.where(active, new_zeta, zeta0).to(q[qnt].dtype)
    return _write_back(atm, active, new_time, new_lon, new_lat, new_p, q)


def module_advect_init(ctl: Ctl, met01: Met, atm: Atm) -> Atm:
    """Pressure consistent with the zeta coordinate of each parcel
    (reference module_advect_init, c:3766); nothing to do unless
    ADVECT_VERT_COORD is 1 and the parcels carry ``zeta``."""
    if ctl.advect_vert_coord != 1 or "zeta" not in atm.q:
        return atm
    p = interp.interp_4d_zeta(met01, "zetal", "pl", atm.time,
                              atm.q["zeta"], atm.lon, atm.lat)
    return atm.replace(p=torch.where(atm.mask, p.to(atm.p.dtype), atm.p))
