"""Position checks: wrap/reflect coordinates and pressure
(reference module_position, mptrac.c:5419-5477).  Counterpart of the
JAX package's ``physics/position.py``."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.thermo import fmod
from mptrac_tpu_torch.types import Atm, Cache, Met, grid_axes
from mptrac_tpu_torch.utils.timers import span


@span("position")
def module_position(cache: Cache, met01: Met, atm: Atm) -> Atm:
    active = (cache.dt != 0.0) & atm.mask
    lon, lat, p = atm.lon, atm.lat, atm.p

    if met01.coord_type == 0:
        lon2 = fmod(lon, 360.0)
        lat2 = fmod(lat, 360.0)
        # Reflect latitude at the poles.  After fmod, |lat| < 360; the
        # reference while-loop converges within two reflections.
        for _ in range(2):
            over = lat2 > 90.0
            under = lat2 < -90.0
            lon2 = torch.where(over | under, lon2 + 180.0, lon2)
            lat2 = torch.where(over, 180.0 - lat2, lat2)
            lat2 = torch.where(under, -180.0 - lat2, lat2)
        # Wrap longitude into [-180, 180).  Bounded by a few turns.
        for _ in range(3):
            lon2 = torch.where(lon2 < -180.0, lon2 + 360.0, lon2)
            lon2 = torch.where(lon2 >= 180.0, lon2 - 360.0, lon2)
    else:
        glon, glat, _ = grid_axes(met01)
        lon2, lat2 = interp.check_cartesian(glon, glat, lon, lat)

    # Pressure reflection at model top and surface (c:5464-5473).
    # Reference quirk, reproduced exactly: the surface-pressure lookup
    # is INTPOL_2D(ps, 0) over the freshly-zeroed INTPOL_INIT indices
    # (c:5433, 5468): with ci = {0,0,0} and cw = {0,0,0,0} the
    # "interpolation" collapses to array[1][1], i.e. the reference
    # reflects every parcel at the surface pressure of grid cell
    # (1, 1), time-interpolated between the snapshots (not at the
    # parcel's own column).
    ps_grid = grid_axes(met01)[2]
    ptop = ps_grid[-1]
    p2 = torch.where(p < ptop, ptop * ptop / p, p)
    ps2d = met01.fields2d["ps"]
    dtype = p2.dtype
    wt = interp.time_weight(met01, atm.time).to(dtype)
    ps0 = ps2d[0, 1, 1].to(dtype)
    ps1 = ps2d[1, 1, 1].to(dtype)
    ps = wt * (ps0 - ps1) + ps1
    need_ps = p2 > 300.0
    p2 = torch.where(need_ps & (p2 > ps), ps * ps / p2, p2)

    return atm.replace(
        lon=torch.where(active, lon2, atm.lon),
        lat=torch.where(active, lat2, atm.lat),
        p=torch.where(active, p2, atm.p))
