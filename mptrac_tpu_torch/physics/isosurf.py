"""Isosurface constraint (reference module_isosurf_init / module_isosurf,
mptrac.c:4878-5001).  Counterpart of the JAX package's
``physics/isosurf.py``: hold parcels on a surface of constant pressure
(``ISOSURF 1``), density (2) or potential temperature (3), or follow a
prescribed balloon pressure track (4).

The balloon track is kept in float64 whatever the compute mode (its
times are seconds since 2000), and the new pressure is written back in
the state's dtype, where the JAX step's ``where`` promotes a float32
pressure to float64.
"""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.interp import locate_irr
from mptrac_tpu_torch.types import Atm, Cache, Met
from mptrac_tpu_torch.utils.timers import span


def read_balloon(path: str):
    """(times, pressures) of a balloon file: the first two numbers of
    every line that starts with two numbers."""
    ts, ps = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    t, p = float(toks[0]), float(toks[1])
                except ValueError:
                    continue
                ts.append(t)
                ps.append(p)
    if not ts:
        raise ValueError("Could not read any data!")
    return ts, ps


def _temperature(met01: Met, atm: Atm):
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    return interp.interp_time_3d(met01, "t", atm.time, loc)


def module_isosurf_init(ctl: Ctl, cache: Cache, met01: Met,
                        atm: Atm) -> Cache:
    """The isosurface variable of every parcel at its start, or the
    balloon track (c:4878)."""
    if ctl.isosurf == 1:
        return cache.replace(iso_var=atm.p.clone())
    if ctl.isosurf in (2, 3):
        t = _temperature(met01, atm)
        if ctl.isosurf == 2:
            return cache.replace(iso_var=atm.p / t)
        return cache.replace(iso_var=t * (1000.0 / atm.p) ** 0.286)
    if ctl.isosurf == 4:
        ts, ps = read_balloon(ctl.balloon)
        dev = atm.p.device
        return cache.replace(
            iso_ts=torch.tensor(ts, dtype=torch.float64, device=dev),
            iso_ps=torch.tensor(ps, dtype=torch.float64, device=dev),
            iso_n=len(ts))
    return cache


@span("isosurf")
def module_isosurf(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    """Put every live parcel back on its isosurface (c:4940).  As the
    reference's PARTICLE_LOOP with check_dt 0, this applies to all
    parcels in the mask, whatever their timestep."""
    active = atm.mask
    if ctl.isosurf == 1:
        p_new = cache.iso_var
    elif ctl.isosurf in (2, 3):
        t = _temperature(met01, atm)
        if ctl.isosurf == 2:
            p_new = cache.iso_var * t
        else:
            p_new = 1000.0 * (cache.iso_var / t) ** (-1.0 / 0.286)
    elif ctl.isosurf == 4:
        ts, ps = cache.iso_ts, cache.iso_ps
        idx = locate_irr(ts, atm.time).long()
        t0, t1, p0, p1 = ts[idx], ts[idx + 1], ps[idx], ps[idx + 1]
        p_interp = p0 + (p1 - p0) / (t1 - t0) * (atm.time - t0)
        del idx, t0, t1, p0, p1
        p_new = torch.where(atm.time <= ts[0], ps[0],
                            torch.where(atm.time >= ts[-1], ps[-1],
                                        p_interp))
    else:
        return atm
    return atm.replace(p=torch.where(active, p_new.to(atm.p.dtype), atm.p))
