"""Per-particle time stepping (reference module_timesteps /
module_timesteps_init, mptrac.c:5811-5889).  Counterpart of the JAX
package's ``physics/timesteps.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.types import Atm, Cache, Met, grid_axes
from mptrac_tpu_torch.utils.timers import span


@span("timesteps")
def module_timesteps(ctl: Ctl, cache: Cache, met0: Met, atm: Atm,
                     t: float) -> Cache:
    """dt[ip] = t - time[ip] for active parcels, 0 otherwise; parcels
    outside a local (non-global) met domain are frozen (c:5838-5852).
    ``t`` is the model time as a Python float."""
    d = ctl.direction
    active = ((d * (atm.time - ctl.t_start) >= 0)
              & (d * (atm.time - ctl.t_stop) <= 0)
              & (d * (atm.time - t) < 0))
    dt = torch.where(active, t - atm.time, 0.0)

    if not ctl.dd:
        lon, lat, _ = grid_axes(met0)
        latmin = torch.minimum(lat[0], lat[-1])
        latmax = torch.maximum(lat[0], lat[-1])
        local = torch.abs(lon[-1] - lon[0] - 360.0) >= 0.01
        outside = ((atm.lon <= lon[0]) | (atm.lon >= lon[-1])
                   | (atm.lat <= latmin) | (atm.lat >= latmax))
        dt = torch.where(local & outside, 0.0, dt)
    # DD mode: parcels are in their owner's tile by construction
    # (parallel.dd); the reference instead freezes on
    # current_subdomain == -1 (c:5847)
    dt = torch.where(atm.mask, dt, 0.0)
    # keep the cache dtype (fp32 mode stores dt in float32; the
    # t - time difference itself is small enough for float32)
    return cache.replace(dt=dt.to(cache.dt.dtype))


def init_time_range(ctl: Ctl, atm_time) -> Ctl:
    """Set/round the simulation time range from the particle times
    (reference module_timesteps_init, c:5858).  Host-side; returns an
    updated Ctl."""
    # (a tensor is reduced where it lies: two numbers cross to the host,
    # not the column)
    times = (atm_time.detach() if isinstance(atm_time, torch.Tensor)
             else np.asarray(atm_time))
    explicit = ctl.t_start > -1e99
    if ctl.direction == 1:
        t_start = ctl.t_start if explicit else float(times.min())
        t_stop = float(times.max()) if ctl.t_stop > 1e99 else ctl.t_stop
    else:
        t_start = ctl.t_start if explicit else float(times.max())
        t_stop = float(times.min()) if ctl.t_stop > 1e99 else ctl.t_stop
    if ctl.direction * (t_stop - t_start) <= 0:
        raise ValueError("Nothing to do! Check T_STOP and DIRECTION!")
    if ctl.direction == 1:
        t_start = math.floor(t_start / ctl.dt_mod) * ctl.dt_mod
    else:
        t_start = math.ceil(t_start / ctl.dt_mod) * ctl.dt_mod
    return ctl.replace(t_start=t_start, t_stop=t_stop)
