"""The flagship configuration: solid-body wind on a global grid with
advection, turbulent and mesoscale diffusion and exponential decay.

Counterpart of ``__graft_entry__._make_setup`` (phys ``base``) of the
JAX package, with the same control parameters and the same parcel
positions (numpy ``default_rng(0)``), so both packages can be started
from one state.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.met.synthetic import make_wind_met
from mptrac_tpu_torch.types import (Atm, Cache, astype_state,
                                    resolve_device, stack_met)

#: control parameters of the flagship (phys "base")
FLAGSHIP_ARGS = (
    "NQ", "2", "QNT_NAME[0]", "t", "QNT_NAME[1]", "m",
    "METBASE", "-", "DT_MOD", "180", "DIFFUSION", "1",
    "TDEC_TROP", "259200", "TDEC_STRAT", "259200",
    "T_STOP", "86400")


def make_setup(n_parcels: int, nx: int = 90, ny: int = 46, nz: int = 16,
               extra_args: Sequence[str] = (), device="cuda",
               dtype=torch.float32, q: float = 0.0):
    """(ctl, clim, met01, atm, cache) of the flagship on ``device``.

    ``dtype`` is the compute mode of the state: float32 (the mode the
    kernels need; time stays float64) or float64 (the reference-parity
    mode of the exact path).  ``extra_args`` are further ``KEY VALUE``
    control parameters (e.g. ``SORT_DT 1800``), which take precedence
    over ``FLAGSHIP_ARGS``; ``q`` is the uniform
    water vapour mixing ratio of the met fields (0 in the flagship;
    derived humidity quantities need it positive)."""
    dev = resolve_device(device)
    # (the first occurrence of a key wins: extra_args override)
    ctl = read_ctl(None, list(extra_args) + list(FLAGSHIP_ARGS))
    clim = read_clim(ctl, device=dev)
    met0 = make_wind_met(t0=0.0, nx=nx, ny=ny, nz=nz, alpha=30.0, q=q,
                         device=dev)
    met1 = make_wind_met(t0=3600.0, nx=nx, ny=ny, nz=nz, alpha=30.0, q=q,
                         device=dev)
    met01 = stack_met(met0, met1)
    del met0, met1

    rng = np.random.default_rng(0)

    def draw(lo, hi):
        # drawn in float64 like the JAX setup, cast on the device
        return torch.from_numpy(rng.uniform(lo, hi, n_parcels)).to(
            dev).to(dtype)

    lon = draw(-180, 180)
    lat = draw(-60, 60)
    p = draw(200, 900)
    atm = Atm(
        time=torch.zeros(n_parcels, dtype=torch.float64, device=dev),
        p=p, lon=lon, lat=lat,
        q={name: torch.zeros(n_parcels, dtype=dtype, device=dev)
           for name in ctl.qnt_name},
        np=n_parcels)
    atm.q["m"] = torch.ones(n_parcels, dtype=dtype, device=dev)
    cache = Cache.zeros(n_parcels, dtype=dtype, iso_npmax=1, device=dev)
    met01, clim = astype_state(met=met01, clim=clim, dtype=dtype)
    return ctl, clim, met01, atm, cache
