"""The flagship configuration: solid-body wind on a global grid with
advection, turbulent and mesoscale diffusion and exponential decay, and
the physics ladder above it.

Counterpart of ``__graft_entry__._make_setup`` of the JAX package, with
the same control parameters for each ``phys`` and the same parcel
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

#: control parameters each rung of the physics ladder adds to the
#: flagship's (``__graft_entry__._make_setup``): ``conv`` convection,
#: ``chem`` OH / H2O2 chemistry and wet / dry deposition of SO2.
#: ``full`` is ``chem``: the JAX package's ladder adds nothing more.
PHYS_ARGS = {
    "base": (),
    "conv": ("CONV_CAPE", "0.0", "CONV_MIX_PBL", "1"),
    "chem": ("SPECIES", "SO2",
             "CONV_CAPE", "0.0", "CONV_MIX_PBL", "1",
             "OH_CHEM_REACTION", "3", "H2O2_CHEM_REACTION", "1",
             "WET_DEPO_IC_A", "2.6e-5", "WET_DEPO_IC_B", "0.62",
             "WET_DEPO_BC_A", "2e-6", "WET_DEPO_BC_B", "0.62",
             "WET_DEPO_IC_H[0]", "5e5", "WET_DEPO_BC_H[0]", "5e5",
             "DRY_DEPO_VDEP", "0.01"),
}
PHYS_ARGS["full"] = PHYS_ARGS["chem"]


def make_setup(n_parcels: int, nx: int = 90, ny: int = 46, nz: int = 16,
               extra_args: Sequence[str] = (), device="cuda",
               dtype=torch.float32, q: float = 0.0, phys: str = "base"):
    """(ctl, clim, met01, atm, cache) of the flagship on ``device``.

    ``phys`` is the rung of the physics ladder (``PHYS_ARGS``):
    ``"base"``, ``"conv"``, ``"chem"`` or ``"full"`` (the same as
    ``"chem"``).

    ``dtype`` is the compute mode of the state: float32 (the mode the
    kernels need; time stays float64) or float64 (the reference-parity
    mode of the exact path).  ``extra_args`` are further ``KEY VALUE``
    control parameters (e.g. ``SORT_DT 1800``), which take precedence
    over ``FLAGSHIP_ARGS``; ``q`` is the uniform
    water vapour mixing ratio of the met fields (0 in the flagship;
    derived humidity quantities need it positive)."""
    if phys not in PHYS_ARGS:
        raise ValueError(f"phys {phys!r}: expected one of "
                         f"{', '.join(PHYS_ARGS)}")
    dev = resolve_device(device)
    # (the first occurrence of a key wins: extra_args override)
    ctl = read_ctl(None, list(extra_args) + list(PHYS_ARGS[phys])
                   + list(FLAGSHIP_ARGS))
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


def write_case(dirname: str, n_parcels: int, grid: Sequence[int],
               t_start: float, t_stop: float, sort_dt: float,
               dt_met: float = 3600.0, extra_ctl: Sequence[str] = (),
               quantities: Sequence[str] = ("t", "m"), wind_q: float = 0.0,
               wind_o3: float = 0.0) -> str:
    """The flagship as a working directory for ``tools.trac``: three
    netCDF met files of the solid-body wind ``dt_met`` apart from time 0
    (``dt_met`` a whole number of hours: file names carry the hour),
    ``atm_in.bin`` with the flagship's parcel positions at ``t_start``
    (binary, ``ATM_TYPE 1``), ``trac.ctl`` with the flagship's control
    parameters, binary particle output at ``t_stop`` only, and
    ``dirlist``.  ``extra_ctl`` are further ``KEY VALUE`` control
    parameters.  ``quantities`` are the parcels' quantities, from
    ``t`` (0), ``m`` (1), ``stat`` (0) and ``ens`` (the parcel's index
    mod 32).  ``wind_q`` and ``wind_o3`` are the met's uniform H2O and O3
    volume mixing ratios (the reference wind tool's ``WIND_Q`` and
    ``WIND_O3``).  Everything is made on the host.  Returns the
    dirlist's path."""
    import os

    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.met.read_nc import get_met_filename
    from mptrac_tpu_torch.met.write_nc import write_met_nc

    pairs = dict(zip(FLAGSHIP_ARGS[0::2], FLAGSHIP_ARGS[1::2]))
    del pairs["QNT_NAME[0]"], pairs["QNT_NAME[1]"]
    pairs["NQ"] = str(len(quantities))
    pairs.update({f"QNT_NAME[{i}]": name
                  for i, name in enumerate(quantities)})
    pairs.update({
        "METBASE": os.path.join(dirname, "met"), "DT_MET": str(dt_met),
        "SORT_DT": str(sort_dt), "ATM_TYPE": "1", "ATM_TYPE_OUT": "1",
        "ATM_BASENAME": "atm", "ATM_DT_OUT": "864000",
        "T_STOP": str(t_stop)})
    pairs.update(dict(zip(extra_ctl[0::2], extra_ctl[1::2])))
    ctl_file = os.path.join(dirname, "trac.ctl")
    with open(ctl_file, "w") as f:
        for k, v in pairs.items():
            f.write(f"{k} = {v}\n")
    ctl = read_ctl(ctl_file)
    nx, ny, nz = grid
    for k in range(3):
        met = make_wind_met(t0=k * dt_met, nx=nx, ny=ny, nz=nz, alpha=30.0,
                            q=wind_q, o3=wind_o3, device="cpu")
        write_met_nc(get_met_filename(ctl, k * dt_met, 1), met,
                     drop_wrap_column=True)
        del met
    rng = np.random.default_rng(0)

    def draw(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n_parcels))

    lon, lat, p = draw(-180, 180), draw(-60, 60), draw(200, 900)
    f64 = torch.float64
    made = {"t": lambda: torch.zeros(n_parcels, dtype=f64),
            "m": lambda: torch.ones(n_parcels, dtype=f64),
            "stat": lambda: torch.zeros(n_parcels, dtype=f64),
            "ens": lambda: (torch.arange(n_parcels) % 32).to(f64)}
    atm = Atm(time=torch.full((n_parcels,), float(t_start), dtype=f64), p=p,
              lon=lon, lat=lat, q={name: made[name]() for name in quantities},
              np=n_parcels)
    atm_io.write_atm(os.path.join(dirname, "atm_in.bin"), ctl, atm, t_start)
    dirlist = os.path.join(dirname, "dirlist")
    with open(dirlist, "w") as f:
        f.write(dirname + "\n")
    return dirlist
