"""The flagship configuration: solid-body wind on a global grid with
advection, turbulent and mesoscale diffusion and exponential decay, and
the physics ladder above it.

Counterpart of ``__graft_entry__._make_setup`` of the JAX package, with
the same control parameters for each ``phys`` and the same parcel
positions (numpy ``default_rng(0)``), so both packages can be started
from one state.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    ``t`` (0), ``m`` (1), ``stat`` (0), ``ens`` (the parcel's index mod
    32) and ``idx`` (the parcel's index).  ``wind_q`` and ``wind_o3``
    are the met's uniform H2O and O3 volume mixing ratios (the
    reference wind tool's ``WIND_Q`` and ``WIND_O3``).  Everything is
    made on the host.  Returns the dirlist's path."""
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
            "ens": lambda: (torch.arange(n_parcels) % 32).to(f64),
            "idx": lambda: torch.arange(n_parcels, dtype=f64)}
    atm = Atm(time=torch.full((n_parcels,), float(t_start), dtype=f64), p=p,
              lon=lon, lat=lat, q={name: made[name]() for name in quantities},
              np=n_parcels)
    atm_io.write_atm(os.path.join(dirname, "atm_in.bin"), ctl, atm, t_start)
    dirlist = os.path.join(dirname, "dirlist")
    with open(dirlist, "w") as f:
        f.write(dirname + "\n")
    return dirlist


def _convert_file(job):
    """File ``k`` of a case into a container: (path, stats).  A task of
    ``convert_case``, also in a worker process."""
    import os

    from mptrac_tpu_torch.met.bin_io import write_met_bin
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.met.read_nc import get_met_filename

    ctl_file, k, args = job
    ctl = read_ctl(ctl_file)
    bin_ctl = read_ctl(ctl_file, args)
    met = read_met(get_met_filename(ctl, k * ctl.dt_met, 1), ctl,
                   read_clim(ctl, device="cpu"), device="cpu")
    path = get_met_filename(bin_ctl, k * ctl.dt_met, 1)
    stats = []
    write_met_bin(path, met, bin_ctl.met_type,
                  pck_zstd=bool(bin_ctl.met_pck_zstd), ctl=bin_ctl,
                  stats=stats)
    return os.path.abspath(path), stats


def convert_case(dirname: str, met_type: int, extra_ctl: Sequence[str] = (),
                 stats: Optional[list] = None, workers: int = 1) -> list:
    """Convert the case's three netCDF met files (``write_case``) into
    binary containers of ``met_type`` beside them (``met/bin_io``, the
    port's writer: each file read and preprocessed on the host, then
    written; ``workers`` > 1 converts the files in as many processes)
    and set ``MET_TYPE`` and ``extra_ctl`` (e.g. ``MET_PCK_ZSTD 1``, a
    lossy codec's settings) in ``trac.ctl``.  ``stats`` collects each 3-D
    field's (name, codec, values, stored bytes).  Returns the paths
    written."""
    import os

    ctl_file = os.path.join(dirname, "trac.ctl")
    args = ["MET_TYPE", str(met_type), *extra_ctl]
    jobs = [(ctl_file, k, args) for k in range(3)]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_convert_file, jobs))
    else:
        done = [_convert_file(job) for job in jobs]
    if stats is not None:
        for _, st in done:
            stats.extend(st)
    with open(ctl_file, "a") as f:
        for key, value in zip(args[0::2], args[1::2]):
            f.write(f"{key} = {value}\n")
    return [path for path, _ in done]


#: (ECMWF code, 3-D field, the reader's scale) of the GRIB level set
GRIB_LEVEL_FIELDS = ((130, "t", 1.0), (131, "u", 1.0), (132, "v", 1.0),
                     (135, "w", 0.01), (133, "h2o", "h2o"), (203, "o3", "o3"))


def write_grib_met(path_xx: str, met, levels: Sequence[float],
                   when=(2000, 1, 1, 0, 0)) -> None:
    """One snapshot as a GRIB2 set for ``MET_TYPE 6`` (``io/grib2``'s
    encoder, 16-bit simple packing): ``path_xx`` with ``XX`` -> ``ml``
    holds t, u, v, w, h2o and o3 on the isobaric ``levels`` [hPa] (one a
    level of ``met``, whole hPa: GRIB's levels are integers), ``sf`` holds
    ps, zs, ts and lsm, each in the units that ``met/read_grib`` scales
    back.  The wraparound column of a periodic ``met`` is dropped."""
    from mptrac_tpu_torch.constants import G0, MA, MH2O, MO3
    from mptrac_tpu_torch.io.grib2 import encode_message

    if len(levels) != met.npl or len(set(int(x) for x in levels)) != met.npl:
        raise ValueError("one distinct whole-hPa level per met level")
    nx = met.nx - 1 if met.lon_periodic else met.nx
    lon, lat = met.lon[:nx].cpu().numpy(), met.lat.cpu().numpy()
    scales = {"h2o": MA / MH2O, "o3": MA / MO3}

    def grid(a):
        return np.ascontiguousarray(a.cpu().numpy()[:nx].T, np.float64)

    ml = bytearray()
    for code, name, scale in GRIB_LEVEL_FIELDS:
        scale = scales.get(scale, scale)
        for k, lev in enumerate(levels):
            ml += encode_message(code, int(lev),
                                 grid(met.fields3d[name][:, :, k]) / scale,
                                 lon, lat, when=when, level_type=100)
    sf = bytearray()
    for code, name, scale in ((134, "ps", 0.01), (129, "zs", 1 / (1000 * G0)),
                              (167, "ts", 1.0), (172, "lsm", 1.0)):
        sf += encode_message(code, 0, grid(met.fields2d[name]) / scale, lon,
                             lat, when=when, level_type=1)
    with open(path_xx.replace("XX", "ml"), "wb") as f:
        f.write(ml)
    with open(path_xx.replace("XX", "sf"), "wb") as f:
        f.write(sf)
