"""Met snapshot assembly: read + preprocess -> Met.

Counterpart of the JAX package's ``met/build.py``: orchestrates the
reference ``mptrac_read_met`` chain (mptrac.c:7436-7545).  netCDF
(``MET_TYPE 0``) and GRIB (6) files go through the host chain with
numpy, and the finished fields are uploaded to ``device``.  The binary
containers (1-5, 7, 8) store fields that are already preprocessed: they
skip the chain, and ``met/bin_io`` decodes their numeric stage on the
device itself.
"""

from __future__ import annotations

import time as _time
from typing import Dict

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.met.bin_io import BIN_TYPES
from mptrac_tpu_torch.types import Met, _axis_is_arithmetic, resolve_device

#: every MET_TYPE with a reader: netCDF, the binary containers, GRIB
MET_TYPES = (0, 6) + BIN_TYPES


def interp_columns_at(field3, lon, lat, p, ptarget, coord_type=0):
    """Sample a 3-D field at per-column target pressures on its own
    grid points (used for tropopause diagnostics, reference
    c:11983-12006: intpol_met_space_3d at every (lon[ix], lat[iy])).

    On grid points the horizontal weights are exactly 1, so this is a
    pure vertical interpolation in the reference weight convention.
    """
    f = field3.astype(np.float64)
    pt = ptarget.astype(np.float64)
    npl = p.size
    # reference locate_irr on descending p
    if p[1] > p[0]:
        iz = np.clip(np.searchsorted(p, pt, side="right") - 1, 0, npl - 2)
    else:
        iz = np.clip(np.searchsorted(-p, -pt, side="left") - 1, 0, npl - 2)
    iz = np.where(np.isfinite(pt), iz, 0).astype(np.int64)
    wz = (p[iz + 1] - pt) / (p[iz + 1] - p[iz])
    lo = np.take_along_axis(f, iz[..., None], -1)[..., 0]
    hi = np.take_along_axis(f, iz[..., None] + 1, -1)[..., 0]
    out = wz * (lo - hi) + hi
    return np.where(np.isfinite(pt), out, np.nan).astype(np.float32)


def check_met_type(ctl: Ctl) -> None:
    """Raise for a ``MET_TYPE`` that names no reader."""
    if ctl.met_type not in MET_TYPES:
        raise NotImplementedError(
            f"MET_TYPE {ctl.met_type}: no such meteo data type")


def read_met(filename: str, ctl: Ctl, clim=None, device="cuda",
             timings: Dict[str, float] = None, sel=None) -> Met:
    """Read one meteo file and run the preprocessing chain
    (reference mptrac_read_met, c:7436).  ``timings``, when given, gets
    the seconds of the stages added: ``read``, ``preprocess`` and
    ``upload`` for netCDF and GRIB files (``read`` includes the GRIB bit
    unpacking), ``bin_io.STAGES`` for the binary containers.  ``sel``
    (``parallel.dd.tile_selection``) restricts a netCDF read to a
    horizontal hyperslab, and the chain then runs on that tile only;
    other formats have no hyperslab read and raise."""
    from mptrac_tpu_torch.met import process

    dev = resolve_device(device)
    check_met_type(ctl)
    if sel is not None and ctl.met_type != 0:
        raise NotImplementedError(
            f"read_met: a hyperslab (sel) of MET_TYPE {ctl.met_type}; only "
            "netCDF files (MET_TYPE 0) are read by tile")
    if ctl.met_type in BIN_TYPES:
        # Binary containers store fully preprocessed fields
        # (reference c:7481 applies the chain to nc/grib only)
        from mptrac_tpu_torch.met.bin_io import read_met_bin
        raw = read_met_bin(filename, ctl, device=dev, timings=timings)
        if raw["p"][0] < raw["p"][-1]:
            raise ValueError("Pressure levels must be descending!")
        return _to_met(ctl, raw, raw["lon"], raw["lat"], raw["p"],
                       raw["fields2d"], raw["fields3d"], dev)
    t0 = _time.perf_counter()
    if ctl.met_type == 0:
        from mptrac_tpu_torch.met.read_nc import read_met_nc
        raw = read_met_nc(filename, ctl, sel=sel)
    else:
        from mptrac_tpu_torch.met.read_grib import read_met_grib
        raw = read_met_grib(filename, ctl)
    t1 = _time.perf_counter()
    lon = raw["lon"]
    lat = raw["lat"]
    p = raw["p"]
    f2: Dict[str, np.ndarray] = raw["fields2d"]
    f3: Dict[str, np.ndarray] = raw["fields3d"]

    if p[0] < p[-1] and ctl.met_vert_coord == 0:
        # Model-level input (met_vert_coord != 0): the level variable
        # is an index; the pressure axis comes from ml2pl below.
        raise ValueError("Pressure levels must be descending!")

    # Model-level handling: compute pl and interpolate to target
    # pressure levels (reference read_met_nc_levels, c:9740-9835)
    target_p = None
    if ctl.met_np > 0 or ctl.met_press_level_def >= 0:
        if ctl.met_press_level_def >= 0:
            target_p = process.level_definitions(ctl.met_press_level_def)
        else:
            target_p = np.asarray(ctl.met_p)
    if target_p is not None and "pl" in f3 and np.any(f3["pl"]):
        process.monotonize(ctl, raw["hybrid"], f3)
        process.ml2pl(ctl, f3, target_p)
        p = target_p

    # Preprocessing chain in reference order (c:7480-7530)
    process.extrapolate(f3)
    process.polar_winds(lon, lat, f3, ctl.met_coord_type)
    if ctl.met_coord_type == 0:
        nlon0 = len(lon)
        lon, f2, f3 = process.periodic(lon, f2, f3)
        raw["lon_periodic"] = len(lon) != nlon0
    lon, lat, p, f2, f3 = process.sample_grid(ctl, lon, lat, p, f2, f3)
    process.geopot(ctl, lon, lat, p, f2, f3)
    process.pv(lon, lat, p, f3, ctl.met_coord_type)
    process.pbl(ctl, lon, lat, p, f2, f3)
    process.tropopause(ctl, clim, raw["time"], lon, lat, p, f2, f3)
    process.cloud(lon, lat, p, f2, f3)
    if ctl.met_cape == 1:
        from mptrac_tpu_torch.met.cape import compute_cape
        compute_cape(ctl, raw["time"], lon, lat, p, f2, f3)
    process.ozone_column(p, f2, f3)
    process.detrend(ctl, lon, lat, p, f3)
    if raw.get("npl_ml", 0) and ctl.advect_vert_coord == 1:
        process.monotonize(ctl, raw["hybrid"], f3)

    _log_ranges(filename, raw, lon, lat, p, f2, f3)
    t2 = _time.perf_counter()
    met = _to_met(ctl, raw, lon, lat, p, f2, f3, dev)
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = _time.perf_counter()
        for key, dt in (("read", t1 - t0), ("preprocess", t2 - t1),
                        ("upload", t3 - t2)):
            timings[key] = timings.get(key, 0.0) + dt
    return met


def _log_ranges(filename, raw, lon, lat, p, f2, f3):
    """Met data-range logging at LOGLEV >= 2 (reference read_met grid
    and variable logs, c:9448-9456 and the per-variable LOG(2) lines of
    read_met_nc_2d/3d)."""
    from mptrac_tpu_torch.utils.log import LOG, get_level
    if get_level() < 2:
        return
    LOG(2, "Read meteo data: %s", filename)
    LOG(2, "Time: %.2f", float(raw["time"]))
    LOG(2, "Grid: %d x %d x %d "
        "(lon %g ... %g, lat %g ... %g, p %g ... %g hPa)",
        lon.size, lat.size, p.size, lon[0], lon[-1], lat[0], lat[-1],
        p[0], p[-1])
    for name in ("t", "u", "v", "w", "h2o", "o3"):
        a = f3.get(name)
        if a is not None and np.isfinite(a).any():
            LOG(2, "%s range: %g ... %g", name,
                np.nanmin(a), np.nanmax(a))
    ps = f2.get("ps")
    if ps is not None and np.isfinite(ps).any():
        LOG(2, "ps range: %g ... %g hPa", np.nanmin(ps), np.nanmax(ps))


def _to_met(ctl: Ctl, raw, lon, lat, p, f2, f3, dev) -> Met:
    """The finished fields as a ``Met`` on ``dev``: float64 axes,
    float32 fields (host arrays uploaded, device tensors as they are),
    the time a host float.  ``lon_periodic`` is what the reader set,
    False for a binary container, as in the JAX package."""
    def axis(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float64)).to(dev)

    def fld(a):
        if isinstance(a, torch.Tensor):       # decoded on the device
            return a.to(dev, torch.float32)
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    return Met(
        time=float(raw["time"]),
        lon=axis(lon), lat=axis(lat), p=axis(p),
        hybrid=axis(raw["hybrid"]),
        fields2d={k: fld(v) for k, v in f2.items()},
        fields3d={k: fld(v) for k, v in f3.items()},
        coord_type=ctl.met_coord_type,
        npl_ml=raw["npl_ml"],
        reg_lon=_axis_is_arithmetic(lon),
        reg_lat=_axis_is_arithmetic(lat),
        lon_periodic=bool(raw.get("lon_periodic", False)),
    )
