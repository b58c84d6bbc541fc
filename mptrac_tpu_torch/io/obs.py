"""Observation data reader (reference read_obs / read_obs_asc /
read_obs_nc, mptrac.c:12009-12110).

Own copy of the JAX package's ``io/obs.py``: observations stay numpy
arrays on the host (a few thousand rows); the writers bin them there.
"""

from __future__ import annotations

import numpy as np

from mptrac_tpu_torch.config import Ctl


def read_obs(filename: str, ctl: Ctl):
    """(rt, rz, rlon, rlat, robs) float64 arrays; the time must be
    ascending (checked, like the reference)."""
    if ctl.obs_type == 0:
        data = _read_obs_asc(filename)
    elif ctl.obs_type == 1:
        data = _read_obs_nc(filename)
    else:
        raise ValueError("Set OBS_TYPE to 0 or 1!")
    if np.any(np.diff(data[0]) < 0):
        raise ValueError("Time must be ascending!")
    return data


def _read_obs_asc(filename):
    rows = []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 5:
                try:
                    rows.append([float(x) for x in toks[:5]])
                except ValueError:
                    continue
    a = np.array(rows) if rows else np.zeros((0, 5))
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4]


def _read_obs_nc(filename):
    from mptrac_tpu_torch.io.hdf5 import open_netcdf_any
    v, nc = open_netcdf_any(filename)
    try:
        return tuple(np.array(v[k][:], np.float64)
                     for k in ("time", "alt", "lon", "lat", "obs"))
    finally:
        if hasattr(nc, "close"):
            nc.close()
