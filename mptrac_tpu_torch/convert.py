"""State carried across between the JAX package and this one.

Both directions go through plain dicts of numpy arrays, so this module
imports no JAX: the caller (a test) turns the JAX pytrees into dicts
with ``np.asarray``.  Dtypes are kept: time float64, the state in the
dtype it has (float32 in fp32 mode), ``uvwp`` float32, ``rng_ctr`` and
``np`` as Python ints.

Dict layouts (the field names of the JAX dataclasses):

* atm:   time, p, lon, lat, q (dict name -> array), np
* cache: uvwp, dt, rng_ctr, iso_var, iso_ps, iso_ts, iso_n, served_min
* met (a snapshot or a stacked pair): time, lon, lat, p, hybrid,
  fields2d, fields3d (dicts), and the static coord_type, npl_ml,
  reg_lon, reg_lat, lon_periodic; ``time`` becomes a host float (pair)
* clim:  tropo_time, tropo_lat, tropo, photo_p, photo_sza, photo_o3c,
  photo (dict), zm (dict name -> dict time, lat, p, vmr), ts (dict
  name -> dict time, vmr)
"""

from __future__ import annotations

import numpy as np
import torch

from mptrac_tpu_torch.types import (Atm, Cache, Clim, ClimTs, ClimZm, Met,
                                    resolve_device)


def _t(a, dev):
    return torch.from_numpy(np.array(a)).to(dev)     # (a copy)


def _host_time(t):
    """Met.time as the port keeps it: a host float, or a pair of them."""
    t = np.asarray(t, np.float64)
    return float(t) if t.ndim == 0 else tuple(float(x) for x in t)


def _zm(d, dev):
    return ClimZm(time=_t(d["time"], dev), lat=_t(d["lat"], dev),
                  p=_t(d["p"], dev), vmr=_t(d["vmr"], dev))


def from_reference(atm=None, cache=None, met01=None, clim=None,
                   device="cuda"):
    """Build this package's (Atm, Cache, Met, Clim) from dicts of numpy
    arrays; a part passed as None comes back as None."""
    dev = resolve_device(device)
    out = []
    out.append(None if atm is None else Atm(
        time=_t(atm["time"], dev), p=_t(atm["p"], dev),
        lon=_t(atm["lon"], dev), lat=_t(atm["lat"], dev),
        q={k: _t(v, dev) for k, v in atm["q"].items()},
        np=int(atm["np"])))
    out.append(None if cache is None else Cache(
        uvwp=_t(cache["uvwp"], dev), dt=_t(cache["dt"], dev),
        rng_ctr=int(cache["rng_ctr"]),
        iso_var=_t(cache["iso_var"], dev),
        iso_ps=_t(cache["iso_ps"], dev), iso_ts=_t(cache["iso_ts"], dev),
        iso_n=int(cache["iso_n"]),
        served_min=(None if cache.get("served_min") is None
                    else float(cache["served_min"]))))
    out.append(None if met01 is None else Met(
        time=_host_time(met01["time"]), lon=_t(met01["lon"], dev),
        lat=_t(met01["lat"], dev), p=_t(met01["p"], dev),
        hybrid=_t(met01["hybrid"], dev),
        fields2d={k: _t(v, dev) for k, v in met01["fields2d"].items()},
        fields3d={k: _t(v, dev) for k, v in met01["fields3d"].items()},
        coord_type=int(met01["coord_type"]),
        npl_ml=int(met01["npl_ml"]), reg_lon=bool(met01["reg_lon"]),
        reg_lat=bool(met01["reg_lat"]),
        lon_periodic=bool(met01["lon_periodic"])))
    out.append(None if clim is None else Clim(
        tropo_time=_t(clim["tropo_time"], dev),
        tropo_lat=_t(clim["tropo_lat"], dev),
        tropo=_t(clim["tropo"], dev),
        photo_p=_t(clim["photo_p"], dev),
        photo_sza=_t(clim["photo_sza"], dev),
        photo_o3c=_t(clim["photo_o3c"], dev),
        photo={k: _t(v, dev) for k, v in clim["photo"].items()},
        zm={k: _zm(v, dev) for k, v in clim["zm"].items()},
        ts={k: ClimTs(time=_t(v["time"], dev), vmr=_t(v["vmr"], dev))
            for k, v in clim["ts"].items()}))
    return tuple(out)


def _n(t):
    return t.detach().cpu().numpy()


def to_reference_numpy(atm: Atm = None, cache: Cache = None):
    """(atm dict, cache dict) of numpy arrays in the layouts above; a
    part passed as None comes back as None."""
    a = None if atm is None else dict(
        time=_n(atm.time), p=_n(atm.p), lon=_n(atm.lon), lat=_n(atm.lat),
        q={k: _n(v) for k, v in atm.q.items()}, np=int(atm.np))
    c = None if cache is None else dict(
        uvwp=_n(cache.uvwp), dt=_n(cache.dt), rng_ctr=int(cache.rng_ctr),
        iso_var=_n(cache.iso_var), iso_ps=_n(cache.iso_ps),
        iso_ts=_n(cache.iso_ts), iso_n=int(cache.iso_n),
        served_min=cache.served_min)
    return a, c
