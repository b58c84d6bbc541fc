"""Synthetic meteorology: solid-body-rotation wind fields.

Counterpart of the JAX package's ``met/synthetic.py`` (the reference
``wind`` tool, wind.c:62-180): a rotated solid-body flow (Williamson et
al. 1992 test case) on a global lat/lon grid, used for analytic
advection tests and for running without reanalysis data.  The fields
are built with numpy on the host and then moved to the device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.types import (MET_2D_FIELDS, MET_3D_FIELDS, Met,
                                    _axis_is_arithmetic, resolve_device)

_D2R = math.pi / 180.0


def make_wind_met(t0: float = 0.0, nx: int = 360, ny: int = 181,
                  nz: int = 61, z0: float = 0.0, z1: float = 60.0,
                  u0: float = 38.587660177302, u1: float = None,
                  w0: float = 0.0, alpha: float = 0.0,
                  temp0: float = 280.0, temp1: float = 280.0,
                  ps: float = 1013.25, zs: float = 0.0,
                  blh: float = 1.0, q: float = 0.0, o3: float = 0.0,
                  dtype=torch.float32, device="cuda") -> Met:
    """Build one synthetic met snapshot (wind.c:117-170).

    ``u0`` defaults to one revolution in ~12 days; ``alpha`` tilts the
    rotation axis off the pole (degrees).
    """
    dev = resolve_device(device)
    if u1 is None:
        u1 = u0
    # nx+1 columns: the wraparound column the reference adds in
    # read_met_periodic (c:11390) is built in directly.
    nx = nx + 1
    lon = 360.0 / (nx - 1) * np.arange(nx)
    lat = 180.0 / (ny - 1) * np.arange(ny) - 90.0
    z = z0 + (z1 - z0) * np.arange(nz) / (nz - 1.0)
    p = P0 * np.exp(-z / H0)
    # descending pressure (surface first) like reanalysis files
    clat = np.cos(_D2R * lat)[None, :, None]
    slat = np.sin(_D2R * lat)[None, :, None]
    clon = np.cos(_D2R * lon)[:, None, None]
    slon = np.sin(_D2R * lon)[:, None, None]
    ca, sa = math.cos(_D2R * alpha), math.sin(_D2R * alpha)
    uz = (u0 + (u1 - u0) * np.arange(nz) / (nz - 1.0))[None, None, :]
    u = uz * (clat * ca + slat * clon * sa)
    v = -uz * slon * sa + 0.0 * clat
    v = np.broadcast_to(v, (nx, ny, nz))
    u = np.broadcast_to(u, (nx, ny, nz))
    w = np.broadcast_to(-(1e-3 * w0) * p[None, None, :] / H0,
                        (nx, ny, nz))
    t = np.broadcast_to(
        (temp0 + (temp1 - temp0) * np.arange(nz) / (nz - 1.0)),
        (nx, ny, nz))

    def dev_t(a):
        # float64 -> field dtype on the host (numpy and XLA both round
        # to nearest), then one copy to the device
        return torch.from_numpy(np.array(a)).to(dtype).to(dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    f3: Dict[str, torch.Tensor] = {}
    for name in MET_3D_FIELDS:
        f3[name] = torch.zeros((nx, ny, nz), dtype=dtype, device=dev)
    f3["u"] = dev_t(u)
    f3["v"] = dev_t(v)
    f3["w"] = dev_t(w)
    f3["t"] = dev_t(t)
    # WIND_Q / WIND_O3: uniform vmr (wind.c:166-167)
    if q:
        f3["h2o"] = full((nx, ny, nz), q)
    if o3:
        f3["o3"] = full((nx, ny, nz), o3)
    f3["z"] = dev_t(np.broadcast_to(z, (nx, ny, nz)))

    f2: Dict[str, torch.Tensor] = {}
    for name in MET_2D_FIELDS:
        f2[name] = torch.zeros((nx, ny), dtype=dtype, device=dev)
    f2["ps"] = full((nx, ny), ps)
    f2["zs"] = full((nx, ny), zs)
    f2["ts"] = full((nx, ny), temp0)
    f2["us"] = dev_t(u[:, :, 0])
    f2["vs"] = dev_t(v[:, :, 0])
    f2["lsm"] = torch.ones((nx, ny), dtype=dtype, device=dev)
    f2["sst"] = full((nx, ny), temp0)
    f2["pbl"] = full((nx, ny), P0 * math.exp(-(zs + blh) / H0))
    f2["pt"] = full((nx, ny), 200.0)

    def axis(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dev)

    return Met(
        time=float(t0),
        lon=axis(lon), lat=axis(lat), p=axis(p),
        hybrid=torch.zeros(nz, dtype=torch.float64, device=dev),
        fields2d=f2, fields3d=f3, coord_type=0, npl_ml=0,
        reg_lon=_axis_is_arithmetic(lon),
        reg_lat=_axis_is_arithmetic(lat), lon_periodic=True)


def solid_body_solution(lon0, lat0, u0, t, alpha: float = 0.0):
    """Analytic trajectory of the rotated solid-body flow after time t
    [s]: rotate position by angle omega*t about the tilted axis.

    Positions in degrees (numpy); returns (lon, lat) in degrees with
    lon in [-180, 180).
    """
    from mptrac_tpu_torch.constants import RE
    omega = u0 / (1000.0 * RE)  # rad/s
    th = omega * t
    a = _D2R * alpha
    # axis of rotation: tilted from the pole toward lon=180 by alpha
    axis = np.array([-math.sin(a), 0.0, math.cos(a)])
    lam = np.deg2rad(np.asarray(lon0, float))
    phi = np.deg2rad(np.asarray(lat0, float))
    xyz = np.stack([np.cos(phi) * np.cos(lam),
                    np.cos(phi) * np.sin(lam),
                    np.sin(phi)], axis=-1)
    k = axis
    ct, st = math.cos(th), math.sin(th)
    rot = (xyz * ct + np.cross(np.broadcast_to(k, xyz.shape), xyz) * st
           + np.tensordot(xyz, k, axes=([-1], [0]))[..., None]
           * k * (1 - ct))
    lat = np.rad2deg(np.arcsin(np.clip(rot[..., 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(rot[..., 1], rot[..., 0]))
    return lon, lat
