"""The reference of the domain-decomposed configuration (``configs/dd``):
the same physics as the undecomposed run, on the global slots with the
global met.  Written from MPTRAC's equations (mptrac.c module_timesteps,
module_position, module_advect with ADVECT 2, module_meteo) on the
exact path; no diffusion (``DIFFUSION 0``: no random draw, the counter
does not advance) and no decay.  The quantities are ``t`` (the met's
temperature at the parcel) and ``idx`` (the parcel's index, carried
unchanged); the checks hold the index in the place of the mass ``m``.

The decomposition (``DD``, its subdomains and halo) is the program's
path, not its physics: the keys are ``PATH_KEYS``.  ``owner`` names the
subdomain that owns a position, written from MPTRAC's
``dd_assign_subdomains`` (mptrac.c:1918): the global grid cell of the
position, its zonal index split into ``n_zonal`` runs of ``nx //
n_zonal`` cells (the last takes the rest), its meridional index into
``n_merid`` runs of ``ceil(ny / n_merid)`` rows, the subdomain
``zonal * n_merid + meridional``.

Plain PyTorch on the CPU; it imports nothing of the program, and no
JAX.  The helpers of ``reference.py`` (its met pair, locate, trilinear
interpolation, position and the degree conversions) are reused.
"""

import math

import numpy as np
import torch

from benchmark import reference

F64 = torch.float64

#: the configuration's keys that this reference models, and their values
MODELS = {
    "NQ": ("2",), "QNT_NAME[0]": ("t",), "QNT_NAME[1]": ("idx",),
    "T_STOP": None, "ADVECT": ("2",), "DIFFUSION": ("0",),
}
#: keys that choose the program's path: the kernels, the sort, the step
#: length, and the decomposition, which must not change the physics
PATH_KEYS = ("TPU_FAST", "SORT_DT", "DT_MOD", "DD", "DD_SUBDOMAINS_ZONAL",
             "DD_SUBDOMAINS_MERIDIONAL", "DD_HALOS_SIZE")

#: the fields of the program's met pair compared with ``ingest`` (file
#: cells)
INGESTED = ("u", "v", "w", "t", "ps")

#: a position this close to a subdomain's edge [deg] may be owned by
#: either side: the program decides ownership in the state's float32
#: (a longitude near 360 carries 3e-5 deg), this reference in float64
EDGE_DEG = 1e-4


def params(pairs: list) -> dict:
    """The reference's parameters from a ``KEY VALUE`` list."""
    kv = dict(zip(pairs[0::2], pairs[1::2]))
    return {"t_start": 0.0, "t_stop": float(kv.get("T_STOP", 0.0))}


def load_clim(files: dict):
    """No climatology: nothing in this configuration reads one."""
    return None


def met_pair(times, a, b) -> reference.Met:
    """The pair of the fields the step reads: the winds, the
    temperature and the surface pressure (``position``'s reflection)."""
    lon, lat, p, f2, f3 = a
    return reference.met_pair(times, lon, lat, p, f2, f3, b[3], b[4],
                              names2=("ps",), names3=("u", "v", "w", "t"))


def ingest(path: str, dtype=torch.float32) -> tuple:
    s = reference.ingest_nc(path, dtype)
    return s["lon"], s["lat"], s["p"], s["f2"], s["f3"]


def step(ctl: dict, met: reference.Met, clim, state: dict, t: float,
         ctr, total: int, slots: torch.Tensor, dtype=F64) -> dict:
    """One model step at time ``t`` of the sampled parcels from
    ``state`` (``time`` float64, ``lon``, ``lat``, ``p``, ``t``, ``m``
    holding the index, ``u``, ``v``, ``w``): the position, the midpoint
    advection, the position again, the temperature at the new position
    and time.  ``ctr``, ``total`` and ``slots`` are the plain
    reference's signature: nothing here draws."""
    time = state["time"].to(F64)
    lon, lat, p = (state[k].to(dtype) for k in ("lon", "lat", "p"))
    active = ((time - ctl["t_start"] >= 0) & (time - ctl["t_stop"] <= 0)
              & (time - t < 0))
    dt64 = torch.where(active, t - time, 0.0)
    dt = dt64.to(dtype)

    lon, lat, p = reference.position(met, lon, lat, p, time, active)

    # midpoint advection (module_advect, ADVECT 2)
    u0, v0, w0 = reference._winds(met, lon, lat, p,
                                  reference.time_weight(met, time, dtype))
    half = 0.5 * dt
    xlon = lon + reference.dx2deg(half * u0 / 1000.0, lat)
    xlat = lat + reference.dy2deg(half * v0 / 1000.0)
    xp = p + half * w0
    u1, v1, w1 = reference._winds(
        met, xlon, xlat, xp,
        reference.time_weight(met, time + 0.5 * dt64, dtype))
    time = torch.where(active, time + dt64, time)
    lon = torch.where(active, lon + reference.dx2deg(dt * u1 / 1000.0, xlat),
                      lon)
    lat = torch.where(active, lat + reference.dy2deg(dt * v1 / 1000.0), lat)
    p = torch.where(active, p + dt * w1, p)

    lon, lat, p = reference.position(met, lon, lat, p, time, active)

    # meteo: the temperature at the new position and time
    temp = reference.interp3(met, "t", reference.locate(met, lon, lat, p),
                             reference.time_weight(met, time, dtype))
    return {"time": time, "lon": lon, "lat": lat, "p": p, "t": temp,
            "m": state["m"].to(dtype), "u": state["u"].to(dtype),
            "v": state["v"].to(dtype), "w": state["w"].to(dtype)}


def step_versions(ctl: dict, met: reference.Met, clim, state: dict,
                  t: float, ctr, total: int, slots: torch.Tensor,
                  dtype=F64) -> list:
    """``step``'s result: no threshold of this physics has two sides."""
    return [step(ctl, met, clim, state, t, ctr, total, slots, dtype)]


def owner(lon, lat, lon_axis, lat_axis, n_zonal: int, n_merid: int
          ) -> np.ndarray:
    """The subdomain that owns each position (numpy, float64): ``lon``
    and ``lat`` [deg] on the global grid of ``lon_axis`` (regular and
    periodic, its wraparound column included, as MPTRAC's reader appends
    it) and ``lat_axis`` (monotone)."""
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    lon_axis = np.asarray(lon_axis, np.float64)
    lat_axis = np.asarray(lat_axis, np.float64)
    nx, ny = lon_axis.size, lat_axis.size
    lon0, dlon = lon_axis[0], lon_axis[1] - lon_axis[0]
    wrapped = lon0 + np.mod(lon - lon0, 360.0)
    ix = np.clip(np.floor((wrapped - lon0) / dlon), 0, nx - 1).astype(int)
    asc = lat_axis if lat_axis[0] < lat_axis[-1] else lat_axis[::-1]
    iy = np.clip(np.searchsorted(asc, lat, side="right") - 1, 0, ny - 1)
    zonal = np.minimum(ix // (nx // n_zonal), n_zonal - 1)
    merid = np.minimum(iy // math.ceil(ny / n_merid), n_merid - 1)
    return zonal * n_merid + merid


def owners_near(lon, lat, lon_axis, lat_axis, n_zonal: int, n_merid: int,
                edge: float = EDGE_DEG) -> np.ndarray:
    """[5, m]: the owner of each position and of the four positions
    ``edge`` degrees east, west, north and south of it.  A parcel held
    by any of them is held by its owner within the rounding of the
    state's float32 (a position on an edge may be decided either way)."""
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    moves = ((0, 0), (edge, 0), (-edge, 0), (0, edge), (0, -edge))
    return np.stack([owner(lon + dx, lat + dy, lon_axis, lat_axis,
                           n_zonal, n_merid) for dx, dy in moves])
