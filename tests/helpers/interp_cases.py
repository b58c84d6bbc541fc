"""Met pairs and parcels that reach every branch of the plain
interpolation (``mptrac_tpu_torch/ops/interp.py``), for holding its
kernels (``csrc/plain_interp.cu``) to its plain versions.

A case is a stacked met pair on a small grid with random fields and
parcels with times.  ``KINDS`` name the grid: the pressure axis
ascending or descending, the latitudes regular (``reg_lat``, the
arithmetic branch of ``_axis_vals``) or irregular, lat/lon or Cartesian
coordinates (with the longitudes looked up instead of computed).  The
parcels include longitudes to be wrapped (negative, beyond 360), points
on every node, at and beyond both ends of each axis, NaN and +-inf
coordinates and times outside the met pair's; ``order`` "sorted" puts
them in the order of their cells, as the sort leaves them.  The fields
hold non-zero cloud water, cloud-free columns (NaN ``pct`` and ``pcb``),
non-finite corners and a snapshot that is not finite.
"""

import numpy as np
import torch

from mptrac_tpu_torch.types import Met

#: (pressure axis, latitudes, coordinates)
KINDS = ("down-reg-lonlat", "up-reg-lonlat", "down-irr-lonlat",
         "up-irr-cartesian", "down-reg-cartesian")
FIELDS3 = ("t", "lwc", "rwc", "u")
FIELDS2 = ("ps", "pct", "pcb", "cl", "pel")
NX, NY, NZ = 37, 19, 9
T0, T1 = 3600.0, 7200.0


def bits(t):
    """A tensor's bit patterns, so that equal means bit for bit: NaN
    payloads and signed zeros count."""
    return t.view(torch.int32) if t.dtype == torch.float32 else (
        t.view(torch.int64) if t.dtype == torch.float64 else t)


def make_met(kind: str, device, dtype=torch.float32, seed: int = 3) -> Met:
    """The met pair of ``kind`` (one of ``KINDS``) in ``dtype``."""
    p_dir, lat_kind, coords = kind.split("-")
    rng = np.random.default_rng(seed)
    lon = np.arange(NX) * 10.0
    lat = np.linspace(-90.0, 90.0, NY)
    if lat_kind == "irr":
        lat = np.sort(lat + rng.uniform(-3.0, 3.0, NY))
        lat[0], lat[-1] = -90.0, 90.0
    p = 1013.25 * np.exp(-np.linspace(0.0, 60.0, NZ) / 7.0)
    if p_dir == "up":
        p = p[::-1].copy()
    if coords == "cartesian":
        lon = lon * 1e3 - 1.5e5
        lat = lat * 2e3

    def field(shape, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                               device=device)

    f3 = {name: field((2, NX, NY, NZ), -50.0, 300.0) for name in FIELDS3}
    lwc = rng.uniform(0.0, 1e-3, (2, NX, NY, NZ))
    lwc[lwc < 4e-4] = 0.0                  # cloud water in some cells
    f3["lwc"] = torch.as_tensor(lwc, dtype=dtype, device=device)
    f3["u"][0, 3, 4, 5] = float("nan")      # non-finite corners
    f3["u"][1, 7, 8, 2] = float("inf")
    f2 = {name: field((2, NX, NY), 100.0, 1000.0) for name in FIELDS2}
    clear = torch.as_tensor(rng.uniform(size=(2, NX, NY)) < 0.5,
                            device=device)
    for name in ("pct", "pcb"):            # cloud-free columns
        f2[name][clear] = float("nan")
    f2["ps"][0, 5, 6] = float("-inf")
    f2["pel"][1] = float("nan")            # a snapshot not finite

    def axis(a):
        return torch.as_tensor(np.stack([a, a]), dtype=dtype, device=device)

    return Met(time=(T0, T1), lon=axis(lon), lat=axis(lat), p=axis(p),
               hybrid=axis(np.arange(NZ, dtype=np.float64)),
               fields2d=f2, fields3d=f3,
               coord_type=1 if coords == "cartesian" else 0,
               reg_lon=coords != "cartesian", reg_lat=lat_kind == "reg")


def make_parcels(met: Met, n: int, order: str = "random", seed: int = 5,
                 dtype=None):
    """(lon, lat, p, ts) of ``n`` parcels in ``met``: coordinates in
    ``dtype`` (the met's by default), times float64."""
    rng = np.random.default_rng(seed)
    lons, lats, ps = (np.asarray(a[0].cpu(), np.float64)
                      for a in (met.lon, met.lat, met.p))
    span = lons[-1] - lons[0]
    lon = rng.uniform(lons[0] - 1.2 * span, lons[-1] + 1.2 * span, n)
    if met.coord_type == 0:
        lon = rng.uniform(-400.0, 760.0, n)
    lat = rng.uniform(lats[0] - 0.1 * abs(lats[0]),
                      lats[-1] + 0.1 * abs(lats[-1]), n)
    p = rng.uniform(0.5 * ps.min(), 1.2 * ps.max(), n)
    ts = rng.uniform(T0 - 600.0, T1 + 600.0, n)
    k = 0
    for ax, arr in ((lons, lon), (lats, lat), (ps, p)):
        arr[k:k + ax.size] = ax            # exactly on the nodes
        k += ax.size
    edges = [lons[0], lons[-1], lons[0] - 1e-3, lons[-1] + 1e-3]
    if met.coord_type == 0:
        edges += [0.0, 360.0, -180.0, 180.0, -360.0, 720.0]
    lon[k:k + len(edges)] = edges
    lat[k:k + 4] = [lats[0], lats[-1], 2 * lats[0], 2 * lats[-1]]
    p[k:k + 4] = [ps[0], ps[-1], 2 * ps.max(), 0.1 * ps.min()]
    ts[k:k + 2] = [T0, T1]
    for j, bad in enumerate((np.nan, np.inf, -np.inf)):
        lon[k + 20 + j::97] = bad
        lat[k + 30 + j::89] = bad
        p[k + 40 + j::83] = bad
    dtype = dtype or met.lon.dtype
    dev = met.lon.device
    out = [torch.as_tensor(a, dtype=dtype, device=dev)
           for a in (lon, lat, p)]
    out.append(torch.as_tensor(ts, dtype=torch.float64, device=dev))
    if order == "sorted":
        from mptrac_tpu_torch.ops import interp
        loc = interp.locate_3d_plain(met, *out[:3])
        key = ((loc.iz.long() * NX + loc.ix) * NY + loc.iy)
        perm = torch.argsort(key, stable=True)
        out = [a[perm].contiguous() for a in out]
    return tuple(out)
