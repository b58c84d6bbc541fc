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

``diff_turb_case`` adds the surface table and a turbulent diffusion's
state (``physics/diffusion.py``, its kernel ``csrc/diff_turb.cu``): a
boundary layer, parcels near the poles, masked parcels, dt of zero and
of both signs.
"""

import numpy as np
import torch

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.ops.slab_interp import SFC_FIELDS, build_sfc_table
from mptrac_tpu_torch.types import Atm, Cache, Met

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


#: the turbulent diffusion's control parameters: every layer's
#: diffusivities non-zero and a boundary layer that blends over 0.3 of
#: its depth; ``DIFF_CASES`` override them to reach each branch
DIFF_ARGS = ("DIFFUSION", "1", "TURB_DX_PBL", "50", "TURB_DX_TROP", "50",
             "TURB_DX_STRAT", "5", "TURB_DZ_PBL", "20", "TURB_DZ_TROP", "2",
             "TURB_DZ_STRAT", "0.1", "TURB_PBL_TRANS", "0.3")
DIFF_CASES = {
    "base": (),
    # kz of 1e5 m^2/s: steps of tens of km, reflected several times at
    # both ends
    "reflect": ("TURB_DZ_PBL", "1e5", "TURB_DZ_TROP", "1e5",
                "TURB_DZ_STRAT", "1e5"),
    "pbl_scheme": ("TURB_PBL_SCHEME", "1"),
    "no_kx": ("TURB_DX_PBL", "0", "TURB_DX_TROP", "0", "TURB_DX_STRAT", "0"),
    "no_kz": ("TURB_DZ_PBL", "0", "TURB_DZ_TROP", "0", "TURB_DZ_STRAT", "0"),
    "utm": ("MET_COORD_TYPE", "1", "MET_UTM_REF_LAT", "47.5",
            "MET_UTM_REF_LON", "9.0"),
}


def diff_turb_case(kind: str, n: int, device, case: str = "base",
                   order: str = "random",
                   ctr: int = (1 << 64) - 7, part=None, seed: int = 7,
                   dtype=torch.float32):
    """(ctl, cache, clim, met, atm, sfcT) of a ``module_diff_turb`` call
    on the met pair of ``kind`` with the surface fields it lacks (``pbl``
    between 0.5 and 1.1 of ``ps``, so some parcels lie in the boundary
    layer and some surfaces are below it), ``DIFF_CASES[case]``'s control
    parameters and the parcels of ``make_parcels``: one in ten masked
    (``atm.np``), one in seven with dt 0, the others with dt of either
    sign.  The climatology's tables are float32, as every float32 run
    holds them (``astype_state``); the counter
    ``ctr`` wraps at 2^64 inside the draw; ``part`` is ``rng_part``.  The
    state and the met are ``dtype`` (float32, the kernel's)."""
    rng = np.random.default_rng(seed)
    met = make_met(kind, device, dtype)
    f2 = dict(met.fields2d)
    ps = f2["ps"]
    for name in SFC_FIELDS:
        if name not in f2:
            f2[name] = torch.as_tensor(rng.uniform(0.0, 300.0, ps.shape),
                                       dtype=ps.dtype, device=ps.device)
    f2["pbl"] = ps * torch.as_tensor(rng.uniform(0.5, 1.1, ps.shape),
                                     dtype=ps.dtype, device=ps.device)
    f2["pbl"][1, 9, 2] = float("nan")
    met = met.replace(fields2d=f2)
    lon, lat, p, ts = make_parcels(met, n, order, seed=seed)
    if met.coord_type == 0 and n >= 206:        # at and near the poles
        lat[200:206] = torch.tensor([-90.0, 90.0, -89.9995, 89.9995,
                                     -89.99, 89.99])
    dt = rng.uniform(-360.0, 360.0, n)
    dt[::7] = 0.0
    ctl = read_ctl(None, list(DIFF_CASES[case]) + list(DIFF_ARGS))
    clim = read_clim(ctl, device=device)
    clim = clim.replace(**{k: getattr(clim, k).float() for k in (
        "tropo_time", "tropo_lat", "tropo")})
    cache = Cache.zeros(n, dtype=dtype, iso_npmax=1, device=device)
    cache = cache.replace(dt=torch.as_tensor(dt, dtype=dtype, device=device),
                          rng_ctr=ctr, rng_part=part)
    atm = Atm(time=ts, p=p, lon=lon, lat=lat, q={}, np=n - n // 10)
    return ctl, cache, clim, met, atm, build_sfc_table(met)
