"""Core state containers: dataclasses of torch tensors.

Counterpart of the JAX package's ``mptrac_tpu/types.py`` (the MPTRAC
data model, reference mptrac.h:2284-3832), with the same fields:

* particle capacity ``npmax`` with a live count ``np`` and a prefix
  validity mask instead of a dynamic ``atm->np``;
* a met pair whose array fields are stacked ``[2, ...]`` (met0, met1),
  so time interpolation is one lerp instead of pointer swapping;
* struct-of-arrays layout (``atm_t``, h:3341).

Differences that follow from eager PyTorch: ``Atm.np``, ``Cache.rng_ctr``
and ``Cache.served_min`` are Python numbers kept on the host, so the
step never waits for the device to read them.  Every constructor takes
an explicit ``device`` (default ``"cuda"``; the tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for
    and absent (nothing carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


@dataclass
class Atm:
    """Particle state, struct-of-arrays (reference atm_t, mptrac.h:3341).

    time [s since 2000-01-01], p [hPa], lon/lat [deg] (or x/y [m] on
    Cartesian grids), q: dict of per-quantity tensors [npmax].
    ``np`` is the number of live particles (host int); indices >= np
    are padding.
    """
    time: torch.Tensor
    p: torch.Tensor
    lon: torch.Tensor
    lat: torch.Tensor
    q: Dict[str, torch.Tensor]
    np: int

    @property
    def npmax(self) -> int:
        return self.time.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the particle capacity axis."""
        idt = torch.int32 if self.npmax < 2 ** 31 else torch.int64
        return torch.arange(self.npmax, dtype=idt,
                            device=self.time.device) < self.np

    @staticmethod
    def zeros(npmax: int, qnt_names=(), dtype=torch.float64,
              device="cuda") -> "Atm":
        dev = resolve_device(device)

        def z():
            return torch.zeros(npmax, dtype=dtype, device=dev)

        return Atm(time=z(), p=z(), lon=z(), lat=z(),
                   q={n: z() for n in qnt_names}, np=0)

    def replace(self, **kw) -> "Atm":
        return dataclasses.replace(self, **kw)


@dataclass
class Cache:
    """Per-particle scratch persisting across steps (reference cache_t,
    mptrac.h:3396): AR(1) mesoscale wind perturbations ``uvwp``
    [3, npmax] (float32 like the reference), per-particle timestep
    ``dt`` [npmax], and the global Squares RNG counter (reference
    rng_ctr, mptrac.c:35) as a host int kept mod 2^64."""
    uvwp: torch.Tensor         # [3, npmax] float32
    dt: torch.Tensor           # [npmax]
    rng_ctr: int               # host int in [0, 2^64)
    iso_var: torch.Tensor      # [npmax] isosurface variable
    iso_ps: torch.Tensor       # balloon pressure track [nmax]
    iso_ts: torch.Tensor       # balloon time track [nmax]
    iso_n: int
    served_min: Optional[float] = None   # min served fraction since
    #   the last sort; every parcel is served here, so it stays 1.0
    #   (kept so the run loop keeps its shape)
    #: (first parcel, parcels of the global draw) when this cache holds
    #: one shard of a sharded state (parallel.mesh): the random draws are
    #: that shard's slice of the global draw, and the counter advances by
    #: the global draw; None for a whole state
    rng_part: Optional[Tuple[int, int]] = None

    @staticmethod
    def zeros(npmax: int, dtype=torch.float64, iso_nmax: int = 1,
              iso_npmax: int = None, device="cuda") -> "Cache":
        """``iso_npmax`` sizes the per-particle isosurface variable;
        pass 1 when ISOSURF is off."""
        dev = resolve_device(device)
        return Cache(
            uvwp=torch.zeros((3, npmax), dtype=torch.float32, device=dev),
            dt=torch.zeros(npmax, dtype=dtype, device=dev),
            rng_ctr=0,
            iso_var=torch.zeros(npmax if iso_npmax is None else iso_npmax,
                                dtype=dtype, device=dev),
            iso_ps=torch.zeros(iso_nmax, dtype=dtype, device=dev),
            iso_ts=torch.zeros(iso_nmax, dtype=dtype, device=dev),
            iso_n=0,
            served_min=1.0)

    def replace(self, **kw) -> "Cache":
        return dataclasses.replace(self, **kw)


# Cache field categories (the JAX package's types.py:130-160): every
# placement over Cache (parallel.mesh, parallel.dd) derives from them, so
# a new field must join exactly one category or this module fails to
# import.
#: [npmax] per-particle tensors (split over the particle axis)
CACHE_PARTICLE_FIELDS = ("dt", "iso_var")
#: [k, npmax] per-particle tensors with a leading non-particle axis
CACHE_PARTICLE2D_FIELDS = ("uvwp",)
#: one value a subdomain under the domain decomposition (host values)
CACHE_DEVICE_SCALAR_FIELDS = ("rng_ctr", "served_min")
#: small global tables and counts, the same everywhere
CACHE_GLOBAL_FIELDS = ("iso_ps", "iso_ts", "iso_n")
#: the port's own: which slice of the global draw a shard takes
CACHE_SHARD_FIELDS = ("rng_part",)

_CACHE_ALL = (set(CACHE_PARTICLE_FIELDS) | set(CACHE_PARTICLE2D_FIELDS)
              | set(CACHE_DEVICE_SCALAR_FIELDS) | set(CACHE_GLOBAL_FIELDS)
              | set(CACHE_SHARD_FIELDS))
if _CACHE_ALL != {f.name for f in dataclasses.fields(Cache)}:
    raise ImportError(
        "Cache field categories out of sync with the dataclass: "
        f"{_CACHE_ALL ^ {f.name for f in dataclasses.fields(Cache)}}")


def cache_field_tree(particle, particle2d, device_scalar, glob,
                     shard=None) -> Cache:
    """A Cache-shaped tree with one value per field category (above)."""
    kw = {}
    for names, value in ((CACHE_PARTICLE_FIELDS, particle),
                         (CACHE_PARTICLE2D_FIELDS, particle2d),
                         (CACHE_DEVICE_SCALAR_FIELDS, device_scalar),
                         (CACHE_GLOBAL_FIELDS, glob),
                         (CACHE_SHARD_FIELDS, shard)):
        for k in names:
            kw[k] = value
    return Cache(**kw)


#: 3-D fields of a meteo snapshot on pressure levels
#: (reference met_t, mptrac.h:3595-3765)
MET_3D_FIELDS = ("z", "t", "u", "v", "w", "pv", "h2o", "o3",
                 "lwc", "rwc", "iwc", "swc", "cc")
#: 2-D surface fields
MET_2D_FIELDS = ("ps", "ts", "zs", "us", "vs", "ess", "nss", "shf",
                 "lsm", "sst", "pbl", "pt", "tt", "zt", "h2ot",
                 "pct", "pcb", "cl", "plcl", "plfc", "pel", "cape",
                 "cin", "o3c")


@dataclass
class Met:
    """One gridded meteo snapshot (reference met_t, mptrac.h:3595), or
    a stacked pair when every tensor carries a leading ``[2]`` axis.

    3-D fields are [nx, ny, npl] (lon, lat, level) float32; 2-D fields
    [nx, ny].  ``lon`` is a regular axis (locate_reg); ``lat`` and
    ``p`` may be irregular.  ``coord_type`` 0 = lat/lon, 1 = Cartesian.
    ``time`` stays on the host, so the run loop compares it with the
    model time without waiting for the device: a float for a snapshot,
    a pair of floats for a stacked pair.
    """
    time: Union[float, Tuple[float, float]]   # [s], host
    lon: torch.Tensor                  # [nx]
    lat: torch.Tensor                  # [ny]
    p: torch.Tensor                    # [npl] pressure levels [hPa]
    hybrid: torch.Tensor               # [npl] hybrid coordinate
    fields2d: Dict[str, torch.Tensor]  # each [nx, ny]
    fields3d: Dict[str, torch.Tensor]  # each [nx, ny, npl]
    coord_type: int = 0
    npl_ml: int = 0
    #: axis is EXACTLY arithmetic (xx[i] == xx[0] + i*dx, verified
    #: bitwise on the host)
    reg_lon: bool = False
    reg_lat: bool = False
    #: lon axis carries a duplicated wraparound column
    #: (read_met_periodic, reference c:11390)
    lon_periodic: bool = False

    @property
    def nx(self) -> int:
        return self.lon.shape[-1]

    @property
    def ny(self) -> int:
        return self.lat.shape[-1]

    @property
    def npl(self) -> int:
        return self.p.shape[-1]

    def replace(self, **kw) -> "Met":
        return dataclasses.replace(self, **kw)


def _axis_is_arithmetic(xx) -> bool:
    xx = np.asarray(xx)
    if xx.ndim != 1 or xx.size < 2:
        return False
    d = xx[1] - xx[0]
    return bool(np.all(xx == xx[0] + np.arange(xx.size) * d))


def grid_axes(met: Met):
    """(lon, lat, p) axes of a snapshot or of a stacked pair (the first
    snapshot's; grids must match, reference mptrac_get_met c:6288)."""
    if met.lon.ndim == 2:
        return met.lon[0], met.lat[0], met.p[0]
    return met.lon, met.lat, met.p


def stack_met(met0: Met, met1: Met) -> Met:
    """Stack two time-bracketing snapshots along a new leading axis
    (replaces the reference met0/met1 pointer pair, c:6232)."""
    def st(a, b):
        return torch.stack([a, b])

    return Met(
        time=(float(met0.time), float(met1.time)),
        lon=st(met0.lon, met1.lon),
        lat=st(met0.lat, met1.lat), p=st(met0.p, met1.p),
        hybrid=st(met0.hybrid, met1.hybrid),
        fields2d={k: st(v, met1.fields2d[k])
                  for k, v in met0.fields2d.items()},
        fields3d={k: st(v, met1.fields3d[k])
                  for k, v in met0.fields3d.items()},
        coord_type=met0.coord_type, npl_ml=met0.npl_ml,
        reg_lon=met0.reg_lon, reg_lat=met0.reg_lat,
        lon_periodic=met0.lon_periodic)


@dataclass
class ClimZm:
    """One zonal-mean climatology (reference clim_zm_t, mptrac.h:3504)."""
    time: torch.Tensor    # [ntime]
    lat: torch.Tensor     # [nlat]
    p: torch.Tensor       # [np]
    vmr: torch.Tensor     # [ntime, nlat, np]


@dataclass
class ClimTs:
    """One climatological time series (reference clim_ts_t,
    mptrac.h:3484)."""
    time: torch.Tensor    # [ntime]
    vmr: torch.Tensor     # [ntime]


def _no_table() -> torch.Tensor:
    return torch.zeros(1, dtype=torch.float64)


@dataclass
class Clim:
    """Climatological data (reference clim_t, mptrac.h:3536-3586).  The
    tables that the control parameters did not ask for stay empty."""
    # Zonal-mean tropopause (built-in table, reference c:241-396)
    tropo_time: torch.Tensor          # [ntime]
    tropo_lat: torch.Tensor           # [nlat]
    tropo: torch.Tensor               # [ntime, nlat] hPa
    # Photolysis table (clim_photo_t h:3428): rates [np, nsza, no3c]
    photo_p: torch.Tensor = field(default_factory=_no_table)
    photo_sza: torch.Tensor = field(default_factory=_no_table)
    photo_o3c: torch.Tensor = field(default_factory=_no_table)
    photo: Dict[str, torch.Tensor] = field(default_factory=dict)
    # Zonal mean fields (clim_zm_t h:3504): vmr [ntime, nlat, np]
    zm: Dict[str, ClimZm] = field(default_factory=dict)
    # Time series (clim_ts_t h:3484)
    ts: Dict[str, ClimTs] = field(default_factory=dict)

    def replace(self, **kw) -> "Clim":
        return dataclasses.replace(self, **kw)


def _map_tensors(obj, fn):
    """``fn`` applied to every tensor of a (nested) dataclass or dict."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _map_tensors(getattr(obj, f.name), fn)
                            for f in dataclasses.fields(obj)})
    return obj


#: quantities that stay float64 in every compute mode, as the parcel
#: time does: a parcel index is exact in float32 only up to 2^24, and
#: MPTRAC keeps every quantity in double
F64_QUANTITIES = ("idx",)


def quantity_dtype(name: str, dtype):
    """The dtype of quantity ``name`` in compute mode ``dtype``."""
    return torch.float64 if name in F64_QUANTITIES else dtype


def astype_state(atm: Atm = None, cache: Cache = None, met: Met = None,
                 clim: Clim = None, dtype=torch.float32):
    """Cast model state to a compute precision.

    In fp32 mode positions, quantities, per-parcel timesteps and met
    grid axes go to float32 while parcel **time stays float64** (jsec
    magnitudes ~1e9 need it), and so do the quantities of
    ``F64_QUANTITIES`` (``idx``) and the balloon track of ``ISOSURF 4``
    (``iso_ts``, ``iso_ps``), which the JAX package casts.  Returns the
    same tuple shape as the non-None inputs."""
    out = []
    if atm is not None:
        out.append(atm.replace(
            lon=atm.lon.to(dtype), lat=atm.lat.to(dtype),
            p=atm.p.to(dtype),
            q={k: v.to(quantity_dtype(k, dtype)) for k, v in atm.q.items()}))
    if cache is not None:
        out.append(cache.replace(
            dt=cache.dt.to(dtype), iso_var=cache.iso_var.to(dtype)))
    if met is not None:
        out.append(met.replace(
            lon=met.lon.to(dtype), lat=met.lat.to(dtype),
            p=met.p.to(dtype), hybrid=met.hybrid.to(dtype)))
    if clim is not None:
        out.append(_map_tensors(
            clim, lambda a: a.to(dtype) if a.dtype == torch.float64 else a))
    return out[0] if len(out) == 1 else tuple(out)
