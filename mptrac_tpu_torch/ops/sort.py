"""Particle sorting for memory locality (reference module_sort,
mptrac.c:5699-5811): argsort all particle arrays by met grid-box index
so that neighbouring parcels gather from neighbouring met cells.

Counterpart of the JAX package's ``ops/sort.py:27-147``.  The key is
level-major like the fused kernel's table, the argsort is
``torch.sort(stable=True)``, and every state column goes through the
permute kernel (ops.slab_interp.permute_cols) in one call, which is
exact for any permutation, so there is no bandedness guard here.
"""

from __future__ import annotations

import torch

from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.slab_interp import (PERMUTE_MAX_COLS,
                                              permute_cols, permute_plan)
from mptrac_tpu_torch.types import Atm, Cache, Met, grid_axes
from mptrac_tpu_torch.utils.timers import span

_I32_MAX = 2 ** 31 - 1


def sort_key(met: Met, atm: Atm) -> torch.Tensor:
    """Met grid-box index per parcel, Z-MAJOR: (iz*nx + ix)*ny + iy,
    int32, from the SAME locator as the interpolation so the sorted
    order matches the kernel table's order."""
    lons, lats, _ = grid_axes(met)
    loc = interp.locate_3d(met, atm.lon, atm.lat, atm.p)
    nx, ny = lons.shape[0], lats.shape[0]
    key = (loc.iz * nx + loc.ix) * ny + loc.iy
    # keep padding at the end
    return torch.where(atm.mask, key, _I32_MAX)


def module_sort(met: Met, atm: Atm, cache: Cache):
    """Stable argsort by grid cell; permutes atm and the per-particle
    cache arrays consistently and resets the served diagnostic.  Out of
    place: the state exists twice until the old columns are dropped.
    Spans: ``sort.key``, ``sort.argsort``, ``sort.plan`` (the count pass
    and its read-back), ``sort.permute``."""
    with span("sort.key"):
        key = sort_key(met, atm)
    with span("sort.argsort"):
        perm = torch.sort(key, stable=True).indices
    del key

    # (atm.mask is the prefix arange < np; masked parcels sort to the
    # end, so the permuted state keeps a consistent prefix mask)
    n = atm.lon.shape[0]
    iso_per_parcel = cache.iso_var.shape[0] == n
    f32 = torch.float32
    # uvwp first: its three result rows stay one [3, n] tensor
    cols = [cache.uvwp[0], cache.uvwp[1], cache.uvwp[2]]
    slots = [("lon", atm.lon), ("lat", atm.lat), ("p", atm.p),
             ("dt", cache.dt)]
    slots += [(("q", k), v) for k, v in atm.q.items()]
    if iso_per_parcel:
        slots.append(("iso_var", cache.iso_var))
    packed = [(name, v) for name, v in slots if v.dtype == f32]
    if len(cols) + len(packed) > PERMUTE_MAX_COLS:
        raise NotImplementedError(
            f"module_sort: {len(cols) + len(packed)} float32 columns, "
            f"the permute kernel takes {PERMUTE_MAX_COLS} per launch")
    cols += [v.contiguous() for _, v in packed]
    # one count pass plans the float32 columns' path for this sort
    with span("sort.plan"):
        plan = permute_plan(perm) if perm.is_cuda else None
    with span("sort.permute"):
        out, time2 = permute_cols(cols, perm, atm.time.contiguous(),
                                  plan=plan)
        res = {name: o for (name, _), o in zip(packed, out[3:])}
        # float64 columns (f64 compute mode) go through the kernel's
        # float64 slot, one call each, on the gather path: a lone
        # column's row would be one sector a parcel, as its gather is
        for name, v in slots:
            if name not in res:
                res[name] = permute_cols([], perm, v.contiguous(),
                                         plan="gather")[1]
    atm2 = atm.replace(
        time=time2, lon=res["lon"], lat=res["lat"], p=res["p"],
        q={k: res[("q", k)] for k in atm.q})
    cache2 = cache.replace(
        uvwp=out[:3], dt=res["dt"],
        iso_var=res["iso_var"] if iso_per_parcel else cache.iso_var,
        served_min=1.0 if cache.served_min is not None else None)
    return atm2, cache2
