"""Interparcel mixing (reference module_mixing / module_mixing_help,
mptrac.c:5161-5335): bin parcels into a mixing grid, average each
quantity per box, and relax every parcel toward its box mean.

Counterpart of the JAX package's ``physics/mixing.py``.  Its
``segment_sum`` scatter-adds become ``index_add_`` into a buffer of
``ngrid * nens + 1`` boxes whose last box collects the parcels outside
the grid or the time window (the overflow bucket), as there.  Float
sums in a box may add in another order than XLA's: in float64 that
moves a box mean by a few ulp."""

from __future__ import annotations

import threading

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import thermo
from mptrac_tpu_torch.physics.diffusion import tropo_weight
from mptrac_tpu_torch.types import Atm, Clim
from mptrac_tpu_torch.utils.timers import span

#: quantities subject to mixing (reference c:5209-5218)
MIX_QUANTITIES = (
    "m", "vmr", "Ch2o", "Co3", "Cco", "Coh", "Ch", "Cho2", "Ch2o2",
    "Co1d", "Co3p", "Cccl4", "Cccl3f", "Cccl2f2", "Cn2o", "Csf6",
    "aoa", "Arn222", "Apb210", "Abe7", "Acs137", "Ai131", "Axe133")


def grid_indices(ctl: Ctl, atm: Atm, t: float, prefix: str = "mixing"):
    """Per-parcel grid box indices (int32) and the mask of the parcels
    inside the grid and the time window (reference c:5193-5203)."""
    z0 = getattr(ctl, f"{prefix}_z0")
    z1 = getattr(ctl, f"{prefix}_z1")
    nz = getattr(ctl, f"{prefix}_nz")
    lon0 = getattr(ctl, f"{prefix}_lon0")
    lon1 = getattr(ctl, f"{prefix}_lon1")
    nx = getattr(ctl, f"{prefix}_nx")
    lat0 = getattr(ctl, f"{prefix}_lat0")
    lat1 = getattr(ctl, f"{prefix}_lat1")
    ny = getattr(ctl, f"{prefix}_ny")

    dz = (z1 - z0) / nz
    dlon = (lon1 - lon0) / nx
    dlat = (lat1 - lat0) / ny
    # C int cast truncates toward zero; negatives are rejected anyway
    ix = torch.trunc((atm.lon - lon0) / dlon).to(torch.int32)
    iy = torch.trunc((atm.lat - lat0) / dlat).to(torch.int32)
    iz = torch.trunc((thermo.altitude(atm.p) - z0) / dz).to(torch.int32)
    t0 = t - 0.5 * ctl.dt_mod
    t1 = t + 0.5 * ctl.dt_mod
    ok = (atm.mask & (atm.time >= t0) & (atm.time <= t1)
          & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
          & (iz >= 0) & (iz < nz))
    return ix, iy, iz, ok


def box_index(ctl: Ctl, atm: Atm, ix, iy, iz, ok, nx: int, ny: int,
              nz: int):
    """(flat box index [np] int64, number of boxes): box
    ``(ix*ny + iy)*nz + iz`` of ensemble member ``ens`` (NENS > 0), and
    the overflow bucket ``ngrid * nens`` for the parcels outside."""
    ngrid = nx * ny * nz
    nens = ctl.nens if ctl.nens > 0 else 1
    idx = (ix.to(torch.int64) * ny + iy) * nz + iz
    if ctl.nens > 0:
        idx = idx + atm.q["ens"].to(torch.int64) * ngrid
    return torch.where(ok, idx, ngrid * nens), ngrid * nens + 1


#: ``reduce`` of the running thread: set by the sharded step
#: (``parallel.mesh.make_sharded_step``) in each shard's thread, so that a
#: box sum becomes the sum over every shard's parcels
SHARD = threading.local()


def box_sum(values, idx, nbox: int):
    """Sum of ``values`` per box (the JAX package's segment_sum); in a
    shard of the sharded step, the sum over all shards."""
    total = torch.zeros(nbox, dtype=values.dtype,
                        device=values.device).index_add_(0, idx, values)
    reduce = getattr(SHARD, "reduce", None)
    return total if reduce is None else reduce(total)


@span("mixing")
def module_mixing(ctl: Ctl, clim: Clim, atm: Atm, t: float) -> Atm:
    ix, iy, iz, ok = grid_indices(ctl, atm, t, "mixing")
    idx, nbox = box_index(ctl, atm, ix, iy, iz, ok, ctl.mixing_nx,
                          ctl.mixing_ny, ctl.mixing_nz)
    del ix, iy, iz
    count = box_sum(ok.to(torch.int64), idx, nbox)
    count = torch.clamp(count, min=1)

    if ctl.mixing_trop < 1 or ctl.mixing_strat < 1:
        w = tropo_weight(ctl, clim, atm.time, atm.lat, atm.p)
        mixparam = w * ctl.mixing_trop + (1.0 - w) * ctl.mixing_strat
    else:
        mixparam = 1.0

    q = dict(atm.q)
    for name in MIX_QUANTITIES:
        if name not in q:
            continue
        x = q[name]
        total = box_sum(torch.where(ok, x, 0.0), idx, nbox)
        cmean = total / count
        delta = (cmean[idx] - x) * mixparam
        q[name] = torch.where(ok, x + delta, x)
    return atm.replace(q=q)
