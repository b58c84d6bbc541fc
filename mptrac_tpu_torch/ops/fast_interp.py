"""Gather tables for one met snapshot pair.

Counterpart of the JAX package's ``ops/fast_interp.py``: ``MetPack``
and ``build_met_pack`` (the tables of the fused step, ``cell=True``,
and of the unfused kernels, ``cell=False``), and the two packed wind
tables ``build_advect_pack64`` and ``build_advect_pack`` that
``ops.lane_interp`` and ``ops.pallas_interp`` read.  The XLA gather
paths over those tables (``interp_uvw_packed*``, ``interp_sfc_packed``)
exist for XLA's gather and have no counterpart here: the kernels take
their place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mptrac_tpu_torch.ops import rk_fused, slab_interp
from mptrac_tpu_torch.ops.slab_interp import SFC_FIELDS  # noqa: F401
from mptrac_tpu_torch.types import Met


class MetPack(NamedTuple):
    """Precomputed gather tables for one met snapshot pair.

    - ``cell``: per-cell fused-RK table and locate parameters
      (ops.rk_fused.CellPack);
    - ``sfcT``: [nx, ny, 2, 16] surface table (ops.slab_interp);
    - ``packT``: [npl, nx, ny, 8] wind table of the unfused kernels
      (ops.slab_interp.interp_uvwt, meso_sigma);
    - ``sigT``: [ncell, 4] subgrid wind sigma of every cell of
      ``packT`` (ops.slab_interp.sigma_table), which meso_sigma gathers
      from.

    The names follow the JAX package's fields, the layouts are this
    package's.  Any entry may be None; modules then take the exact
    interpolation path.
    """
    cell: Optional[rk_fused.CellPack] = None
    sfcT: Optional[torch.Tensor] = None
    packT: Optional[torch.Tensor] = None
    sigT: Optional[torch.Tensor] = None


def build_met_pack(met01: Met, cell: bool = True,
                   sigma: bool = True) -> MetPack:
    """Build the gather tables for a met pair (once per met interval).

    ``cell=True``: the fused-RK pack (reads the grid axes to the host,
    so call it outside the step) and the surface table.  ``cell=False``:
    the wind table of the unfused kernels, the surface table and, with
    ``sigma`` (the mesoscale diffusion is on), the sigma table of the
    wind table."""
    sfcT = slab_interp.build_sfc_table(met01)
    if cell:
        return MetPack(cell=rk_fused.build_cell_pack(met01), sfcT=sfcT)
    packT = rk_fused.build_cell_table(met01)
    sigT = slab_interp.sigma_table(packT) if sigma else None
    return MetPack(packT=packT, sfcT=sfcT, sigT=sigT)


def _edge_padded(f: torch.Tensor) -> torch.Tensor:
    """[2, nx+1, ny+1, npl+1]: each spatial axis extended by one node
    that repeats the last (matches the index clamp of locate_3d)."""
    return torch.nn.functional.pad(f[None], (0, 1, 0, 1, 0, 1),
                                   mode="replicate")[0]


def build_advect_pack64(met01: Met) -> torch.Tensor:
    """Corner-complete packed wind table [nx*ny*npl, 64] float32,
    row = (ix*ny + iy)*npl + iz.

    Lane = corner*6 + comp with corner order (dx,dy,dz) = (0,0,0),
    (0,0,1), (0,1,0), ..., (1,1,1) and comp order (u0,v0,w0,u1,v1,w1);
    lanes 48-63 hold temperature (t0,t1) at the same 8 corners.  64
    times the memory of one field (1.02 GB at 361x181x61)."""
    f3 = met01.fields3d
    u = f3["u"]
    nx, ny, npl = u.shape[-3:]
    n = nx * ny * npl
    uvw = [_edge_padded(f3[k].to(torch.float32)) for k in ("u", "v", "w")]
    te = (_edge_padded(f3["t"].to(torch.float32)) if "t" in f3 else None)
    out = torch.empty((n, 64), dtype=torch.float32, device=u.device)
    corners = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
               for dz in (0, 1)]
    for c, (dx, dy, dz) in enumerate(corners):
        for s in (0, 1):
            for k, f in enumerate(uvw):
                out[:, c * 6 + s * 3 + k] = f[
                    s, dx:dx + nx, dy:dy + ny, dz:dz + npl].reshape(n)
            out[:, 48 + c * 2 + s] = (
                te[s, dx:dx + nx, dy:dy + ny, dz:dz + npl].reshape(n)
                if te is not None else 0.0)
    return out


def build_advect_pack(met01: Met) -> torch.Tensor:
    """Packed wind table [nx*ny*npl, 8] float32, row = (ix*ny + iy)*npl
    + iz holding (u0, v0, w0, u1, v1, w1, 0, 0) at that node."""
    f3 = met01.fields3d
    u = f3["u"]
    n = u[0].numel()
    out = torch.zeros((n, 8), dtype=torch.float32, device=u.device)
    for s in (0, 1):
        for k, name in enumerate(("u", "v", "w")):
            out[:, 3 * s + k] = f3[name][s].reshape(n)
    return out
