"""Wind, sigma and surface-field interpolation and state-column
permutation kernels.

Counterpart of the four modes of the JAX package's
``ops/slab_interp.py`` kernel:

* ``interp_sfc`` / ``sfc_from_loc`` (mode ``("sfc", fields)``): bilinear
  + time interpolation of selected ones of the 16 hot surface fields,
  with the reference's nearest-neighbour fallback for non-finite
  corners and the single-snapshot fallback (c:3084-3166);
* ``permute_cols`` (mode ``"gather8"``, ``permute_f32_cols``): the
  column permutation of the sort, on the kernel's gather path or row
  path as a count pass over the permutation plans it;
* ``interp_uvwt`` / ``uvwt_from_loc`` (mode ``"uvwt"``): trilinear +
  time interpolation of u, v, w and T, the interpolation of the unfused
  advection and of the meteo sampling;
* ``meso_sigma`` (mode ``"meso"``): the 16-point subgrid wind sigma of
  the unfused mesoscale diffusion, as a table of every cell's sigma
  (``sigma_table``, once per met pair) and a gather from it.

The last two read the per-cell table of ``ops.rk_fused``
(``build_cell_table``, ``[npl, nx, ny, 8]`` float32, level-major) and
take a flat level-major cell ``(iz*nx + ix)*ny + iy``; the upper
corner of an axis repeats the last node where the cell is the last one.

A GPU thread gathers for its own parcel, so none needs sorted input or
a repair pass: every parcel is served and any permutation is exact.
CUDA tensors go to the kernels in ``csrc/sfc_interp.cu``,
``csrc/permute_cols.cu``, ``csrc/uvwt_interp.cu`` and
``csrc/meso_sigma.cu`` (or raise); CPU tensors to the plain versions
below, which repeat the kernels' arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mptrac_tpu_torch.ops import _cuda, rk_fused
from mptrac_tpu_torch.types import Met

#: 2-D fields packed by build_sfc_table, in field order (the JAX
#: package's SFC_FIELDS)
SFC_FIELDS = ("ps", "pbl", "ts", "zs", "cape", "cin", "pel", "plcl",
              "ess", "nss", "shf", "sst", "pt", "tt", "zt", "h2ot")

#: most float32 columns one permute launch takes (csrc kMaxCols)
PERMUTE_MAX_COLS = 32
#: the permute kernel's count pass reads every PERMUTE_COUNT_EVERY-th
#: block of PERMUTE_COUNT_BLOCK outputs (csrc kCountEvery, kBlock)
PERMUTE_COUNT_BLOCK = 256
PERMUTE_COUNT_EVERY = 8


def build_sfc_table(met01: Met) -> torch.Tensor:
    """[nx, ny, 2, 16] float32 surface table: the 16 SFC_FIELDS of both
    snapshots, 128 bytes a grid column."""
    return torch.stack(
        [met01.fields2d[name].to(torch.float32).permute(1, 2, 0)
         for name in SFC_FIELDS], dim=-1).contiguous()


# ----------------------------------------------------------------- K2

def sfc_interp_plain(table, basexy, wx, wy, wt, fields):
    """Plain PyTorch version of the surface kernel: [nfields, n]."""
    nx, ny = table.shape[:2]
    b = basexy.to(torch.int64)
    ix = torch.div(b, ny, rounding_mode="floor")
    iy = b - ix * ny
    ix1 = torch.clamp(ix + 1, max=nx - 1)
    iy1 = torch.clamp(iy + 1, max=ny - 1)
    fidx = torch.as_tensor(list(fields), dtype=torch.int64,
                           device=table.device)

    def corner(i, j, s):
        return table[i, j, s][:, fidx].T               # [nfields, n]

    def snap(s):
        a00, a01 = corner(ix, iy, s), corner(ix, iy1, s)
        a10, a11 = corner(ix1, iy, s), corner(ix1, iy1, s)
        ok = (torch.isfinite(a00) & torch.isfinite(a01)
              & torch.isfinite(a10) & torch.isfinite(a11))
        aux0 = wy * (a00 - a01) + a01
        aux1 = wy * (a10 - a11) + a11
        bilin = wx * (aux0 - aux1) + aux1
        nn = torch.where(wy < 0.5,
                         torch.where(wx < 0.5, a11, a01),
                         torch.where(wx < 0.5, a10, a00))
        return torch.where(ok, bilin, nn)

    v0, v1 = snap(0), snap(1)
    both = torch.isfinite(v0) & torch.isfinite(v1)
    return torch.where(both, wt * (v0 - v1) + v1,
                       torch.where(wt < 0.5, v1, v0))


def _sfc_cuda(table, basexy, wx, wy, wt, fields):
    n = basexy.shape[0]
    nx, ny = table.shape[:2]
    dev, f32 = table.device, torch.float32
    args = [_cuda.ptr("sfc_interp", "table", table, f32, (nx, ny, 2, 16),
                      dev),
            _cuda.ptr("sfc_interp", "basexy", basexy, torch.int32, (n,),
                      dev)]
    args += [_cuda.ptr("sfc_interp", k, t, f32, (n,), dev)
             for k, t in (("wx", wx), ("wy", wy), ("wt", wt))]
    packed = 0
    for k, f in enumerate(fields):
        packed |= f << (4 * k)
    out = torch.empty((len(fields), n), dtype=f32, device=dev)
    _cuda.call("sfc_interp", dev, *args, out.data_ptr(), n, nx, ny,
               len(fields), packed)
    return out


def interp_sfc(table, basexy, weights, fields: Sequence[int]):
    """Selected surface fields at located parcel positions.

    table [nx, ny, 2, 16] f32 (build_sfc_table); basexy [n] int32 =
    ix*ny + iy; weights = (wx, wy, wt) f32 [n]; fields = SFC_FIELDS
    indices.  Returns [nfields, n] f32."""
    fields = tuple(int(f) for f in fields)
    if not fields or len(fields) > 16 or any(
            f < 0 or f >= len(SFC_FIELDS) for f in fields):
        raise ValueError(f"interp_sfc: bad field list {fields}")
    wx, wy, wt = weights
    if table.is_cuda:
        return _sfc_cuda(table, basexy, wx, wy, wt, fields)
    return sfc_interp_plain(table, basexy, wx, wy, wt, fields)


def sfc_from_loc(table, met01: Met, names, ts, loc):
    """{name: [n]} surface-field interpolation through the surface
    kernel: the drop-in for ``interp.interp_time_2d`` per name."""
    from mptrac_tpu_torch.ops import interp
    ny = table.shape[1]
    basexy = (loc.ix * ny + loc.iy).to(torch.int32)
    wt = interp.time_weight(met01, ts)
    w3 = tuple(x.to(torch.float32).contiguous()
               for x in (loc.wx, loc.wy, wt))
    fields = tuple(SFC_FIELDS.index(name) for name in names)
    vals = interp_sfc(table, basexy, w3, fields)
    dtype = loc.wy.dtype
    return {name: vals[k].to(dtype) for k, name in enumerate(names)}


# ----------------------------------------------------------------- K3

def permute_cols_plain(cols32: Sequence[torch.Tensor], perm,
                       col64: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the permute kernel."""
    n = perm.shape[0]
    out = (torch.stack([c[perm] for c in cols32]) if len(cols32)
           else torch.empty((0, n), dtype=torch.float32,
                            device=perm.device))
    return out, (col64[perm] if col64 is not None else None)


def permute_sampled(n):
    """Outputs that the count pass reads of a permutation of ``n``: every
    PERMUTE_COUNT_EVERY-th block of PERMUTE_COUNT_BLOCK, from the first
    (the last one read may be partial)."""
    full, rest = divmod(n, PERMUTE_COUNT_BLOCK * PERMUTE_COUNT_EVERY)
    return full * PERMUTE_COUNT_BLOCK + min(PERMUTE_COUNT_BLOCK, rest)


def permute_sectors_plain(perm):
    """Plain PyTorch version of the permute kernel's count pass: of the
    outputs it reads (permute_sampled), those that start a 32-byte sector
    of a float32 column in the gather path, the first of every 32 (a
    warp's first lane) and those whose source lies in another sector than
    the previous output's."""
    n = perm.shape[0]
    i = torch.arange(n, device=perm.device)
    j = perm.to(torch.int64)
    fresh = (i % 32 == 0) | (j >> 3 != torch.roll(j, 1) >> 3)
    read = i // PERMUTE_COUNT_BLOCK % PERMUTE_COUNT_EVERY == 0
    return int((fresh & read).sum())


def _sectors_cuda(perm):
    dev = perm.device
    p = _cuda.ptr("permute_count", "perm", perm, torch.int64, None, dev)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    _cuda.call("permute_count", dev, p, perm.shape[0], out.data_ptr())
    return int(out)


def permute_sectors(perm):
    """The count pass over ``perm`` (see permute_sectors_plain): one
    kernel launch and one read back of its counter for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not perm.is_cuda:
        return permute_sectors_plain(perm)
    return _sectors_cuda(perm)


def permute_plan(perm):
    """The permute kernel's path for ``perm``, from one count pass:
    ``"rows"`` when more than every second output it reads starts a
    sector of a float32 column (permute_sectors), so that a gather of the
    flagship's ten columns would read more than 5 random sectors a parcel
    against the row path's 2; else ``"gather"``."""
    sampled = permute_sampled(perm.shape[0])
    return "rows" if 2 * permute_sectors(perm) > sampled else "gather"


def permute_row_words(ncols32, has64):
    """32-bit words of a row of the permute kernel's row path: the float64
    column's 2 and one a float32 column, rounded up to 16 bytes."""
    return (ncols32 + (2 if has64 else 0) + 3) // 4 * 4


def _permute_cuda(cols32, perm, col64, plan):
    n = perm.shape[0]
    dev = perm.device
    p = _cuda.ptr("permute_cols", "perm", perm, torch.int64, None, dev)
    if len(cols32) > PERMUTE_MAX_COLS:
        raise ValueError(f"permute_cols: {len(cols32)} float32 columns, "
                         f"at most {PERMUTE_MAX_COLS} per launch")
    m = (cols32[0] if cols32 else col64 if col64 is not None
         else perm).shape[0]                   # the columns' length
    src = [_cuda.ptr("permute_cols", f"column {k}", c, torch.float32, (m,),
                     dev) for k, c in enumerate(cols32)]
    src64 = (_cuda.ptr("permute_cols", "col64", col64, torch.float64, (m,),
                       dev) if col64 is not None else None)
    if m != n and plan != "gather":
        raise ValueError(f"permute_cols: {n} indices into columns of {m}: "
                         "only the gather path takes a selection")
    k = len(cols32)
    out32 = torch.empty((k, n), dtype=torch.float32, device=dev)
    out64 = (torch.empty(n, dtype=torch.float64, device=dev)
             if col64 is not None else None)
    if n == 0 or (k == 0 and col64 is None):
        return out32, out64
    if plan is None:
        plan = permute_plan(perm)
    rw, rows = 0, None
    if plan == "rows":
        rw = permute_row_words(k, col64 is not None)
        # scratch of the row path, freed when the sort's kernels are done
        rows = torch.empty(n * rw, dtype=torch.float32, device=dev)
    arr = ctypes.c_void_p * max(k, 1)
    _cuda.call("permute_cols", dev, arr(*src),
               arr(*[out32[j].data_ptr() for j in range(k)]), k, src64,
               out64.data_ptr() if out64 is not None else None, p, n,
               1 if plan == "rows" else 0, rw,
               rows.data_ptr() if rows is not None else None,
               counters=(("permute_pack", "permute_rows") if plan == "rows"
                         else ("permute_gather",)))
    return out32, out64


def permute_cols(cols32: Sequence[torch.Tensor], perm,
                 col64: Optional[torch.Tensor] = None, *, plan=None):
    """``(stack(cols32)[:, perm], col64[perm])``.

    cols32: float32 [m] columns; col64: an optional float64 [m] column
    (the parcel time); perm: int64 [n].  Exact for any permutation.
    Returns the permuted float32 columns as one [k, n] tensor and the
    permuted float64 column (or None).  ``plan``, ``"rows"`` or
    ``"gather"``, is the kernel's path; on the card, when it is None, a
    count pass and one read back of its counter pick it (permute_plan).
    A caller that permutes several groups of columns by one ``perm``
    plans once and passes the plan to each call.  With the gather path
    ``perm`` may also select (n != m): any int64 indices into the
    columns."""
    if plan not in (None, "rows", "gather"):
        raise ValueError(f"permute_cols: unknown plan {plan!r}")
    if perm.is_cuda:
        return _permute_cuda(list(cols32), perm, col64, plan)
    return permute_cols_plain(cols32, perm, col64)


# ------------------------------------------------------------ K4, K5

def _require_cell_table(name, table):
    if table.dim() != 4 or table.shape[3] != 8:
        raise ValueError(f"{name}: expected a [npl, nx, ny, 8] table, got "
                         f"{tuple(table.shape)}")
    if table.numel() >= 2 ** 31:
        raise ValueError(f"{name}: table too large for 32-bit cell "
                         "arithmetic")


def uvwt_interp_plain(table, cell, wx, wy, wz, wt):
    """Plain PyTorch version of the uvwt kernel: [4, n] (u, v, w, T)."""
    return torch.stack(rk_fused._plain_uvwt(
        rk_fused._cell_corner_rows(table, cell), wx, wy, wz, wt))


def _uvwt_cuda(table, cell, wx, wy, wz, wt):
    n = cell.shape[0]
    npl, nx, ny = table.shape[:3]
    dev, f32 = table.device, torch.float32
    args = [_cuda.ptr("uvwt_interp", "table", table, f32, None, dev),
            _cuda.ptr("uvwt_interp", "cell", cell, torch.int32, (n,), dev)]
    args += [_cuda.ptr("uvwt_interp", k, t, f32, (n,), dev)
             for k, t in (("wx", wx), ("wy", wy), ("wz", wz), ("wt", wt))]
    out = torch.empty((4, n), dtype=f32, device=dev)
    _cuda.call("uvwt_interp", dev, *args, out.data_ptr(), n, nx, ny, npl)
    return out


def interp_uvwt(table, cell, weights):
    """(u, v, w, T) at located parcel positions, in any parcel order.

    table [npl, nx, ny, 8] f32 (rk_fused.build_cell_table); cell [n]
    int32 flat level-major cell (iz*nx + ix)*ny + iy; weights = (wx,
    wy, wz, wt) f32 [n], each the weight of the lower index (wt of
    snapshot 0).  Returns [4, n] f32."""
    _require_cell_table("interp_uvwt", table)
    wx, wy, wz, wt = weights
    if table.is_cuda:
        return _uvwt_cuda(table, cell, wx, wy, wz, wt)
    return uvwt_interp_plain(table, cell, wx, wy, wz, wt)


def cell_from_loc(table, loc):
    """int32 flat level-major cell of a Locator in ``table``."""
    nx, ny = table.shape[1:3]
    return ((loc.iz * nx + loc.ix) * ny + loc.iy).to(torch.int32)


def uvwt_from_loc(table, met01: Met, ts, loc):
    """(u, v, w, T) at located parcel positions through the uvwt
    kernel, in the dtype of the grid axes: the drop-in for four
    ``interp.interp_time_3d`` calls (float32 arithmetic)."""
    from mptrac_tpu_torch.ops import interp
    wt = interp.time_weight(met01, ts)
    w4 = tuple(x.to(torch.float32).contiguous()
               for x in (loc.wx, loc.wy, loc.wz, wt))
    out = interp_uvwt(table, cell_from_loc(table, loc), w4)
    dtype = met01.lon.dtype
    return tuple(out[k].to(dtype) for k in range(4))


#: cells per pass of sigma_table_plain (bounds its temporaries)
SIGMA_PLAIN_CHUNK = 1 << 20


def _sigma_shape(table):
    """[ncell, 4]: K5's sigma table of the per-cell table ``table``."""
    return (table.shape[0] * table.shape[1] * table.shape[2], 4)


def sigma_table_plain(table):
    """Plain PyTorch version of the table kernel: [ncell, 4] f32, the
    (su, sv, sw, 0) of every cell of ``table``, the cells in chunks of
    SIGMA_PLAIN_CHUNK."""
    ncell = _sigma_shape(table)[0]
    out = torch.zeros(_sigma_shape(table), dtype=torch.float32,
                      device=table.device)
    for s in range(0, ncell, SIGMA_PLAIN_CHUNK):
        cells = torch.arange(s, min(s + SIGMA_PLAIN_CHUNK, ncell),
                             device=table.device)
        out[s:s + cells.shape[0], :3] = torch.stack(rk_fused._plain_sigma16(
            rk_fused._cell_corner_rows(table, cells)), dim=1)
    return out


def sigma_table(table):
    """K5's table: the subgrid wind sigma of every cell of the per-cell
    table [npl, nx, ny, 8] (the cell's 8 edge-clamped corners x 2
    snapshots; it reads no weight, so it is a function of the cell and
    the met pair alone), [ncell, 4] f32 rows (su, sv, sw, 0).  Build it
    once per met pair; ``meso_sigma`` gathers from it."""
    _require_cell_table("sigma_table", table)
    if not table.is_cuda:
        return sigma_table_plain(table)
    return _sigma_table_cuda(table)


def _sigma_table_cuda(table):
    npl, nx, ny = table.shape[:3]
    dev = table.device
    t = _cuda.ptr("meso_sigma_table", "table", table, torch.float32, None,
                  dev)
    sigT = torch.empty(_sigma_shape(table), dtype=torch.float32, device=dev)
    _cuda.call("meso_sigma_table", dev, t, sigT.data_ptr(), nx, ny, npl)
    return sigT


def meso_sigma_plain(table, cell):
    """Plain PyTorch version of the whole sigma function (the stencil of
    each parcel's cell): [3, n]."""
    return torch.stack(rk_fused._plain_sigma16(
        rk_fused._cell_corner_rows(table, cell)))


def meso_gather_plain(sigT, cell):
    """Plain PyTorch version of the gather kernel: [3, n]."""
    return sigT[cell.to(torch.int64), :3].T.contiguous()


def _meso_cuda(cell, sigT):
    n = cell.shape[0]
    dev = sigT.device
    s = _cuda.ptr("meso_sigma", "sigT", sigT, torch.float32, None, dev)
    c = _cuda.ptr("meso_sigma", "cell", cell, torch.int32, (n,), dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    _cuda.call("meso_sigma", dev, s, c, out.data_ptr(), n)
    return out


def meso_sigma(table, cell, sigT=None):
    """Subgrid wind sigma (su, sv, sw) of each parcel's cell: standard
    deviation of u, v, w over the cell's 8 corners x 2 snapshots, summed
    in float32 in the reference's order (c:4280-4304).  Arguments as
    ``interp_uvwt``; ``sigT``, the table of ``sigma_table(table)``,
    holds the sigma of every cell: given, the kernel gathers from it;
    else it is built first (on the card; a CPU tensor takes the plain
    stencil).  Returns [3, n] f32."""
    _require_cell_table("meso_sigma", table)
    if sigT is not None and tuple(sigT.shape) != _sigma_shape(table):
        raise ValueError(f"meso_sigma: expected a sigma table of shape "
                         f"{_sigma_shape(table)}, got {tuple(sigT.shape)}")
    if table.is_cuda:
        if sigT is None:
            sigT = sigma_table(table)
        return _meso_cuda(cell, sigT)
    if sigT is None:
        return meso_sigma_plain(table, cell)
    return meso_gather_plain(sigT, cell)
