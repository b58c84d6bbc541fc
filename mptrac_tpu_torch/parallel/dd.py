"""Spatial domain decomposition with parcel migration.

Counterpart of the JAX package's ``parallel/dd.py`` (the reference's MPI
domain decomposition: dd_init c:2193, dd_assign_subdomains c:1918,
dd_sort c:2384, dd_communicate_particles c:2072, the halo reads of
dd_read_met_nc_grid c:11077), with the same arithmetic:

* the met grid is split into ``zonal x meridional`` subdomains; each
  tile carries ``halo`` extra longitude columns on both sides (periodic
  across the date line) and clamped latitude halos, built once per met
  interval (``make_tiles``, stacked ``[ndev, ...]``) or read as a
  hyperslab (``read_met_tile``);
* parcels live in ``[ndev * cap]`` slots, each subdomain's live parcels
  a prefix of its block of ``cap``; every step runs the whole physics
  pipeline per subdomain, then migrates the parcels that left their
  owner: the stayers are compacted stably, the movers bucketed into
  ``exch_cap`` slots per destination and exchanged, the received parcels
  appended after the stayers.  Movers beyond ``exch_cap`` leave the
  state and are counted as overflow (the reference stops at its NP check,
  c:2281); parcels beyond the global latitude range are dropped and
  counted as lost (c:2486-2489).

The exchange sits behind one small interface with two implementations:
the local group (all subdomains in this process on one device, the
counterpart of a single-process JAX mesh; the exchange is a transpose
that the buffer's layout makes free) and the process group (one
subdomain per rank, ``torch.distributed.all_to_all_single``: NCCL for
CUDA tensors, gloo for CPU tensors).  Both hand a subdomain the same
received buffer bit for bit.

The compaction's three selections from every state column (stayers,
movers, received) go through the permute kernel (K3,
``ops.slab_interp.permute_cols``) on the card, on its gather path: the
float32 columns and the float64 time in one launch, further float64
columns one launch each.  Each gathers only the parcels it moves, in
slot order, straight into their new order.  The counts that size them
(the lost, the stayers, the movers to each destination) reach the host
in one copy a subdomain, and its migration is queued only after the
next subdomain's physics: the card computes while the host waits for
the copy, and nothing else in the step waits for the card.

Each sender's counts to every destination are exchanged with the
buffers (on the host in the local group), and a receiver reads that
many parcels from the front of each sender's buffer.

While tracing (``utils.timers``) a step is the span ``dd.step``, over a
``dd.physics`` and a ``dd.migrate`` (owner, movers, send buffers,
stayers) a subdomain, ``dd.exchange``, and a ``dd.receive`` a subdomain
(the received parcels appended, the tail filled).  ``make_tiles`` is
the span ``dd.tiles``.  Every step counts ``dd_selected``, the parcels
its selections gathered.

Unlike the JAX package, the state keeps the caller's dtypes: float64
time and float32 columns in the float32 mode (the JAX step and
``scatter_parcels`` promote every column to float64).  A float32 value
survives that promotion exactly, so the values are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops.slab_interp import PERMUTE_MAX_COLS, permute_cols
from mptrac_tpu_torch.parallel.mesh import Mesh, make_mesh
from mptrac_tpu_torch.types import Atm, Cache, Met, grid_axes
from mptrac_tpu_torch.utils.timers import count, span

_M64 = (1 << 64) - 1
#: per-subdomain offset of the Squares counter: 2^40 draws each before
#: two streams could overlap (the JAX package's dd.py:320-329)
RNG_STRIDE = 1 << 40


@dataclass(frozen=True)
class DDGrid:
    """Static decomposition descriptor (reference dd_t, mptrac.h:3772)."""
    n_zonal: int              # subdomains along longitude
    n_merid: int              # subdomains along latitude
    halo: int                 # halo width in grid points
    nx_glob: int              # global longitudes (incl. wrap column)
    ny_glob: int
    lon0: float               # global lon axis origin + spacing
    dlon: float
    periodic: bool            # global zonal coverage

    @property
    def ndev(self) -> int:
        return self.n_zonal * self.n_merid

    @property
    def nx_loc(self) -> int:
        return self.nx_glob // self.n_zonal + 2 * self.halo

    @property
    def ny_loc(self) -> int:
        return -(-self.ny_glob // self.n_merid) + 2 * self.halo

    def owner_of(self, lon: torch.Tensor, lat: torch.Tensor, lat_axis
                 ) -> torch.Tensor:
        """Subdomain index per parcel (reference dd_assign_subdomains,
        c:1918): the zonal index from the regular lon axis, the
        meridional one from the irregular lat axis.  Longitude is wrapped
        into the axis span first, in the dtype of ``lon``."""
        return _owner(self, lon, lat, _LatAxis(lat_axis, lat.device))


class _LatAxis:
    """A latitude axis prepared for the owner search: ascending, on the
    parcels' device.  The JAX package counts ``lat_axis <= lat``; for a
    monotone axis (ascending, or ERA5's descending order) that count is
    the right-hand search position in the ascending axis, in the
    promoted dtype of both, and 0 for a NaN latitude (no comparison with
    NaN holds)."""

    def __init__(self, lat_axis, device):
        a = (lat_axis.detach().cpu().numpy()
             if isinstance(lat_axis, torch.Tensor) else np.asarray(lat_axis))
        if a.ndim != 1 or a.size < 2:
            raise ValueError("owner_of: lat_axis must be a 1-D axis")
        if a[0] > a[-1]:
            a = a[::-1]
        if np.any(np.diff(a) < 0):
            raise ValueError("owner_of: lat_axis is not monotone")
        self.sorted = torch.from_numpy(a.copy()).to(device)
        self.lo, self.hi = float(a[0]), float(a[-1])


def _owner(dd: DDGrid, lon, lat, axis: _LatAxis) -> torch.Tensor:
    base_x = dd.nx_glob // dd.n_zonal
    lon_w = lon - torch.floor((lon - dd.lon0) / 360.0) * 360.0
    # (as XLA converts: NaN to 0, beyond int32 saturated; clipped anyway)
    ixf = torch.floor((lon_w - dd.lon0) / dd.dlon)
    ix = torch.clamp(torch.nan_to_num(ixf, nan=0.0), 0,
                     dd.nx_glob - 1).to(torch.int64)
    sx = torch.clamp(ix // base_x, 0, dd.n_zonal - 1)
    dt = torch.promote_types(lat.dtype, axis.sorted.dtype)
    cnt = torch.searchsorted(axis.sorted.to(dt), lat.to(dt).contiguous(),
                             right=True)
    cnt = torch.where(torch.isnan(lat), 0, cnt)
    iy = torch.clamp(cnt - 1, 0, dd.ny_glob - 1)
    base_y = -(-dd.ny_glob // dd.n_merid)
    sy = torch.clamp(iy // base_y, 0, dd.n_merid - 1)
    return (sx * dd.n_merid + sy).to(torch.int32)


def plan_decomposition(ctl: Ctl, met: Met, ndev: Optional[int] = None
                       ) -> DDGrid:
    """The DDGrid of the control parameters on ``met``'s grid (a snapshot
    or a stacked pair)."""
    n_zonal = ctl.dd_subdomains_zonal
    n_merid = ctl.dd_subdomains_meridional
    if ndev is not None and n_zonal * n_merid != ndev:
        raise ValueError(
            f"DD subdomains {n_zonal}x{n_merid} != {ndev} devices")
    lon_t, lat_t, _ = grid_axes(met)
    lon = lon_t.detach().cpu().numpy()
    lat = lat_t.detach().cpu().numpy()
    periodic = abs(lon[-1] - lon[0] - 360.0) < 0.01
    return DDGrid(
        n_zonal=n_zonal, n_merid=n_merid, halo=max(ctl.dd_halos_size, 1),
        nx_glob=lon.size, ny_glob=lat.size,
        lon0=float(lon[0]), dlon=float(lon[1] - lon[0]),
        periodic=bool(periodic))


def tile_selection(dd: DDGrid, rank: int, lat_glob):
    """Hyperslab index arrays and replacement axes of one subdomain:
    (xidx, yidx, lon_axis, lat_axis).  x indices wrap periodically
    through the duplicated last column; y halos clamp at the poles with
    the axis extrapolated by the edge spacing, so that it stays strictly
    monotone."""
    sx, sy = rank // dd.n_merid, rank % dd.n_merid
    base_x = dd.nx_glob // dd.n_zonal
    base_y = -(-dd.ny_glob // dd.n_merid)
    h = dd.halo
    startx = sx * base_x - h
    xraw = np.arange(startx, startx + base_x + 2 * h)
    if dd.periodic:
        xidx = np.mod(xraw, dd.nx_glob - 1)
    else:
        xidx = np.clip(xraw, 0, dd.nx_glob - 1)
    lon_axis = dd.lon0 + dd.dlon * xraw

    starty = sy * base_y - h
    yraw = np.arange(starty, starty + base_y + 2 * h)
    yidx = np.clip(yraw, 0, dd.ny_glob - 1)
    lat = (lat_glob.detach().cpu().numpy()
           if isinstance(lat_glob, torch.Tensor)
           else np.asarray(lat_glob)).astype(np.float64)
    edge0 = lat[1] - lat[0]
    edge1 = lat[-1] - lat[-2]
    lat_axis = lat[yidx]
    lat_axis = np.where(yraw < 0, lat[0] + yraw * edge0, lat_axis)
    lat_axis = np.where(yraw > dd.ny_glob - 1,
                        lat[-1] + (yraw - (dd.ny_glob - 1)) * edge1,
                        lat_axis)
    return xidx, yidx, lon_axis, lat_axis


def read_met_tile(filename: str, ctl: Ctl, dd: DDGrid, rank: int,
                  lat_glob, clim=None, device="cuda") -> Met:
    """One subdomain's met tile (with halos) read as a hyperslab of the
    file, the preprocessing run on the tile only (reference
    dd_read_met_nc_grid, c:11045-11253)."""
    from mptrac_tpu_torch.met.build import read_met
    sel = tile_selection(dd, rank, lat_glob)
    return read_met(filename, ctl, clim=clim, device=device, sel=sel)


@span("dd.tiles")
def make_tiles(dd: DDGrid, met: Met) -> Met:
    """A global snapshot (or stacked pair) split into per-subdomain tiles
    with halos: every tensor gains a leading ``[ndev]`` axis, on the
    met's device; the axes keep the met's dtype."""
    lon_t, lat_t, _ = grid_axes(met)
    lat = lat_t.detach().cpu().numpy().astype(np.float64)
    dev = met.lon.device
    sels = [tile_selection(dd, r, lat) for r in range(dd.ndev)]
    xsel = torch.from_numpy(np.stack([s[0] for s in sels])).to(dev)
    ysel = torch.from_numpy(np.stack([s[1] for s in sels])).to(dev)
    stacked = met.lon.ndim == 2            # a met0/met1 pair

    def axis(vals, like):
        a = torch.from_numpy(np.stack(vals)).to(dev, like.dtype)
        if stacked:
            a = a[:, None].expand(dd.ndev, 2, a.shape[-1])
        return a

    def split3(a):
        return torch.stack([a[..., xs, :, :][..., :, ys, :]
                            for xs, ys in zip(xsel, ysel)])

    def split2(a):
        return torch.stack([a[..., xs, :][..., :, ys]
                            for xs, ys in zip(xsel, ysel)])

    def bcast(a):
        return a.expand((dd.ndev,) + tuple(a.shape))

    return Met(
        time=met.time,
        lon=axis([s[2] for s in sels], lon_t),
        lat=axis([s[3] for s in sels], lat_t),
        p=bcast(met.p), hybrid=bcast(met.hybrid),
        fields2d={k: split2(v) for k, v in met.fields2d.items()},
        fields3d={k: split3(v) for k, v in met.fields3d.items()},
        coord_type=met.coord_type, npl_ml=met.npl_ml)


def stack_tiles(tiles: Sequence[Met]) -> Met:
    """Tiles of the subdomains that one process holds, stacked along a
    new leading axis (the layout of ``make_tiles``)."""
    t0 = tiles[0]
    return t0.replace(
        lon=torch.stack([t.lon for t in tiles]),
        lat=torch.stack([t.lat for t in tiles]),
        p=torch.stack([t.p for t in tiles]),
        hybrid=torch.stack([t.hybrid for t in tiles]),
        fields2d={k: torch.stack([t.fields2d[k] for t in tiles])
                  for k in t0.fields2d},
        fields3d={k: torch.stack([t.fields3d[k] for t in tiles])
                  for k in t0.fields3d},
        reg_lon=False, reg_lat=False, lon_periodic=False)


def tile(tiles: Met, i: int) -> Met:
    """Tile ``i`` of stacked tiles (views, no copy)."""
    return tiles.replace(
        lon=tiles.lon[i], lat=tiles.lat[i], p=tiles.p[i],
        hybrid=tiles.hybrid[i],
        fields2d={k: v[i] for k, v in tiles.fields2d.items()},
        fields3d={k: v[i] for k, v in tiles.fields3d.items()})


def scatter_parcels(dd: DDGrid, atm: Atm, cap: int, lat_axis,
                    device=None, cache: Optional[Cache] = None
                    ) -> Tuple[Atm, Cache]:
    """A whole Atm distributed onto ``[ndev * cap]`` subdomain slots by
    owner (the reference's initial dd_sort, c:2384), on ``device`` (the
    Atm's by default).  The columns keep their dtypes; free slots hold 0
    and p = 1000.  The cache's per-subdomain counters and served
    fractions are host lists; with ``cache`` (the whole state's) its
    wind memory goes along with the parcels and every subdomain starts
    at its random counter, else both start at 0."""
    dev = atm.time.device if device is None else torch.device(device)
    n = int(atm.np)
    owner = dd.owner_of(atm.lon[:n], atm.lat[:n], lat_axis).to(torch.int64)
    counts = torch.bincount(owner, minlength=dd.ndev).cpu().numpy()
    if n and counts.max() > cap:
        raise ValueError("DD per-device capacity exceeded!")
    order = torch.sort(owner, stable=True).indices
    starts = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)[:-1]])).to(owner.device)
    sorted_owner = owner[order]
    slots = (sorted_owner * cap + torch.arange(n, device=owner.device)
             - starts[sorted_owner]).to(dev)
    N = dd.ndev * cap

    def place(src, fill=0.0):
        a = torch.full((N,), fill, dtype=src.dtype, device=dev)
        a[slots] = src[:n][order].to(dev)
        return a

    out = Atm(time=place(atm.time), p=place(atm.p, 1000.0),
              lon=place(atm.lon), lat=place(atm.lat),
              q={k: place(v) for k, v in atm.q.items()},
              np=counts.astype(np.int64))
    ctr = 0
    out_cache = Cache.zeros(N, dtype=atm.lon.dtype, device=dev)
    if cache is not None:
        out_cache.uvwp.copy_(torch.stack([place(r) for r in cache.uvwp]))
        ctr = int(cache.rng_ctr)
    out_cache = out_cache.replace(rng_ctr=[ctr] * dd.ndev,
                                  served_min=[1.0] * dd.ndev)
    return out, out_cache


def block(atm: Atm, cache: Cache, cap: int, i: int,
          n: Optional[int] = None) -> Tuple[Atm, Cache]:
    """Views of subdomain ``i``'s slots of a decomposed state: its whole
    block, or its first ``n`` slots (its live parcels where ``n`` is its
    count); ``np`` is its count."""
    sl = slice(i * cap, i * cap + (cap if n is None else n))
    per_parcel = cache.iso_var.shape == cache.dt.shape
    return (Atm(time=atm.time[sl], p=atm.p[sl], lon=atm.lon[sl],
                lat=atm.lat[sl], q={k: v[sl] for k, v in atm.q.items()},
                np=int(atm.np[i])),
            cache.replace(uvwp=cache.uvwp[:, sl], dt=cache.dt[sl],
                          iso_var=(cache.iso_var[sl] if per_parcel
                                   else cache.iso_var)))


def write_block(views: Tuple[Atm, Cache], atm: Atm, cache: Cache) -> None:
    """Copy the state ``atm`` / ``cache`` of a block into its ``views``
    (``block``): every column that migrates, ``dt`` and a per-parcel
    ``iso_var``."""
    v_atm, v_cache = views
    qnames = tuple(v_atm.q)
    for (_, dst), (_, src) in zip(_columns(v_atm, v_cache, qnames),
                                  _columns(atm, cache, qnames)):
        dst.copy_(src)
    v_cache.dt.copy_(cache.dt)
    if v_cache.iso_var.shape == v_cache.dt.shape:
        v_cache.iso_var.copy_(cache.iso_var)


def subdomain_block(atm: Atm, cache: Cache, cap: int, ids: Sequence[int]
                    ) -> Tuple[Atm, Cache]:
    """The slots of the subdomains ``ids`` (a process's share of a
    scattered state), as a state of their own."""
    idx = torch.cat([torch.arange(i * cap, (i + 1) * cap) for i in ids])
    idx = idx.to(atm.time.device)

    def take(x):
        return x[..., idx].contiguous()

    per_parcel = cache.iso_var.shape == cache.dt.shape
    return (Atm(time=take(atm.time), p=take(atm.p), lon=take(atm.lon),
                lat=take(atm.lat), q={k: take(v) for k, v in atm.q.items()},
                np=np.asarray([atm.np[i] for i in ids], np.int64)),
            cache.replace(uvwp=take(cache.uvwp), dt=take(cache.dt),
                          iso_var=(take(cache.iso_var) if per_parcel
                                   else cache.iso_var),
                          rng_ctr=[cache.rng_ctr[i] for i in ids],
                          served_min=[cache.served_min[i] for i in ids]))


def gather_parcels(dd: DDGrid, atm: Atm, cap: int) -> Atm:
    """The live parcels of every subdomain held here as one dense Atm."""
    counts = torch.as_tensor(np.asarray(atm.np), device=atm.time.device)
    slot = torch.arange(atm.npmax, device=atm.time.device)
    keep = torch.nonzero(slot % cap < counts[slot // cap]).flatten()
    return Atm(time=atm.time[keep], p=atm.p[keep], lon=atm.lon[keep],
               lat=atm.lat[keep], q={k: v[keep] for k, v in atm.q.items()},
               np=int(keep.shape[0]))


# ------------------------------------------------------------- exchange

class _LocalExchange:
    """Every subdomain in this process on one device.  A buffer of
    ``k`` columns is ``[k, dst, src, exch_cap]``: a sender writes its
    ``[dst, k, exch_cap]`` view, and a receiver's columns are
    ``buf[:, dst]``, whose rows are contiguous: the transpose of the
    stacked ``[src, dst, ...]`` send buffers, for free."""

    def __init__(self, ndev: int, device: torch.device):
        self.ndev = ndev
        self.device = device
        self.subdomains = range(ndev)

    def buffer(self, k, exch_cap, dtype):
        return torch.empty((k, self.ndev, self.ndev, exch_cap), dtype=dtype,
                           device=self.device)

    def send_view(self, buf, i):
        return buf[:, :, i, :].permute(1, 0, 2)

    def exchange(self, buf):
        return buf

    def recv_cols(self, recv, i):
        k, _, _, e = recv.shape
        return recv[:, i].reshape(k, self.ndev * e)

    def counts(self, sent):
        """``sent``: every sender's counts to each destination (host);
        returns, a subdomain, what each sender put in its buffer to it."""
        return [[int(c[i]) for c in sent] for i in self.subdomains]


class _ProcessExchange:
    """One subdomain per rank of the default process group: a buffer is
    ``[dst, k, exch_cap]``, moved by ``all_to_all_single``."""

    def __init__(self, ndev: int, rank: int, device: torch.device):
        import torch.distributed as dist
        if dist.get_world_size() != ndev:
            raise ValueError(f"DD of {ndev} subdomains on a process group "
                             f"of {dist.get_world_size()} ranks")
        self.ndev = ndev
        self.device = device
        self.subdomains = [rank]

    def buffer(self, k, exch_cap, dtype):
        return torch.empty((self.ndev, k, exch_cap), dtype=dtype,
                           device=self.device)

    def send_view(self, buf, i):
        return buf

    def exchange(self, buf):
        import torch.distributed as dist
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf)
        return recv

    def recv_cols(self, recv, i):
        n, k, e = recv.shape
        return recv.transpose(0, 1).reshape(k, n * e)

    def counts(self, sent):
        """``sent``: this rank's counts to each destination (host);
        returns what each rank put in its buffer to this one."""
        mine = torch.as_tensor(np.asarray(sent[0], np.int64),
                               device=self.device)
        return [self.exchange(mine).tolist()]


def local_group(ndev: int, device="cuda") -> Mesh:
    """The mesh of the local group: ``ndev`` subdomains in this process,
    all on ``device``."""
    return make_mesh(ndev, axis="sub", devices=[device] * ndev)


def _exchange_for(group: Mesh, ndev: int):
    if group.size != ndev:
        raise ValueError(f"DD of {ndev} subdomains on a mesh of "
                         f"{group.size}")
    dev = group.devices[0]
    if any(d != dev for d in group.devices):
        raise NotImplementedError(
            "DD local group: subdomains on several devices of one process")
    if group.process_count == 1:
        return _LocalExchange(ndev, dev)
    if len(group.devices) != 1:
        raise NotImplementedError(
            "DD process group: one subdomain per process")
    return _ProcessExchange(ndev, group.process_index, dev)


# ------------------------------------------------------------- the step

def _columns(atm: Atm, cache: Cache, qnames):
    """The state columns that migrate, in the JAX package's order (time,
    p, lon, lat, q..., the three uvwp rows), as (name, tensor) pairs."""
    return ([("time", atm.time), ("p", atm.p), ("lon", atm.lon),
             ("lat", atm.lat)] + [(("q", k), atm.q[k]) for k in qnames]
            + [(("uvwp", j), cache.uvwp[j]) for j in range(3)])


def _on_host(t: torch.Tensor):
    """Start copying the small tensor ``t`` to the host; returns a
    function that gives it as a list, waiting only for that copy (on
    the card the copy and an event are queued behind the work before
    it, so that the host can queue more work first)."""
    if not t.is_cuda:
        return t.tolist
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def get():
        done.synchronize()
        return host.tolist()
    return get


def _compact(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The indices of the ``n`` true entries of the 1-D ``mask``,
    ascending (int64), without waiting for the device (``torch.nonzero``
    reads its count back): ``n`` is known on the host, and each entry's
    rank among the true ones, or among the false ones after them, places
    its index in a stable partition whose first ``n`` entries are the
    true ones."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    rank = torch.cumsum(mask, 0).sub_(1)   # a true entry's among the true
    # a false entry's: n + the false ones before it (idx - rank - 1)
    after = idx.sub(rank).add_(n - 1)
    place = torch.where(mask, rank, after)
    del rank, after
    out = torch.empty_like(idx)
    out[place] = idx
    return out[:n]


def _select(cols32: List[torch.Tensor], cols64: List[torch.Tensor],
            idx: torch.Tensor):
    """The entries ``idx`` (ascending within runs) of every column: K3's
    gather path on the card (the float32 columns and the first float64
    column in one launch, further float64 columns one launch each), its
    plain version on the CPU.  A monotone run reads every source sector
    at most once a column, so the gather path is the kernel's cheaper
    one here whatever the count pass would say.  Returns ([k32, n]
    float32, [float64 columns])."""
    cols32 = [c.contiguous() for c in cols32]
    cols64 = [c.contiguous() for c in cols64]
    out32, first = permute_cols(cols32, idx, cols64[0] if cols64 else None,
                                plan="gather")
    out64 = ([first] if cols64 else []) + [
        permute_cols([], idx, c, plan="gather")[1] for c in cols64[1:]]
    return out32, out64


def make_dd_step(ctl: Ctl, clim, dd: DDGrid, group: Mesh, cap: int,
                 exch_cap: int, lat_axis, exchange: bool = True):
    """The domain-decomposed step: the physics of every subdomain held
    here, then the parcel migration.

    ``group`` is the local group (``local_group(ndev, device)``: every
    subdomain in this process) or a process group's mesh
    (``multihost.global_mesh``: one subdomain per rank).  The state is
    ``[nloc * cap]`` slots of the ``nloc`` subdomains held here, with
    ``atm.np`` their live counts and ``cache.rng_ctr`` / ``served_min``
    their host values (``scatter_parcels``).

    Returns ``step(tiles, atm, cache, t, flags=None)`` -> ``(atm, cache,
    overflow, lost)``: ``tiles`` the held subdomains' met tiles stacked
    (``make_tiles``, ``stack_tiles``), ``t`` the model time, ``flags``
    the run loop's ``pipeline.StepFlags`` (default: every module due),
    overflow and lost numpy counts per held subdomain.  With
    ``exchange=False`` the parcels stay where the physics left them and
    the third output counts those that would migrate.  A subdomain's
    movers are sent once the next subdomain's physics is queued, so that
    beside the state (old and new) only the send buffers and two
    subdomains' temporaries are held."""
    from mptrac_tpu_torch.physics import pipeline

    ex = _exchange_for(group, dd.ndev)
    ndev = dd.ndev
    qnames = tuple(ctl.qnt_name)
    lax = _LatAxis(lat_axis, ex.device)

    def step(tiles: Met, atm: Atm, cache: Cache, t: float, flags=None):
        with span("dd.step"):
            return _step(tiles, atm, cache, float(t),
                         pipeline.StepFlags() if flags is None else flags)

    def _step(tiles: Met, atm: Atm, cache: Cache, t: float, flags):
        nloc = len(ex.subdomains)
        if atm.npmax != nloc * cap:
            raise ValueError(f"DD step: {atm.npmax} slots, expected "
                             f"{nloc} x {cap}")
        per_parcel = cache.iso_var.shape == cache.dt.shape
        # the new state, written subdomain by subdomain
        uvwp = torch.empty_like(cache.uvwp)
        out = {}
        for name, v in _columns(atm, cache, qnames):
            out[name] = (uvwp[name[1]] if name[0] == "uvwp"
                         else torch.empty_like(v))
        names32 = [n for n, v in out.items() if v.dtype == torch.float32]
        names64 = [n for n, v in out.items() if v.dtype == torch.float64]
        if len(names32) + len(names64) != len(out):
            raise TypeError("DD step: state columns must be float32 or "
                            "float64")
        if len(names32) > PERMUTE_MAX_COLS:
            raise NotImplementedError(
                f"DD step: {len(names32)} float32 columns, the permute "
                f"kernel takes {PERMUTE_MAX_COLS} per launch")
        dt = torch.empty_like(cache.dt)
        iso_var = torch.empty_like(cache.iso_var) if per_parcel else None
        ctrs, served, counts, third, lost, kept = [], [], [], [], [], []
        sent = []           # movers in the send buffers, a destination
        selected = 0
        bufs = ((ex.buffer(len(names32), exch_cap, torch.float32),
                 ex.buffer(len(names64), exch_cap, torch.float64))
                if exchange else None)

        def owners(i, my, a_i, c_i):
            """The migration's first part (reference module_dd,
            c:4168): each parcel's owner, who stays, who moves, and the
            counts that the second part needs on the host (the lost,
            the stayers, the movers to each destination: a sum a
            destination, where atomic adds of every slot into a few
            counters would queue on them), on their way there."""
            with span("dd.migrate"):
                return _owners(i, my, a_i, c_i)

        def _owners(i, my, a_i, c_i):
            live = a_i.np       # the stayers and movers lie here
            dest = _owner(dd, a_i.lon, a_i.lat, lax)
            valid = a_i.mask
            lat64 = a_i.lat.to(torch.float64)
            gone = valid & ((lat64 < lax.lo) | (lat64 > lax.hi))
            del lat64
            valid = valid & ~gone
            stay = valid[:live] & (dest[:live] == my)
            move = valid[:live] & (dest[:live] != my)
            del valid
            key = torch.where(move, dest[:live], -1)
            cnt = torch.stack([(key == d).sum() for d in range(ndev)])
            del key
            return SimpleNamespace(
                i=i, my=my, live=live, dest=dest[:live], stay=stay,
                move=move, cnt=cnt, cols=dict(_columns(a_i, c_i, qnames)),
                counts=_on_host(torch.cat([gone.sum()[None],
                                           stay.sum()[None], cnt])))

        def migrate(st):
            """The migration's second part, once the counts are on the
            host: the movers by destination in slot order, each
            destination's first exch_cap into the send buffers and the
            rest overflow, then the stayers compacted to the front of
            the subdomain's block."""
            with span("dd.migrate"):
                return _migrate(st)

        def _migrate(st):
            """Returns the parcels its selections gathered."""
            host = st.counts()
            lost.append(host[0])
            n_stay, cnt_h = host[1], np.asarray(host[2:])
            n_move = int(cnt_h.sum())
            sl = slice(st.i * cap, (st.i + 1) * cap)
            if not exchange:
                for name, v in st.cols.items():
                    out[name][sl] = v
                counts.append(st.live)
                third.append(n_move)
                return 0
            c32 = [st.cols[n] for n in names32]
            c64 = [st.cols[n] for n in names64]
            sent.append(np.minimum(cnt_h, exch_cap))
            n_sent = int(sent[-1].sum())
            third.append(n_move - n_sent)
            mv = _compact(st.move, n_move)
            d_mv = st.dest[mv].to(torch.int64)
            by_dest = torch.sort(d_mv, stable=True).indices
            d_mv = d_mv[by_dest]
            rank = (torch.arange(n_move, device=ex.device)
                    - (torch.cumsum(st.cnt, 0) - st.cnt)[d_mv])
            ok = _compact(rank < exch_cap, n_sent)
            d_ok, slot = d_mv[ok], rank[ok]
            mv32, mv64 = _select(c32, c64, mv[by_dest[ok]])
            for buf, g in ((bufs[0], mv32), (bufs[1], mv64)):
                if len(g):
                    g = g if torch.is_tensor(g) else torch.stack(g)
                    ex.send_view(buf, st.i)[d_ok, :, slot] = g.T
            del mv, d_mv, by_dest, rank, ok, d_ok, slot, mv32, mv64
            kp32, kp64 = _select(c32, c64, _compact(st.stay, n_stay))
            for names, kp in ((names32, kp32), (names64, kp64)):
                for j, name in enumerate(names):
                    out[name][sl][:n_stay] = kp[j]
            kept.append(n_stay)
            return n_sent + n_stay

        # each subdomain's migration is issued once the next one's
        # physics is queued: the card computes while the host waits for
        # the counts
        pending = None
        for i, my in enumerate(ex.subdomains):
            sl = slice(i * cap, (i + 1) * cap)
            a_i, c_i = block(atm, cache, cap, i)
            # a stream of its own for every subdomain, 2^40 draws apart
            c_i = c_i.replace(
                rng_ctr=(cache.rng_ctr[i] + my * RNG_STRIDE) & _M64,
                served_min=cache.served_min[i], rng_part=None)
            with span("dd.physics"):
                a_i, c_i = pipeline.run_timestep(ctl, clim, tile(tiles, i),
                                                 a_i, c_i, t, flags)
            ctrs.append((c_i.rng_ctr - my * RNG_STRIDE) & _M64)
            served.append(c_i.served_min)
            dt[sl] = c_i.dt
            if per_parcel:
                iso_var[sl] = c_i.iso_var
            tables = dict(iso_ps=c_i.iso_ps, iso_ts=c_i.iso_ts,
                          iso_n=c_i.iso_n)
            if not per_parcel:
                tables["iso_var"] = c_i.iso_var
            new = owners(i, my, a_i, c_i)
            del a_i, c_i
            if pending is not None:
                selected += migrate(pending)
            pending = new
        selected += migrate(pending)
        del pending, new

        if exchange:
            with span("dd.exchange"):
                recv = [ex.exchange(b) for b in bufs]
                got = ex.counts(sent)
            del bufs
            for i, n_keep in enumerate(kept):
                with span("dd.receive"):
                    n_new = receive(recv, out, names32, names64, i, n_keep,
                                    got[i])
                selected += n_new - n_keep
                counts.append(n_new)
            del recv
        atm2 = Atm(time=out["time"], p=out["p"], lon=out["lon"],
                   lat=out["lat"], q={k: out[("q", k)] for k in qnames},
                   np=np.asarray(counts, np.int64))
        # dt and iso_var stay where the physics left them (the JAX step
        # does not permute them either: the next step sets dt anew)
        if per_parcel:
            tables["iso_var"] = iso_var
        cache2 = cache.replace(uvwp=uvwp, dt=dt, rng_ctr=ctrs,
                               served_min=served, **tables)
        count("dd_selected", selected)
        return atm2, cache2, np.asarray(third), np.asarray(lost)

    def receive(recv, out, names32, names64, i, n_keep, got):
        """Subdomain ``i``'s received parcels appended after its
        ``n_keep`` stayers and the rest of its block filled; returns its
        new count.  ``got``: how many each sender put in its buffer to
        this subdomain (they fill its first slots)."""
        sl = slice(i * cap, (i + 1) * cap)
        got = torch.cat([torch.arange(s * exch_cap, s * exch_cap + k,
                                      device=ex.device)
                         for s, k in enumerate(got)])
        n_new = n_keep + got.shape[0]
        if n_new > cap:
            raise ValueError(
                f"DD subdomain {ex.subdomains[i]}: {n_new} parcels "
                f"after the exchange exceed its capacity {cap}")
        r32, r64 = _select(list(ex.recv_cols(recv[0], i)),
                           list(ex.recv_cols(recv[1], i)), got)
        for names, rc in ((names32, r32), (names64, r64)):
            for j, name in enumerate(names):
                col = out[name][sl]
                col[n_keep:n_new] = rc[j]
                col[n_new:] = 1000.0 if name == "p" else 0.0
        return n_new

    return step
