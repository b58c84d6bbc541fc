"""High-level simulation run loop.

Counterpart of the JAX package's ``sim.py`` (the reference ``trac`` main
loop, trac.c:95-185, and mptrac_get_met c:6187, mptrac_init c:6312,
mptrac_run_timestep c:7545, mptrac_write_output c:7919): ``MetBuffer``
keeps the two met snapshots that bracket the model time, ``Simulation``
runs the time loop (met buffering, optional sort, the timestep, output),
``run_trac`` runs one working directory.

The time loop runs on the host and dispatches every step eagerly; it
reads nothing back from the device (``Met.time``, ``Atm.np`` and
``Cache.served_min`` are host values).  What the JAX package's loop does with
``lax.scan`` (batching homogeneous steps into one dispatch) has no
counterpart: ``run(scan=...)`` accepts the argument and steps one by
one.  ``checkpoint_file``/``checkpoint_dt`` write full-state checkpoints
(``checkpoint.py``, the JAX package's file format) and ``resume`` reads
one; a resumed run skips the first-step initialisation
(``pipeline.init_modules``), which the run that wrote the checkpoint
already did, so that it continues bit for bit.

With ``mesh=`` (``parallel.mesh.Mesh``) one run spans the mesh's devices
as MPTRAC's GPU runs span a node, one rank a GPU (mptrac.c:6116): the
parcels are sharded over the devices, every device holds a replica of
the met pair and its own gather tables, and each shard runs the
first-step initialisation, the sort and the step on its own device
(``parallel.mesh.ShardedStep``), as the unsharded run does on its
parcels; output and checkpoints gather the state.

With ``DD 1`` (and no mesh) one run is MPTRAC's spatial domain
decomposition (``module_dd``, mptrac.c:4168) with every subdomain in
this process on the state's device (``parallel.dd``'s local group):
the met pair is cut into ``DD_SUBDOMAINS_ZONAL x
DD_SUBDOMAINS_MERIDIONAL`` tiles with ``DD_HALOS_SIZE`` halos (again
after every met swap), the parcels are scattered into a block of slots
a subdomain, each step runs the physics of every subdomain on its tile
and migrates the parcels that left it (``parallel.dd.make_dd_step``),
and a sort sorts each subdomain's parcels in its own block, as each
MPTRAC rank sorts its own; output gathers the live parcels.  The
choice is made once, at construction; what the decomposed step cannot
run (a mesh, the kernels of ``TPU_FAST``, a chemistry grid, mixing,
the isosurface, checkpoints) raises.

The compute mode is explicit: ``dtype=torch.float64`` (the default and
the reference-parity mode) or ``torch.float32``, the mode in which
``TPU_FAST 1`` and ``2`` run the CUDA kernels.  In float32 mode the
particle state and every met pair's axes are cast once (the particle
time and index stay float64), which is the JAX package's
``astype_state``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import Ctl, read_ctl
from mptrac_tpu_torch.io import atm_io
from mptrac_tpu_torch.met.build import check_met_type, read_met
from mptrac_tpu_torch.met.read_nc import get_met_filename
from mptrac_tpu_torch.ops.fast_interp import MetPack, build_met_pack
from mptrac_tpu_torch.ops.sort import module_sort
from mptrac_tpu_torch.parallel import dd as ddm
from mptrac_tpu_torch.parallel.mesh import (Mesh, Sharded, atm_block,
                                            cache_block, join_atm,
                                            join_cache, make_sharded_step,
                                            pad_to_multiple, replicate_met,
                                            shard_atm, shard_cache, unshard)
from mptrac_tpu_torch.physics import pipeline
from mptrac_tpu_torch.physics.timesteps import init_time_range
from mptrac_tpu_torch.types import (Atm, Cache, Clim, Met, astype_state,
                                    grid_axes, resolve_device, stack_met)
from mptrac_tpu_torch.utils.timers import Timers, span


def build_pack(ctl: Ctl, met01: Met) -> Optional[MetPack]:
    """The gather tables that the control parameters ask for, as the
    JAX package's step uses them (rebuild once per met interval):
    ``TPU_FAST 0`` none, the exact interpolation; ``TPU_FAST >= 2`` with
    ``SORT_DT > 0`` on pressure levels the fused RK kernel's; otherwise
    the unfused kernels', with the sigma table only where the mesoscale
    diffusion runs.  The JAX step takes the fused kernel only on
    pressure levels (``ADVECT_VERT_COORD 0``); with another vertical
    coordinate the advection is exact, and the unfused tables serve the
    diffusion (the surface and sigma kernels), whatever ``TPU_FAST``."""
    if not ctl.tpu_fast:
        return None
    meso = bool(ctl.diffusion) and (ctl.turb_mesox > 0
                                    or ctl.turb_mesoz > 0)
    return build_met_pack(met01,
                          cell=(ctl.tpu_fast >= 2 and ctl.sort_dt > 0
                                and ctl.advect_vert_coord == 0),
                          sigma=meso)


class FixedMet:
    """A met source that yields one pair held in memory for every
    model time (the synthetic flagship)."""

    def __init__(self, met01: Met):
        self.pair = met01

    def swap_due(self, t: float) -> bool:
        return False

    def get(self, t: float) -> Met:
        return self.pair


class MetBuffer:
    """Double-buffered met reader (reference mptrac_get_met, c:6187).

    Keeps the stacked pair of the two snapshots that bracket the model
    time on the device and re-reads one file per met interval crossing.
    On a crossing the pair is updated in place: the snapshot that stays
    moves to the other slot and the new one is copied in, so the device
    holds one pair and, while a file is read, one snapshot more.
    ``dtype`` is the compute mode that the pair's axes are cast to.

    For MET_TYPE 1 and 2 without ``MET_PCK_ZSTD`` the native loader
    (``native_loader.AsyncMetLoader``) decodes the next interval's file
    on a C++ thread while the device integrates, as the JAX package's
    buffer does: after every read the following file is queued, and a
    file that was queued is taken from the loader.  A loader that cannot
    be built raises; nothing falls back to the Python reader.

    ``reads`` lists, for every file read, its name, its ``route``
    (``"python"``: ``met/build.read_met``; ``"native"``: the loader), the
    seconds of each stage (``read_met``'s, or the loader's ``wait``,
    ``copy``, ``upload`` and ``decode_device``) and ``wait``, the
    seconds the step waited for the decode-ahead (0 on the Python
    route).
    """

    def __init__(self, ctl: Ctl, clim: Clim, device="cuda",
                 dtype=torch.float64):
        check_met_type(ctl)
        self.ctl = ctl
        self.clim = clim
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pair: Optional[Met] = None
        self.reads: List[Dict[str, object]] = []
        self._loader = None
        self._prefetched: Optional[str] = None
        if ctl.met_type in (1, 2) and not ctl.met_pck_zstd:
            from mptrac_tpu_torch.native_loader import AsyncMetLoader
            self._loader = AsyncMetLoader()

    def close(self):
        """Stop the decode-ahead thread."""
        if self._loader is not None:
            self._loader.close()

    @span("met.read")
    def _read(self, filename: str) -> Met:
        timings: Dict[str, float] = {"wait": 0.0}
        if self._loader is not None and self._prefetched == filename:
            from mptrac_tpu_torch.met.bin_io import finish_raw, read_stages
            from mptrac_tpu_torch.met.build import _to_met
            raw = self._loader.wait(timings)
            self._prefetched = None
            raw = finish_raw(dict(raw, coord_type=self.ctl.met_coord_type),
                             self.device, read_stages(timings,
                                                      self.device))
            met = _to_met(self.ctl, raw, raw["lon"], raw["lat"], raw["p"],
                          raw["fields2d"], raw["fields3d"], self.device)
            route = "native"
        else:
            met = read_met(filename, self.ctl, self.clim,
                           device=self.device, timings=timings)
            route = "python"
        if self._loader is not None:
            # queue the following interval's file for the decode-ahead
            nxt = get_met_filename(
                self.ctl, float(met.time)
                + self.ctl.direction * self.ctl.dt_met, self.ctl.direction)
            if os.path.exists(nxt) and nxt != self._prefetched:
                self._loader.prefetch(nxt, self.ctl.met_type)
                self._prefetched = nxt
        self.reads.append(dict(file=os.path.basename(filename), route=route,
                               **timings))
        return astype_state(met=met, dtype=self.dtype)

    def swap_due(self, t: float) -> bool:
        """Whether ``get(t)`` will read a file (so that the caller can
        release what it derived from the old pair first)."""
        return (self.pair is None or t > self.pair.time[1]
                or t < self.pair.time[0])

    def get(self, t: float) -> Met:
        ctl = self.ctl
        if self.pair is None:
            # Initial read of both bracketing snapshots (c:6205-6218)
            f0 = get_met_filename(
                ctl, t + (-1 if ctl.direction == -1 else 0), -1)
            f1 = get_met_filename(
                ctl, t + (1 if ctl.direction == 1 else 0), 1)
            met0 = self._read(f0)
            met1 = met0 if f1 == f0 else self._read(f1)
            self._check_grids(met0, met1)
            self.pair = stack_met(met0, met1)
        # Forward: advance when t passes met1 (c:6236-6248)
        if t > self.pair.time[1]:
            self._shift(self._read(get_met_filename(ctl, t, 1)), keep=1)
        # Backward: advance when t passes met0 (c:6264-6276)
        if t < self.pair.time[0]:
            self._shift(self._read(get_met_filename(ctl, t, -1)), keep=0)
        return self.pair

    @span("met.shift")
    def _shift(self, new: Met, keep: int):
        """Move snapshot ``keep`` of the pair to the other slot and put
        ``new`` into its place.  The result is a new ``Met`` object over
        the same tensors, so a consumer sees that the pair changed."""
        old = self.pair
        self._check_grids(_snapshot(old, keep), new)
        for name in ("lon", "lat", "p", "hybrid"):
            stacked = getattr(old, name)
            stacked[1 - keep].copy_(stacked[keep])
            stacked[keep].copy_(getattr(new, name))
        for fields, new_fields in ((old.fields2d, new.fields2d),
                                   (old.fields3d, new.fields3d)):
            for k, stacked in fields.items():
                stacked[1 - keep].copy_(stacked[keep])
                stacked[keep].copy_(new_fields[k])
        times = [old.time[keep], float(new.time)]
        self.pair = old.replace(
            time=tuple(times if keep == 1 else reversed(times)))

    @staticmethod
    def _check_grids(m0: Met, m1: Met):
        if (m0.nx, m0.ny, m0.npl) != (m1.nx, m1.ny, m1.npl):
            raise ValueError("Meteo grid dimensions do not match!")
        if not bool(torch.allclose(m0.lon, m1.lon, rtol=0.0, atol=0.001)):
            raise ValueError("Meteo grid longitudes do not match!")


def _snapshot(pair: Met, k: int) -> Met:
    """Snapshot ``k`` of a stacked pair (views, no copy)."""
    return pair.replace(
        time=pair.time[k], lon=pair.lon[k], lat=pair.lat[k], p=pair.p[k],
        hybrid=pair.hybrid[k],
        fields2d={n: v[k] for n, v in pair.fields2d.items()},
        fields3d={n: v[k] for n, v in pair.fields3d.items()})


def _sharded_state(atm: Atm, cache: Optional[Cache], mesh: Mesh, dtype,
                   iso_npmax: Optional[int]):
    """The particle state sharded over ``mesh`` in compute mode
    ``dtype``: a whole Atm cast, padded to a multiple of the mesh size and
    split (``shard_atm``), a sharded one (``parallel.mesh.join_atm``) as
    it is; the cache split likewise, or zeros made on each device."""
    if not isinstance(atm.time, Sharded):
        if atm.lon.dtype != dtype:
            atm = astype_state(atm=atm, dtype=dtype)
        atm = shard_atm(pad_to_multiple(atm, mesh.size), mesh)
    elif atm.lon.blocks[0].dtype != dtype:
        raise ValueError(f"a sharded state in {atm.lon.blocks[0].dtype}, "
                         f"the compute mode is {dtype}")
    if cache is None:
        npb = atm.time.blocks[0].shape[0]
        cache = join_cache([Cache.zeros(npb, dtype, iso_npmax=iso_npmax,
                                        device=d) for d in mesh.devices],
                           mesh)
    elif not isinstance(cache.dt, Sharded):
        cache = shard_cache(cache, mesh)
    return atm, cache


def _live_times(atm: Atm):
    """The least and greatest time of each shard's live parcels (numpy,
    on the host): what ``init_time_range`` takes of a sharded Atm."""
    out = []
    for k in range(len(atm.time.blocks)):
        a_k = atm_block(atm, k)
        if a_k.np:
            t = a_k.time[:a_k.np]
            out.append(torch.stack([t.min(), t.max()]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def _dd_refusal(ctl: Ctl, mesh, checkpoint_file) -> Optional[str]:
    """Why the domain-decomposed step cannot run this configuration
    (None: it can)."""
    if mesh is not None:
        return "DD 1 with a mesh"
    if ctl.tpu_fast:
        return f"DD 1 with TPU_FAST {ctl.tpu_fast} (the exact path only)"
    if (ctl.oh_chem_reaction != 0 or ctl.h2o2_chem_reaction != 0
            or ctl.kpp_chem):
        return "DD 1 with a chemistry grid"
    if ctl.mixing_trop >= 0 and ctl.mixing_strat >= 0:
        return "DD 1 with mixing"
    if 1 <= ctl.isosurf <= 4:
        return "DD 1 with ISOSURF"
    if checkpoint_file:
        return "DD 1 with checkpoints"
    return None


class DDRun:
    """The domain decomposition of a run of ``n`` parcels: the grid of
    subdomains (``parallel.dd.DDGrid``), a subdomain's slots (``cap``,
    twice its share of the parcels) and exchange buffer to each other
    subdomain (``exch_cap``, an eighth of its slots), the decomposed
    step, and the tiles of the met pair in use (made once a pair,
    ``tiles_of``)."""

    def __init__(self, ctl: Ctl, clim: Clim, met01: Met, device, n: int):
        self.grid = ddm.plan_decomposition(ctl, met01)
        cap = self.cap = max(2 * n // self.grid.ndev, 1)
        exch_cap = self.exch_cap = max(cap // 8, 1)
        self.lat_axis = grid_axes(met01)[1]
        self.step = ddm.make_dd_step(
            ctl, clim, self.grid, ddm.local_group(self.grid.ndev, device),
            cap, exch_cap, self.lat_axis)
        self.tiles = self.tiles_src = None

    def tiles_of(self, met01: Met) -> Met:
        if self.tiles_src is not met01:
            self.release()
            self.tiles = ddm.make_tiles(self.grid, met01)
            self.tiles_src = met01
        return self.tiles

    def release(self):
        """Drop the tiles (before a new met pair is read)."""
        self.tiles = self.tiles_src = None


class Simulation:
    """One model run: ctl + clim + atm + cache + a met source.

    ``met`` is the met source, an object with ``get(t)`` and
    ``swap_due(t)``: by default a ``MetBuffer`` over the files that
    ``METBASE`` names; ``FixedMet(met01)`` runs on a pair held in
    memory.  The device is the particle state's.  ``dtype`` is the
    compute mode (see the module docstring; default: the mode ``atm``
    is in).  ``checkpoint_file``/``checkpoint_dt`` write a checkpoint
    after every step whose time is a multiple of ``checkpoint_dt``.

    ``mesh`` (a ``parallel.mesh.Mesh``) shards the run over its devices
    (see the module docstring): ``atm`` and ``cache`` whole (split here)
    or sharded already (``parallel.mesh.join_atm``, ``join_cache``);
    ``atm`` and ``cache`` stay sharded (``parallel.mesh.unshard`` gives
    them whole); the met source and the climatology live on the mesh's
    first device.

    With ``DD 1`` (see the module docstring) the met pair of the start
    time is read at construction, and ``atm`` and ``cache`` are the
    decomposed state: ``ndev x cap`` slots, each subdomain's live
    parcels a prefix of its block, ``atm.np`` the counts a subdomain
    (``parallel.dd.gather_parcels(sim.dd.grid, sim.atm, sim.dd.cap)``
    gives them whole, as ``run()`` returns them).  ``dd`` is the
    ``DDRun`` (None without DD), ``dd_counts`` the parcels that
    overflowed an exchange buffer and that left the global domain,
    summed over the steps.
    """

    #: re-sort when the served fraction since the last sort dips below
    #: this.  Every parcel is served by this package's kernels, so
    #: ``cache.served_min`` stays 1.0 and the sort is due only by
    #: ``ctl.sort_dt``; the check keeps the loop's shape.
    SORT_SERVED_THRESH = 0.995

    def __init__(self, ctl: Ctl, atm: Atm, clim: Optional[Clim] = None,
                 dirname: str = ".", checkpoint_file: Optional[str] = None,
                 checkpoint_dt: float = 0.0, *, met=None,
                 cache: Optional[Cache] = None, dtype=None,
                 mesh: Optional[Mesh] = None):
        if ctl.dd:
            why = _dd_refusal(ctl, mesh, checkpoint_file)
            if why is not None:
                raise NotImplementedError(why)
        self.mesh = mesh
        iso_npmax = None if 1 <= ctl.isosurf <= 4 else 1
        if mesh is None:
            device = atm.time.device
            dtype = atm.lon.dtype if dtype is None else dtype
        else:
            device = mesh.devices[0]
            if dtype is None:
                dtype = (atm.lon.blocks[0] if isinstance(atm.lon, Sharded)
                         else atm.lon).dtype
        if clim is None:
            clim = read_clim(ctl, device=device)
        if mesh is None:
            self.ctl = init_time_range(ctl, atm.time[:atm.np])
            if atm.lon.dtype != dtype:
                atm = astype_state(atm=atm, dtype=dtype)
            if cache is None:
                cache = Cache.zeros(atm.npmax, dtype, iso_npmax=iso_npmax,
                                    device=device)
        else:
            atm, cache = _sharded_state(atm, cache, mesh, dtype, iso_npmax)
            self.ctl = init_time_range(ctl, _live_times(atm))
        self.atm = atm
        self.clim = (clim if dtype == torch.float64
                     else astype_state(clim=clim, dtype=dtype))
        self.cache = cache
        self.met = met if met is not None else MetBuffer(
            self.ctl, self.clim, device=device, dtype=dtype)
        self.dirname = dirname
        self.dtype = dtype
        self.checkpoint_file = checkpoint_file
        self.checkpoint_dt = checkpoint_dt
        self._resume_t: Optional[float] = None
        self.timers = Timers()
        self.nsorts = 0
        self._first = True
        self._output = None
        self._pack: Optional[MetPack] = None
        self._pack_src: Optional[Met] = None
        #: with a mesh: the step over the shards (and their threads), and
        #: the met pair's replicas, one a device
        self._sharded = (None if mesh is None
                         else make_sharded_step(self.ctl, self.clim, mesh))
        self._met_rep = self._met_rep_src = None
        self.dd: Optional[DDRun] = None
        self.dd_counts: Optional[Dict[str, int]] = None
        if self.ctl.dd:
            self._start_dd(device)

    def _start_dd(self, device):
        """The decomposed state from the whole one: the first step's
        initialisation on the start time's met pair, then the parcels
        scattered to their subdomains' blocks."""
        met01 = self.met.get(self.ctl.t_start)
        self.atm, self.cache = pipeline.init_modules(
            self.ctl, self.clim, met01, self.atm, self.cache)
        self._first = False
        self.dd = DDRun(self.ctl, self.clim, met01, device, int(self.atm.np))
        self.atm, self.cache = ddm.scatter_parcels(
            self.dd.grid, self.atm, self.dd.cap, self.dd.lat_axis,
            cache=self.cache)
        self.dd_counts = {"overflow": 0, "lost": 0}

    def resume(self, path: Optional[str] = None):
        """Restore the state of a checkpoint (of either package) onto
        this simulation's device and compute mode, and continue after
        its time: ``run()`` then steps from the next step time on."""
        from mptrac_tpu_torch.checkpoint import load_checkpoint
        if self.dd is not None:
            raise NotImplementedError("DD 1 with checkpoints")
        atm, cache, t, _ = load_checkpoint(
            path or self.checkpoint_file,
            device="cpu" if self.mesh is not None else self.atm.time.device)
        if atm.lon.dtype != self.dtype:
            atm, cache = astype_state(atm=atm, cache=cache, dtype=self.dtype)
        if self.mesh is not None:
            atm, cache = _sharded_state(atm, cache, self.mesh, self.dtype,
                                        None)
        self.atm, self.cache = atm, cache
        self._resume_t = t
        self._first = False
        return self

    @property
    def pack(self) -> Optional[MetPack]:
        """The gather tables of the current met pair (None before the
        first step, after a release, and with ``TPU_FAST 0``); with a
        mesh a tuple of them, one a shard."""
        return self._pack

    def _get_pack(self, met01: Met) -> Optional[MetPack]:
        """Gather tables, rebuilt once per met pair (TPU_FAST only); with
        a mesh each device's from its replica, on its own thread."""
        if self._pack_src is not met01:
            with span("pack.build"):
                if self.mesh is None:
                    self._pack = build_pack(self.ctl, met01)
                else:
                    reps = self._replicas(met01)
                    devs = self.mesh.devices
                    first = [devs.index(d) for d in devs]
                    packs = self._sharded.map(
                        lambda k: build_pack(self.ctl, reps[k])
                        if first[k] == k else None)
                    self._pack = tuple(packs[j] for j in first)
            self._pack_src = met01
        return self._pack

    def _replicas(self, met01: Met):
        """The met pair on every mesh device, copied once a pair."""
        if self._met_rep_src is not met01:
            self._met_rep = None          # the old pair's replicas first
            with span("met.replicate"):
                self._met_rep = replicate_met(met01, self.mesh)
            self._met_rep_src = met01
        return self._met_rep

    def _each_shard(self, fn, met01: Met):
        """``fn(k, met, atm, cache)`` -> ``(atm, cache)`` on every shard
        ``k`` (its met replica and state), each on its device's thread;
        returns the sharded state of the results."""
        reps = self._replicas(met01)
        atm, cache = self.atm, self.cache
        out = self._sharded.map(lambda k: fn(
            k, reps[k], atm_block(atm, k), cache_block(cache, k)))
        return (join_atm([a for a, _ in out], self.mesh, atm.np),
                join_cache([c for _, c in out], self.mesh))

    def _sort_due(self) -> bool:
        # served_min is a host float (a list of them with DD): no device
        # sync
        served = self.cache.served_min
        if isinstance(served, list):
            served = min(served)
        return served is not None and served < self.SORT_SERVED_THRESH

    def sort(self, met01: Optional[Met] = None):
        """Sort the particle state by met grid cell (on the pair of the
        current start time when none is given)."""
        if met01 is None:
            met01 = self.met.get(self.ctl.t_start)
        with self.timers.timer("MODULE_SORT", "PHYSICS", "sort"):
            if self.dd is not None:
                self._sort_blocks(met01)
            elif self.mesh is None:
                self.atm, self.cache = module_sort(met01, self.atm,
                                                   self.cache)
            else:
                self.atm, self.cache = self._each_shard(_sort_shard, met01)
        self.nsorts += 1

    def _sort_blocks(self, met01: Met):
        """Each subdomain's live parcels sorted in its own block by the
        cells of its tile (``module_sort`` of this module, looked up at
        the call), each in a span ``sort``."""
        tiles = self.dd.tiles_of(met01)
        atm, cache = self.atm, self.cache
        for i, n_i in enumerate(int(k) for k in atm.np):
            if not n_i:
                continue
            views = ddm.block(atm, cache, self.dd.cap, i, n_i)
            with span("sort"):
                a_i, c_i = module_sort(ddm.tile(tiles, i), views[0],
                                       views[1].replace(served_min=None))
            ddm.write_block(views, a_i, c_i)
        self.cache = cache.replace(served_min=[1.0] * len(atm.np))

    def _dd_step(self, met01: Met, t: float):
        self.atm, self.cache, overflow, lost = self.dd.step(
            self.dd.tiles_of(met01), self.atm, self.cache, t, self._flags(t))
        self.dd_counts["overflow"] += int(overflow.sum())
        self.dd_counts["lost"] += int(lost.sum())

    def _flags(self, t: float) -> pipeline.StepFlags:
        ctl = self.ctl

        def hit(dt):
            return dt <= 0 or math.fmod(t, dt) == 0

        return pipeline.StepFlags(
            do_conv=ctl.conv_dt <= 0 or math.fmod(t, ctl.conv_dt) == 0,
            do_mixing=hit(ctl.mixing_dt),
            do_kpp=hit(ctl.dt_kpp),
            do_meteo=(ctl.met_dt_out > 0
                      and (ctl.met_dt_out < ctl.dt_mod
                           or math.fmod(t, ctl.met_dt_out) == 0)),
        )

    def times(self):
        """Iterator over model step times (reference trac.c:122-129)."""
        ctl = self.ctl
        t = ctl.t_start
        while ctl.direction * (t - ctl.t_stop) < ctl.dt_mod:
            yield min(t, ctl.t_stop) if ctl.direction == 1 else max(
                t, ctl.t_stop)
            t += ctl.direction * ctl.dt_mod

    @span("advance", step=True)
    def advance(self, t: float, write_output: bool = True):
        """One step of the run loop at model time ``t``: met
        buffering, optional sort, the timestep, output (reference
        trac.c:122-160).  While tracing (``utils.timers``) it is the
        root span of a new step index, over ``met.get`` (with
        ``met.read`` per file and ``met.shift``), ``sort``,
        ``pack.build``, ``step``, ``output`` and ``checkpoint``; with a
        mesh also ``met.replicate`` and, on each shard's thread, a
        ``sort`` under the sort and a ``shard`` under the step; with DD
        a ``sort`` a subdomain under the sort, ``dd.tiles`` and the
        decomposed step's ``dd.step`` under the step."""
        if self.met.swap_due(t):
            # release the old pair's tables before the new pair is read
            self._pack = self._pack_src = None
            self._met_rep = self._met_rep_src = None
            if self.dd is not None:
                self.dd.release()
        with self.timers.timer("GET_MET", "INPUT", "met.get"):
            met01 = self.met.get(t)
        if self._first:
            if self.mesh is None:
                self.atm, self.cache = pipeline.init_modules(
                    self.ctl, self.clim, met01, self.atm, self.cache)
            else:
                clims = self._sharded.clims
                self.atm, self.cache = self._each_shard(
                    lambda k, met, atm, cache: pipeline.init_modules(
                        self.ctl, clims[k], met, atm, cache), met01)
            self._first = False
        if self.ctl.sort_dt > 0 and (
                math.fmod(t, self.ctl.sort_dt) == 0 or self._sort_due()):
            self.sort(met01)
        pack = self._get_pack(met01)
        with self.timers.timer("RUN_TIMESTEP", "PHYSICS", "step"):
            if self.dd is not None:
                self._dd_step(met01, t)
            elif self.mesh is None:
                self.atm, self.cache = pipeline.run_timestep(
                    self.ctl, self.clim, met01, self.atm, self.cache, t,
                    self._flags(t), pack)
            else:
                self.atm, self.cache = self._sharded(
                    self._replicas(met01), self.atm, self.cache, t,
                    self._flags(t), pack)
        if write_output:
            with self.timers.timer("WRITE_OUTPUT", "OUTPUT", "output"):
                self.write_output(t)
        if (self.checkpoint_file and self.checkpoint_dt > 0
                and math.fmod(t, self.checkpoint_dt) == 0):
            from mptrac_tpu_torch.checkpoint import save_checkpoint
            with span("checkpoint"):
                atm, cache = self.atm, self.cache
                if self.mesh is not None:
                    atm, cache = unshard(atm), unshard(cache)
                save_checkpoint(self.checkpoint_file, atm, cache, t)

    def close(self):
        """Flush and close output files; stop the shards' threads."""
        if self._output is not None:
            self._output.close()
            self._output = None
        if self._sharded is not None:
            self._sharded.close()

    def run(self, write_output: bool = True, progress: bool = False,
            scan: bool = True, ts: Optional[Iterable[float]] = None):
        """Run the time loop over ``ts`` (default: every step time of
        the run after the resumed checkpoint's, if any, and then the timer
        table is printed at LOGLEV >= 1).  ``scan`` is accepted for the
        JAX package's signature; every step is dispatched on its own.
        Returns the particle state (with DD its live parcels gathered
        whole)."""
        if ts is None:
            ctl, t_res = self.ctl, self._resume_t
            steps = [t for t in self.times() if t_res is None
                     or ctl.direction * (t - t_res) > 0]
        else:
            steps = ts
        for t in steps:
            self.advance(t, write_output)
            if progress:
                print(f"  t={t:.0f}", flush=True)
        self.close()
        if ts is None:
            # End-of-run timer table (reference PRINT_TIMERS, h:2255)
            from mptrac_tpu_torch.utils.log import get_level
            if get_level() >= 1:
                self.timers.report()
        return self.parcels()

    def parcels(self) -> Atm:
        """The particle state; with DD its live parcels gathered into one
        Atm, subdomain by subdomain."""
        if self.dd is None:
            return self.atm
        return ddm.gather_parcels(self.dd.grid, self.atm, self.dd.cap)

    def write_output(self, t: float):
        """Output dispatcher (reference mptrac_write_output, c:7919)."""
        from mptrac_tpu_torch.io.output import OutputManager
        if self._output is None:
            self._output = OutputManager(self.dirname, self.ctl)
        atm = self.parcels()
        if self.mesh is not None:
            atm = unshard(atm, self.mesh.devices[0])
        self._output.write(self.met, atm, t)


def _sort_shard(k: int, met01: Met, atm: Atm, cache: Cache):
    """Shard ``k``'s sort on its device's thread (``module_sort`` of this
    module, looked up at the call), in a span ``sort``."""
    with span("sort"):
        return module_sort(met01, atm, cache)


def run_trac(dirname: str, ctl_file: str, atm_file: str, args=(),
             device="cuda", dtype=torch.float64,
             mesh: Optional[Mesh] = None) -> Simulation:
    """Equivalent of the reference trac program for one dirlist task
    (trac.c:95-185): read the control and particle files of ``dirname``,
    run, write the outputs there.  With ``mesh`` the run is sharded over
    its devices (the parcels are read onto the first); with ``DD 1`` it
    is domain-decomposed (``Simulation``)."""
    import time
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    ctl = read_ctl(os.path.join(dirname, ctl_file), args)
    t0 = time.perf_counter()
    with span("read_atm"):
        atm = atm_io.read_atm(os.path.join(dirname, atm_file), ctl,
                              dtype=dtype, device=dev)
    dt_read = time.perf_counter() - t0
    sim = Simulation(ctl, atm, dirname=dirname, dtype=dtype, mesh=mesh)
    sim.timers.add("READ_ATM", "INPUT", dt_read)
    sim.run()
    return sim
