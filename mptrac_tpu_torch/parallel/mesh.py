"""Particle data parallelism over a 1-D mesh of devices.

Counterpart of the JAX package's ``parallel/mesh.py``: parcels are
sharded over a mesh axis, the met fields replicated on every device, and
the step runs on every shard with no communication (the reference's
OpenMP particle loops, mptrac.h:1536 PARTICLE_LOOP).  JAX lets
``jax.jit`` partition one global program over sharded arrays; PyTorch
has no such partitioner, so here a sharded array is a ``Sharded``: the
blocks of one global tensor, one a device, and ``make_sharded_step``
runs the port's step on each block, each shard on a thread of its own
with its device current, so that all cards run at once
(``sim.Simulation(..., mesh=)`` runs a whole run this way).  Two things
a block cannot compute alone.  Its random draws: each shard draws its
own parcels' slice of the global draw (``Cache.rng_part``), so the
sharded step equals the
unsharded one bit for bit and the counter advances once by the global
draw.  And the box sums of mixing and of the chemistry grid, which take
the parcels of every shard: there the shards add their sums at a
barrier, and the step equals the unsharded one up to the order of those
float sums.

A mesh may name one device several times (``make_mesh(4,
devices=[torch.device("cpu")] * 4)``): the tests' counterpart of JAX's
virtual CPU devices.  Spatial domain decomposition (met tiles and parcel
migration) is :mod:`mptrac_tpu_torch.parallel.dd`; several processes
are :mod:`mptrac_tpu_torch.parallel.multihost`.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from mptrac_tpu_torch.types import (Atm, Cache, Met, _map_tensors,
                                    cache_field_tree, resolve_device)
from mptrac_tpu_torch.utils import timers


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` are this process's, one a shard or
    subdomain, in mesh order; with ``process_count`` > 1 every process
    holds ``len(devices)`` of the ``size`` positions, from
    ``process_index * len(devices)`` on (multihost.global_mesh)."""
    devices: Tuple[torch.device, ...]
    axis: str = "dp"
    process_count: int = 1
    process_index: int = 0

    @property
    def size(self) -> int:
        return len(self.devices) * self.process_count


@dataclass(frozen=True)
class NamedSharding:
    """Placement of a tensor on a mesh: ``dim`` is the dimension split
    into one block a device, None for a copy on every device."""
    mesh: Mesh
    dim: Optional[int]


@dataclass
class Sharded:
    """One global tensor held as blocks, one for each of this process's
    mesh devices; ``shape`` is the global shape."""
    blocks: Tuple[torch.Tensor, ...]
    sharding: NamedSharding
    shape: Tuple[int, ...]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the first block's by
        default); a single-process mesh only."""
        dev = self.blocks[0].device if device is None else device
        if self.sharding.dim is None:
            return self.blocks[0].to(dev)
        return torch.cat([b.to(dev) for b in self.blocks],
                         dim=self.sharding.dim)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices``: the first CUDA devices, or ``devices``
    where given.  Raises, as the JAX package does, when more are asked
    for than there are."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        n = count if n_devices is None else n_devices
        if n > count or n < 1:
            raise ValueError(
                f"Requested {n}-device mesh but only {count} CUDA devices "
                "are available (pass devices=[torch.device('cpu')] * n "
                "for a mesh on the CPU)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"Requested {n}-device mesh but {len(devs)} "
                         "devices were given")
    return Mesh(devices=devs[:n], axis=axis)


def particle_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    _check_axis(mesh, axis)
    return NamedSharding(mesh, 0)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, None)


def _check_axis(mesh, axis):
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


def put(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``x`` split along ``sharding.dim`` into equal blocks, one on each
    mesh device, or copied to every device."""
    devs = sharding.mesh.devices
    if sharding.dim is None:
        return Sharded(tuple(x.to(d) for d in devs), sharding,
                       tuple(x.shape))
    n = x.shape[sharding.dim]
    if n % len(devs):
        raise ValueError(f"dimension {sharding.dim} of {n} does not split "
                         f"into {len(devs)} blocks (pad_to_multiple first)")
    parts = torch.chunk(x, len(devs), dim=sharding.dim)
    return Sharded(tuple(p.contiguous().to(d) for p, d in zip(parts, devs)),
                   sharding, tuple(x.shape))


def shard_atm(atm: Atm, mesh: Mesh, axis: str = "dp") -> Atm:
    """Particle columns sharded over the mesh; ``np`` (a host int) stays
    the global count.  The capacity must divide by the mesh size."""
    ps = particle_sharding(mesh, axis)
    return Atm(time=put(atm.time, ps), p=put(atm.p, ps),
               lon=put(atm.lon, ps), lat=put(atm.lat, ps),
               q={k: put(v, ps) for k, v in atm.q.items()}, np=atm.np)


def _cache_placement(cache: Cache, mesh: Mesh, axis: str) -> Cache:
    """Placements from the Cache field categories (types.py), so that a
    new field cannot be left out: particle fields sharded, ``uvwp`` along
    its parcel axis, the small tables replicated; None for the host
    values (the counter, the served fraction, the balloon count)."""
    ps = particle_sharding(mesh, axis)
    placement = cache_field_tree(particle=ps, particle2d=NamedSharding(
        mesh, 1), device_scalar=None, glob=replicated(mesh), shard=None)
    # iso_var may be the [1] placeholder when ISOSURF is off
    if cache.iso_var.shape != cache.dt.shape:
        placement = placement.replace(iso_var=replicated(mesh))
    return placement


def shard_cache(cache: Cache, mesh: Mesh, axis: str = "dp") -> Cache:
    """The Cache placed over the mesh (``_cache_placement``); the host
    values stay as they are."""
    kw = {}
    for name, where in vars(_cache_placement(cache, mesh, axis)).items():
        value = getattr(cache, name)
        kw[name] = (put(value, where) if isinstance(value, torch.Tensor)
                    and where is not None else value)
    return Cache(**kw)


def replicate_met(met: Met, mesh: Mesh) -> Tuple[Met, ...]:
    """The met pair on every mesh device: one ``Met`` a device (the same
    object where the mesh names a device again)."""
    return _replicate(met, mesh)


def _replicate(obj, mesh):
    made = {}
    for d in mesh.devices:
        if d not in made:
            made[d] = _map_tensors(obj, lambda a: a.to(d))
    return tuple(made[d] for d in mesh.devices)


def pad_to_multiple(atm: Atm, multiple: int) -> Atm:
    """Grow the particle capacity to a multiple of ``multiple`` (padded
    slots lie beyond ``atm.np``)."""
    npmax = atm.npmax
    target = -(-npmax // multiple) * multiple
    if target == npmax:
        return atm
    pad = target - npmax

    def padded(x):
        return torch.cat([x, x.new_zeros(pad)])

    return Atm(time=padded(atm.time), p=padded(atm.p), lon=padded(atm.lon),
               lat=padded(atm.lat), q={k: padded(v) for k, v in atm.q.items()},
               np=atm.np)


class _BoxReducer:
    """The box sums of one step over the shards that run it in lockstep
    threads: each shard hands in its sums and waits at a barrier; the
    last to arrive adds them in shard order on the first shard's device,
    and every shard takes the total back to its own device.  Every shard
    makes the same box sums in the same order (one ctl, one set of
    quantities); a shard reads the total before it can hand in its next
    sums, so one total at a time suffices."""

    def __init__(self, mesh: Mesh):
        self.device = mesh.devices[0]
        self.parts = [None] * len(mesh.devices)
        self.total = None
        self.barrier = threading.Barrier(len(mesh.devices),
                                         action=self._combine)

    def _combine(self):
        total = self.parts[0].to(self.device)
        for part in self.parts[1:]:
            total = total + part.to(self.device)
        self.total = total

    def shard(self, k: int):
        def reduce(part: torch.Tensor) -> torch.Tensor:
            self.parts[k] = part
            self.barrier.wait()
            return self.total.to(part.device)
        return reduce


def _crosses_shards(ctl, flags) -> bool:
    """Whether the step runs a module that sums parcels of every shard
    (``physics.mixing.box_sum``): mixing or the chemistry grid, as
    ``pipeline.run_timestep`` gates them."""
    return ((ctl.mixing_trop >= 0 and ctl.mixing_strat >= 0
             and flags.do_mixing)
            or ctl.oh_chem_reaction != 0 or ctl.h2o2_chem_reaction != 0
            or (ctl.kpp_chem and flags.do_kpp))


def _alone(part):
    """The box sum of a shard in a step that ``_crosses_shards`` does not
    know to cross the shards."""
    raise RuntimeError("sharded step: a box sum in a step whose shards "
                       "were given no sum over the shards")


def _shard_loop(dev, jobs) -> None:
    """A shard thread: run the jobs of ``jobs`` with ``dev`` current
    until it hands a None."""
    where = (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext())
    with where:
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, k, parent, out, errors, done = job
            try:
                with timers.adopt(parent):
                    out[k] = fn(k)
            except BaseException as exc:
                errors.append(exc)             # map raises it
            finally:
                done.release()
                # hold nothing of the job (its state) until the next one
                del job, fn, parent, out, errors, done


def _stop(queues: list) -> None:
    for jobs in queues:
        jobs.put(None)


def atm_block(atm: Atm, k: int) -> Atm:
    """Shard ``k`` of a sharded Atm as a plain Atm, its live count the
    part of the global count that falls into its block."""
    c = atm.time.blocks[0].shape[0]
    return Atm(time=atm.time.blocks[k], p=atm.p.blocks[k],
               lon=atm.lon.blocks[k], lat=atm.lat.blocks[k],
               q={n: v.blocks[k] for n, v in atm.q.items()},
               np=min(max(atm.np - k * c, 0), c))


def cache_block(cache: Cache, k: int) -> Cache:
    """Shard ``k`` of a sharded Cache as a plain Cache."""
    return Cache(**{name: (value.blocks[k] if isinstance(value, Sharded)
                           else value)
                    for name, value in vars(cache).items()})


def join_atm(blocks, mesh: Mesh, np: int) -> Atm:
    """The sharded Atm whose shards are ``blocks`` (plain Atms, one a
    mesh device, of equal capacity), ``np`` parcels live in all: the
    inverse of ``atm_block``."""
    ps = particle_sharding(mesh, mesh.axis)

    def join(cols):
        return Sharded(tuple(cols), ps, (sum(c.shape[0] for c in cols),))

    return Atm(time=join([b.time for b in blocks]),
               p=join([b.p for b in blocks]),
               lon=join([b.lon for b in blocks]),
               lat=join([b.lat for b in blocks]),
               q={n: join([b.q[n] for b in blocks]) for n in blocks[0].q},
               np=np)


def join_cache(blocks, mesh: Mesh) -> Cache:
    """The sharded Cache whose shards are ``blocks`` (plain Caches, one
    a mesh device), placed as ``shard_cache`` places a whole one; the
    host values are the first block's: the inverse of ``cache_block``."""
    first = blocks[0]
    kw = {}
    for name, where in vars(_cache_placement(first, mesh,
                                             mesh.axis)).items():
        value = getattr(first, name)
        if where is None or not isinstance(value, torch.Tensor):
            kw[name] = value
            continue
        shape = list(value.shape)
        if where.dim is not None:
            shape[where.dim] *= len(blocks)
        kw[name] = Sharded(tuple(getattr(b, name) for b in blocks), where,
                           tuple(shape))
    return Cache(**kw)


class ShardedStep:
    """The step over sharded parcels: the counterpart of ``jax.jit`` of
    ``pipeline.run_timestep`` on arrays placed by ``shard_atm``,
    ``shard_cache`` and ``replicate_met`` (one process).

    ``step(met_rep, atm, cache, t, flags=StepFlags(), packs=None)`` ->
    ``(atm, cache)``, sharded as they came; ``packs`` are the gather
    tables of the met replicas (``sim.build_pack``), one a shard, so that
    every shard takes the path the one-card step takes with them.  Each
    shard runs the step on its own device's thread (``map``), with its
    slice of the global random draws, in a span ``shard``.  Where the
    step mixes parcels or grids the chemistry, whose box sums take the
    parcels of every shard, each box sum is summed over the shards at a
    barrier (``_BoxReducer``): the result equals the unsharded step's up
    to the order of the float sums.  ``clims`` is the climatology on
    every device.

    The threads, one a mesh position with its device current
    (``torch.cuda.device``), start at the first ``map`` and stop at
    ``close`` (or once this object is collected): the port's kernels
    launch on the current device's stream, and a shard whose thread
    waits for its card (a read-back) holds back no other card's
    launches."""

    def __init__(self, ctl, clim, mesh: Mesh):
        self.ctl, self.mesh = ctl, mesh
        self.clims = _replicate(clim, mesh)
        self._queues: list = []
        self._threads: list = []
        weakref.finalize(self, _stop, self._queues)

    def map(self, fn) -> list:
        """``[fn(k) for each mesh position k]``, each call on position
        k's thread, all at once; returns when every call has, and raises
        the first failure (not a shard's ``BrokenBarrierError``: the
        failure that broke the barrier).  Spans the calls open take the
        caller's innermost open span as their parent."""
        if not self._threads:
            for k, dev in enumerate(self.mesh.devices):
                jobs = queue.SimpleQueue()
                th = threading.Thread(target=_shard_loop, args=(dev, jobs),
                                      name=f"mesh-shard-{k}", daemon=True)
                th.start()
                self._queues.append(jobs)
                self._threads.append(th)
        n = len(self._queues)
        out, errors = [None] * n, []
        done = threading.Semaphore(0)
        parent = timers.innermost()
        for k, jobs in enumerate(self._queues):
            jobs.put((fn, k, parent, out, errors, done))
        for _ in range(n):
            done.acquire()
        if errors:
            errors.sort(key=lambda e: isinstance(
                e, threading.BrokenBarrierError))
            raise errors[0]
        return out

    def close(self) -> None:
        """Stop the threads (a later ``map`` starts new ones)."""
        _stop(self._queues)
        for th in self._threads:
            th.join()
        self._queues.clear()
        self._threads.clear()

    def __call__(self, met_rep, atm: Atm, cache: Cache, t: float,
                 flags=None, packs=None):
        from mptrac_tpu_torch.physics import mixing, pipeline

        ctl = self.ctl
        flags = pipeline.StepFlags() if flags is None else flags
        c = atm.time.blocks[0].shape[0]
        total = atm.time.shape[0]
        reducer = (_BoxReducer(self.mesh) if _crosses_shards(ctl, flags)
                   else None)
        shard_span = timers.span("shard")

        def run(k):
            a_k = atm_block(atm, k)
            c_k = cache_block(cache, k).replace(rng_part=(k * c, total))
            mixing.SHARD.reduce = (_alone if reducer is None
                                   else reducer.shard(k))
            try:
                with shard_span:
                    return pipeline.run_timestep(
                        ctl, self.clims[k], met_rep[k], a_k, c_k, float(t),
                        flags, None if packs is None else packs[k])
            except BaseException:
                if reducer is not None:
                    reducer.barrier.abort()   # release the other shards
                raise
            finally:
                mixing.SHARD.reduce = None

        out = self.map(run)
        timers.count("shards", len(out))
        caches = [c_k for _, c_k in out]
        ctrs = {c_k.rng_ctr for c_k in caches}
        if len(ctrs) != 1:
            raise RuntimeError(f"sharded step: shards ended on counters "
                               f"{sorted(ctrs)}")
        served = [c_k.served_min for c_k in caches]
        return (join_atm([a_k for a_k, _ in out], self.mesh, atm.np),
                join_cache(caches, self.mesh).replace(
                    rng_part=cache.rng_part,
                    served_min=None if None in served else min(served)))


def make_sharded_step(ctl, clim, mesh: Mesh) -> ShardedStep:
    """The step over sharded parcels (``ShardedStep``)."""
    return ShardedStep(ctl, clim, mesh)


def unshard(tree, device="cpu"):
    """Every ``Sharded`` of an Atm or Cache as its global tensor on
    ``device`` (for comparisons; a single-process mesh)."""
    if isinstance(tree, Sharded):
        return tree.full(device)
    if isinstance(tree, dict):
        return {k: unshard(v, device) for k, v in tree.items()}
    if isinstance(tree, (Atm, Cache)):
        return type(tree)(**{k: unshard(v, device)
                             for k, v in vars(tree).items()})
    return tree

