"""Particle data parallelism over a 1-D mesh of devices.

Counterpart of the JAX package's ``parallel/mesh.py``: parcels are
sharded over a mesh axis, the met fields replicated on every device, and
the step runs on every shard with no communication (the reference's
OpenMP particle loops, mptrac.h:1536 PARTICLE_LOOP).  JAX lets
``jax.jit`` partition one global program over sharded arrays; PyTorch
has no such partitioner, so here a sharded array is a ``Sharded``: the
blocks of one global tensor, one a device, and ``make_sharded_step``
runs the port's step on each block.  The one thing a block cannot
compute alone is its random draws: each shard draws its own parcels'
slice of the global draw (``Cache.rng_part``), so the sharded step
equals the unsharded one bit for bit and the counter advances once by
the global draw.

A mesh may name one device several times (``make_mesh(4,
devices=[torch.device("cpu")] * 4)``): the tests' counterpart of JAX's
virtual CPU devices.  Spatial domain decomposition (met tiles and parcel
migration) is :mod:`mptrac_tpu_torch.parallel.dd`; several processes
are :mod:`mptrac_tpu_torch.parallel.multihost`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from mptrac_tpu_torch.types import (Atm, Cache, Met, _map_tensors,
                                    cache_field_tree, resolve_device)


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


def shard_cache(cache: Cache, mesh: Mesh, axis: str = "dp") -> Cache:
    """Placements from the Cache field categories (types.py), so that a
    new field cannot be left out: particle fields sharded, ``uvwp`` along
    its parcel axis, the small tables replicated; the host values (the
    counter, the served fraction, the balloon count) stay as they are."""
    ps = particle_sharding(mesh, axis)
    placement = cache_field_tree(particle=ps, particle2d=NamedSharding(
        mesh, 1), device_scalar=None, glob=replicated(mesh), shard=None)
    # iso_var may be the [1] placeholder when ISOSURF is off
    if cache.iso_var.shape != cache.dt.shape:
        placement = placement.replace(iso_var=replicated(mesh))
    kw = {}
    for name, where in vars(placement).items():
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


def make_sharded_step(ctl, clim, mesh: Mesh):
    """The step over sharded parcels: the counterpart of ``jax.jit`` of
    ``pipeline.run_timestep`` on arrays placed by ``shard_atm``,
    ``shard_cache`` and ``replicate_met``.

    Returns ``step(met_rep, atm, cache, t, flags=StepFlags())`` ->
    ``(atm, cache)``, sharded as they came.  Every shard runs the step on
    its own device with its slice of the global random draws.  Modules
    that combine parcels across the ensemble (mixing, the chemistry
    grid) would need collectives that this step does not have: they
    raise."""
    from mptrac_tpu_torch.physics import pipeline

    if ctl.mixing_trop >= 0 and ctl.mixing_strat >= 0:
        raise NotImplementedError(
            "sharded step: interparcel mixing combines parcels of every "
            "shard")
    if ctl.oh_chem_reaction != 0 or ctl.h2o2_chem_reaction != 0 \
            or ctl.kpp_chem:
        raise NotImplementedError(
            "sharded step: the chemistry grid combines parcels of every "
            "shard")
    clims = _replicate(clim, mesh)

    def step(met_rep, atm: Atm, cache: Cache, t: float,
             flags=pipeline.StepFlags()):
        ndev = len(mesh.devices)
        c = atm.time.blocks[0].shape[0]
        total = atm.time.shape[0]
        atms, caches = [], []
        for k in range(ndev):
            a_k = Atm(time=atm.time.blocks[k], p=atm.p.blocks[k],
                      lon=atm.lon.blocks[k], lat=atm.lat.blocks[k],
                      q={n: v.blocks[k] for n, v in atm.q.items()},
                      np=min(max(atm.np - k * c, 0), c))
            c_k = _cache_block(cache, k).replace(rng_part=(k * c, total))
            a_k, c_k = pipeline.run_timestep(ctl, clims[k], met_rep[k], a_k,
                                             c_k, float(t), flags)
            atms.append(a_k)
            caches.append(c_k)
        ctrs = {c_k.rng_ctr for c_k in caches}
        if len(ctrs) != 1:
            raise RuntimeError(f"sharded step: shards ended on counters "
                               f"{sorted(ctrs)}")

        def regather(old, new):
            return Sharded(tuple(new), old.sharding, old.shape)

        atm2 = Atm(time=regather(atm.time, [a.time for a in atms]),
                   p=regather(atm.p, [a.p for a in atms]),
                   lon=regather(atm.lon, [a.lon for a in atms]),
                   lat=regather(atm.lat, [a.lat for a in atms]),
                   q={n: regather(v, [a.q[n] for a in atms])
                      for n, v in atm.q.items()}, np=atm.np)
        kw = {}
        for name, value in vars(cache).items():
            if isinstance(value, Sharded):
                kw[name] = regather(value, [getattr(c_k, name)
                                            for c_k in caches])
            elif name == "rng_part":
                kw[name] = value
            else:
                kw[name] = getattr(caches[0], name)
        return atm2, Cache(**kw)

    return step


def _cache_block(cache: Cache, k: int) -> Cache:
    """Shard ``k`` of a sharded Cache as a plain Cache."""
    return Cache(**{name: (value.blocks[k] if isinstance(value, Sharded)
                           else value)
                    for name, value in vars(cache).items()})


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

