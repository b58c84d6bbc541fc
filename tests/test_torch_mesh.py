"""Particle sharding of the port (``mptrac_tpu_torch.parallel.mesh``) held
against the unsharded step and the JAX package's ``parallel/mesh.py``:
the sharded step over 4 explicit CPU devices (the counterpart of JAX's
virtual CPU devices) equals the unsharded step bit for bit with the
diffusion on, and each shard draws its own slice of the global random
draw (``ops.rng``, ``part``)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mptrac_tpu.parallel import mesh as jmesh
from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.ops import rng
from mptrac_tpu_torch.parallel import mesh as tmesh
from mptrac_tpu_torch.physics import pipeline
from mptrac_tpu_torch.types import (CACHE_DEVICE_SCALAR_FIELDS,
                                    CACHE_GLOBAL_FIELDS,
                                    CACHE_PARTICLE2D_FIELDS,
                                    CACHE_PARTICLE_FIELDS, Cache)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("LOGLEV", "0")

CPU4 = [torch.device("cpu")] * 4


def test_cache_categories_match_jax():
    """The port's copy of the Cache field categories is the JAX
    package's, plus the port's own shard slice."""
    from mptrac_tpu import types as jt
    assert CACHE_PARTICLE_FIELDS == jt.CACHE_PARTICLE_FIELDS
    assert CACHE_PARTICLE2D_FIELDS == jt.CACHE_PARTICLE2D_FIELDS
    assert CACHE_DEVICE_SCALAR_FIELDS == jt.CACHE_DEVICE_SCALAR_FIELDS
    assert CACHE_GLOBAL_FIELDS == jt.CACHE_GLOBAL_FIELDS
    from mptrac_tpu_torch.types import CACHE_SHARD_FIELDS
    assert CACHE_SHARD_FIELDS == ("rng_part",)


def test_make_mesh_devices_and_limits():
    """Explicit devices make a mesh of that many; without them the mesh
    lists CUDA devices and raises beyond those present, as JAX's does."""
    m = tmesh.make_mesh(4, devices=CPU4)
    assert m.size == 4 and m.devices == tuple(CPU4) and m.axis == "dp"
    assert tmesh.make_mesh(2, axis="sub", devices=CPU4).size == 2
    with pytest.raises(ValueError, match="devices were given"):
        tmesh.make_mesh(5, devices=CPU4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            tmesh.make_mesh(1)
    with pytest.raises(ValueError, match="axis"):
        tmesh.particle_sharding(m, "sub")


def test_pad_to_multiple_matches_jax():
    from mptrac_tpu.types import Atm as JAtm
    ja = JAtm.zeros(10, ("m",)).replace(lon=jnp.arange(10.0),
                                        np=jnp.asarray(7, jnp.int32))
    ctl, clim, met01, ta, cache = flagship.make_setup(
        10, 36, 19, 8, device="cpu", dtype=torch.float64)
    ta = ta.replace(lon=torch.arange(10.0, dtype=torch.float64), np=7)
    jp = jmesh.pad_to_multiple(ja, 4)
    tp = tmesh.pad_to_multiple(ta, 4)
    assert tp.npmax == jp.npmax == 12 and tp.np == 7
    np.testing.assert_array_equal(tp.lon.numpy(), np.asarray(jp.lon))
    assert tmesh.pad_to_multiple(tp, 4) is tp


def test_shard_atm_and_cache_placements():
    """Particle fields split into one block a device, uvwp along its
    parcel axis, the small tables replicated, the host values kept."""
    ctl, clim, met01, atm, cache = flagship.make_setup(
        64, 36, 19, 8, device="cpu", dtype=torch.float64)
    m = tmesh.make_mesh(4, devices=CPU4)
    sa = tmesh.shard_atm(atm, m)
    assert [b.shape[0] for b in sa.lon.blocks] == [16] * 4
    assert sa.np == 64 and sa.lon.shape == (64,)
    torch.testing.assert_close(sa.lon.full(), atm.lon, rtol=0, atol=0)
    cache = Cache.zeros(64, device="cpu")
    sc = tmesh.shard_cache(cache, m)
    assert [tuple(b.shape) for b in sc.uvwp.blocks] == [(3, 16)] * 4
    assert [b.shape[0] for b in sc.dt.blocks] == [16] * 4
    assert sc.iso_var.sharding.dim == 0
    assert sc.iso_ps.sharding.dim is None
    assert sc.rng_ctr == 0 and sc.iso_n == 0 and sc.rng_part is None
    sc1 = tmesh.shard_cache(Cache.zeros(64, iso_npmax=1, device="cpu"), m)
    assert sc1.iso_var.sharding.dim is None
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_atm(atm.replace(
            lon=atm.lon[:63], lat=atm.lat[:63], p=atm.p[:63],
            time=atm.time[:63], q={k: v[:63] for k, v in atm.q.items()}),
            m)


@pytest.mark.parametrize("rng_type", [1, 2])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rng_part_is_the_slice_of_the_global_draw(rng_type, dtype):
    """A shard's draws are its columns of the global [3, N] draw (and of
    the global uniform and normal draws), and its counter is the global
    one."""
    dt = getattr(torch, dtype)
    total, ctr = 1000, 123456789
    whole, wctr = rng.module_rng3(rng_type, ctr, total, dt, "cpu")
    uni, uctr = rng.module_rng(rng_type, ctr, total, 0, dt, "cpu")
    nrm, nctr = rng.module_rng(rng_type, ctr, total, 1, dt, "cpu")
    for first, n in ((0, 250), (250, 250), (333, 1), (501, 499)):
        part, pctr = rng.module_rng3(rng_type, ctr, n, dt, "cpu",
                                     part=(first, total))
        assert pctr == wctr
        torch.testing.assert_close(part, whole[:, first:first + n],
                                   rtol=0, atol=0)
        u, c = rng.module_rng(rng_type, ctr, n, 0, dt, "cpu",
                              part=(first, total))
        assert c == uctr
        torch.testing.assert_close(u, uni[first:first + n], rtol=0, atol=0)
        z, c = rng.module_rng(rng_type, ctr, n, 1, dt, "cpu",
                              part=(first, total))
        assert c == nctr
        torch.testing.assert_close(z, nrm[first:first + n], rtol=0, atol=0)


def _setup(dtype, extra=()):
    """The flagship at the tests' size with turbulent and mesoscale
    diffusion, convection and decay, 1024 slots of which 1000 live."""
    ctl, clim, met01, atm, cache = flagship.make_setup(
        1024, 36, 19, 8, extra_args=("TPU_FAST", "0") + tuple(extra),
        device="cpu", dtype=dtype, phys="conv")
    return ctl, clim, met01, atm.replace(np=1000), cache


@pytest.mark.parametrize("dtype,extra", [
    ("float64", ()), ("float32", ()), ("float64", ("RNG_TYPE", "2"))],
    ids=["float64", "float32", "threefry"])
def test_sharded_step_equals_unsharded_bit_for_bit(dtype, extra):
    """Three steps over 4 shards on explicit CPU devices against the
    unsharded step: every column equal bit for bit, and the counter
    advanced once by each global draw."""
    dt = getattr(torch, dtype)
    ctl, clim, met01, atm, cache = _setup(dt, extra)
    m = tmesh.make_mesh(4, devices=CPU4)
    step = tmesh.make_sharded_step(ctl, clim, m)
    met_rep = tmesh.replicate_met(met01, m)
    sa, sc = tmesh.shard_atm(atm, m), tmesh.shard_cache(cache, m)
    a, c = atm, cache
    for i in range(1, 4):
        t = i * ctl.dt_mod
        a, c = pipeline.run_timestep(ctl, clim, met01, a, c, t)
        sa, sc = step(met_rep, sa, sc, t)
    assert c.rng_ctr > 0 and sc.rng_ctr == c.rng_ctr
    ua, uc = tmesh.unshard(sa), tmesh.unshard(sc)
    for name in ("time", "lon", "lat", "p"):
        torch.testing.assert_close(getattr(ua, name), getattr(a, name),
                                   rtol=0, atol=0)
    for k in a.q:
        torch.testing.assert_close(ua.q[k], a.q[k], rtol=0, atol=0)
    torch.testing.assert_close(uc.uvwp, c.uvwp, rtol=0, atol=0)
    torch.testing.assert_close(uc.dt, c.dt, rtol=0, atol=0)
    assert float((ua.lon - atm.lon).abs().max()) > 0


def test_sharded_step_refuses_modules_across_shards():
    ctl, clim, met01, atm, cache = _setup(torch.float64)
    m = tmesh.make_mesh(2, devices=CPU4[:2])
    for kw, match in ((dict(mixing_trop=1e-3, mixing_strat=1e-6),
                       "mixing"),
                      (dict(oh_chem_reaction=2), "chemistry grid")):
        with pytest.raises(NotImplementedError, match=match):
            tmesh.make_sharded_step(ctl.replace(**kw), clim, m)
