"""Checkpoint / resume of the port, as tests/test_checkpoint.py holds the
JAX package's: a run interrupted at half time and resumed from its
checkpoint reproduces the uninterrupted run bit for bit (the RNG counter
and the AR(1) perturbations included), with the PBL scheme and with an
isosurface too; and the file format is the JAX package's, so a JAX
checkpoint resumes in the port and a port checkpoint in the JAX
package."""

import os

os.environ.setdefault("LOGLEV", "0")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mptrac_tpu import read_ctl as jread_ctl
from mptrac_tpu.checkpoint import load_checkpoint as jload
from mptrac_tpu.met.synthetic import make_wind_met
from mptrac_tpu.met.write_nc import write_met_nc
from mptrac_tpu.sim import Simulation as JSimulation
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.sim import Simulation
from mptrac_tpu_torch.types import Atm

N = 100
BASE = ["NQ", "1", "QNT_NAME[0]", "m", "DT_MET", "86400", "MET_TROPO", "0",
        "MET_CAPE", "0", "MET_PBL", "3", "DIFFUSION", "1", "DT_MOD", "600"]
#: the cases of the bit-exact resume: tests/test_checkpoint.py's, with the
#: PBL scheme (its AR(1) perturbations live in the checkpoint) and
#: radioactive decay, the parcels in the met's 100 m deep boundary layer,
#: and on an isosurface (its variable too)
CASES = {
    "base": [],
    "pbl": ["TURB_PBL_SCHEME", "1", "TURB_MESOZ", "0", "RADIO_DECAY", "1"],
    "isosurf3": ["ISOSURF", "3"],
}
P_RANGE = {"base": (300, 1000), "pbl": (999.0, 1013.0),
           "isosurf3": (300, 1000)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batches of a few hundred parcels at most: more intra-op threads
    would only spin, on the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def metdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_met")
    for t0 in (0.0, 86400.0):
        fn = d / f"wind_2000_01_0{1 + int(t0 // 86400)}_00.nc"
        write_met_nc(str(fn), make_wind_met(t0=t0, nx=36, ny=19, nz=8),
                     drop_wrap_column=True)
    return d


def _args(metdir, t_stop, extra=()):
    return BASE + ["METBASE", str(metdir / "wind"), "T_STOP",
                   str(t_stop)] + list(extra)


def _positions(p_range=(300, 1000)):
    rng = np.random.default_rng(3)
    return (rng.uniform(-170, 170, N), rng.uniform(-80, 80, N),
            rng.uniform(*p_range, N))


def tsim(metdir, t_stop, extra=(), p_range=(300, 1000), **kw):
    ctl = tread_ctl(None, _args(metdir, t_stop, extra))
    lon, lat, p = _positions(p_range)
    atm = Atm(time=torch.zeros(N, dtype=torch.float64),
              p=torch.tensor(p), lon=torch.tensor(lon),
              lat=torch.tensor(lat), q={"m": torch.ones(N,
                                                        dtype=torch.float64)},
              np=N)
    return Simulation(ctl, atm, dirname=str(metdir), **kw)


def jsim(metdir, t_stop, **kw):
    ctl = jread_ctl(None, _args(metdir, t_stop))
    lon, lat, p = _positions()
    atm = JAtm.zeros(N, ctl.qnt_name).replace(
        time=jnp.zeros(N), lon=jnp.asarray(lon), lat=jnp.asarray(lat),
        p=jnp.asarray(p), np=jnp.asarray(N, jnp.int32))
    atm.q["m"] = jnp.ones(N)
    return JSimulation(ctl, atm, dirname=str(metdir), **kw)


def _same_state(a, ca, b, cb):
    for name in ("time", "lon", "lat", "p"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert set(a.q) == set(b.q)
    for name in a.q:
        assert torch.equal(a.q[name], b.q[name]), name
    assert ca.rng_ctr == cb.rng_ctr > 0
    assert torch.equal(ca.uvwp, cb.uvwp)
    assert torch.equal(ca.iso_var, cb.iso_var)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_bit_exact(metdir, tmp_path, case):
    """Uninterrupted 2-hour run; a run writing a checkpoint every 30 min
    to 1 hour; a fresh Simulation resumed from the 1-hour checkpoint and
    run to 2 hours: the same state, bit for bit."""
    extra, pr = CASES[case], P_RANGE[case]
    ck = str(tmp_path / "state.ckpt.npz")
    full = tsim(metdir, 7200.0, extra, pr)
    full.run(write_output=False)
    tsim(metdir, 3600.0, extra, pr, checkpoint_file=ck,
         checkpoint_dt=1800.0).run(write_output=False)
    assert not os.path.exists(ck + ".tmp")
    b = tsim(metdir, 7200.0, extra, pr).resume(ck)
    b.run(write_output=False)
    assert b.timers.as_dict()["RUN_TIMESTEP"]["count"] == 6
    _same_state(b.atm, b.cache, full.atm, full.cache)
    if case == "pbl":
        assert float(full.cache.uvwp[2].abs().max()) > 0
    if case == "isosurf3":
        assert full.cache.iso_var.shape == (N,)


def test_jax_checkpoint_resumes_in_the_port(metdir, tmp_path):
    """A JAX run's checkpoint loads in the port array for array (dtypes
    and host values too) and a port Simulation runs on from it."""
    ck = str(tmp_path / "jax.ckpt.npz")
    js = jsim(metdir, 3600.0, checkpoint_file=ck, checkpoint_dt=1800.0)
    js.run(write_output=False)
    atm, cache, t, meta = load_checkpoint(ck, device="cpu")
    assert t == 3600.0 and meta == {}
    for name in ("time", "lon", "lat", "p"):
        want = np.asarray(getattr(js.atm, name))
        got = getattr(atm, name).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(atm.q["m"].numpy(),
                                  np.asarray(js.atm.q["m"]))
    np.testing.assert_array_equal(cache.uvwp.numpy(),
                                  np.asarray(js.cache.uvwp))
    assert atm.np == N and cache.rng_ctr == int(js.cache.rng_ctr) > 0
    assert cache.iso_n == 0 and isinstance(cache.rng_ctr, int)
    b = tsim(metdir, 7200.0).resume(ck)
    b.run(write_output=False)
    assert float((b.atm.time - 7200.0).abs().max()) == 0.0
    assert bool(torch.isfinite(b.atm.lon).all())
    assert b.cache.rng_ctr > cache.rng_ctr


def test_port_checkpoint_resumes_in_jax(metdir, tmp_path):
    """A port run's checkpoint loads in the JAX package array for array
    (``rng_ctr`` as its uint64, ``np`` and ``iso_n`` as int32), and a JAX
    Simulation runs on from it."""
    ck = str(tmp_path / "port.ckpt.npz")
    ts = tsim(metdir, 3600.0, checkpoint_file=ck, checkpoint_dt=1800.0)
    ts.run(write_output=False)
    atm, cache, t, _ = jload(ck)
    assert t == 3600.0
    for name in ("time", "lon", "lat", "p"):
        np.testing.assert_array_equal(np.asarray(getattr(atm, name)),
                                      getattr(ts.atm, name).numpy())
    np.testing.assert_array_equal(np.asarray(cache.uvwp),
                                  ts.cache.uvwp.numpy())
    assert cache.rng_ctr.dtype == jnp.uint64
    assert int(cache.rng_ctr) == ts.cache.rng_ctr
    assert int(atm.np) == N and atm.np.dtype == jnp.int32
    b = jsim(metdir, 7200.0)
    b.resume(ck)
    b.run(write_output=False)
    assert np.isfinite(np.asarray(b.atm.lon)).all()
    assert float(np.abs(np.asarray(b.atm.time) - 7200.0).max()) == 0.0


def test_save_load_round_trip_keeps_float32_and_the_balloon(tmp_path):
    """A float32 state with a balloon track: the tensors come back in
    their dtypes (the track in float64), with ``meta``."""
    n = 7
    atm = Atm.zeros(n, ("m", "t"), dtype=torch.float32, device="cpu")
    atm = atm.replace(lon=torch.linspace(-10, 10, n), np=5,
                      time=torch.full((n,), 1.0e9, dtype=torch.float64))
    from mptrac_tpu_torch.types import Cache
    cache = Cache.zeros(n, dtype=torch.float32, device="cpu").replace(
        rng_ctr=(1 << 64) - 3, iso_ts=torch.tensor([1.0e9, 1.0e9 + 60.0],
                                                    dtype=torch.float64),
        iso_ps=torch.tensor([100.0, 90.0], dtype=torch.float64), iso_n=2)
    ck = str(tmp_path / "f32.npz")
    save_checkpoint(ck, atm, cache, 1234.5, meta={"run": "x"})
    a, c, t, meta = load_checkpoint(ck, device="cpu")
    assert (t, meta, a.np, c.rng_ctr, c.iso_n) == (
        1234.5, {"run": "x"}, 5, (1 << 64) - 3, 2)
    assert a.lon.dtype == torch.float32 and a.time.dtype == torch.float64
    assert torch.equal(a.lon, atm.lon)
    assert c.iso_ts.dtype == torch.float64
    assert torch.equal(c.iso_ts, cache.iso_ts)
