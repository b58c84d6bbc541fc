"""The ported paths as a whole: the port's flagship timestep on the CPU
against the JAX step, for one step and for ten steps with a sort in
between, on each of the three paths (the fused kernel, the unfused
kernels, the exact interpolation in float32 and float64); and module by
module on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import small_flagship_fp32, to_torch
from mptrac_tpu.ops.fast_interp import build_met_pack as jbuild
from mptrac_tpu.ops.sort import module_sort as jsort
from mptrac_tpu.physics import decay as jdecay
from mptrac_tpu.physics import diffusion as jdiff
from mptrac_tpu.physics import pipeline as jpipe
from mptrac_tpu.physics import position as jpos
from mptrac_tpu.physics import timesteps as jts
from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.ops.fast_interp import build_met_pack as tbuild
from mptrac_tpu_torch.ops.sort import module_sort as tsort
from mptrac_tpu_torch.physics import decay as tdecay
from mptrac_tpu_torch.physics import diffusion as tdiff
from mptrac_tpu_torch.physics import pipeline as tpipe
from mptrac_tpu_torch.physics import position as tpos
from mptrac_tpu_torch.physics import timesteps as tts
from mptrac_tpu_torch.sim import FixedMet, Simulation

NSTEPS = 10
SORT_AT = 6      # a sort before this step (1-based)


@pytest.fixture(scope="module")
def runs():
    """Both packages from one state; the states after each step."""
    ctl, clim, met01, atm, cache = small_flagship_fp32()
    jpack = jbuild(met01, cell=True)
    tatm, tcache, tmet, tclim = to_torch(atm, cache, met01, clim)
    tctl, tclim2, tmet2, tatm2, _ = flagship.make_setup(
        atm.npmax, nx=36, ny=19, nz=8, device="cpu")
    tpack = tbuild(tmet, cell=True)

    atm, cache = jax.jit(jsort)(met01, atm, cache)
    tatm, tcache = tsort(tmet, tatm, tcache)
    jstates, tstates = [(atm, cache)], [(tatm, tcache)]
    for i in range(1, NSTEPS + 1):
        t = 180.0 * i
        if i == SORT_AT:
            atm, cache = jax.jit(jsort)(met01, atm, cache)
            tatm, tcache = tsort(tmet, tatm, tcache)
        atm, cache = jpipe.run_timestep(
            ctl, clim, met01, atm, cache, jnp.asarray(t, jnp.float64),
            pack=jpack)
        tatm, tcache = tpipe.run_timestep(tctl, tclim, tmet, tatm, tcache,
                                          t, pack=tpack)
        jstates.append((atm, cache))
        tstates.append((tatm, tcache))
    setup = dict(ctl=ctl, clim=clim, met01=met01, tctl=tctl, tclim=tclim,
                 tmet=tmet, tpack=tpack, own=(tclim2, tmet2, tatm2))
    return setup, jstates, tstates


def test_flagship_setup_equals_reference(runs):
    """The port's own make_setup builds the state that the JAX
    ``_make_setup`` + ``astype_state`` builds, bit for bit."""
    setup, jstates, tstates = runs
    tclim2, tmet2, tatm2 = setup["own"]
    tmet, tclim = setup["tmet"], setup["tclim"]
    # (the pair's time is a host value: a pair of floats)
    assert tmet2.time == tmet.time == (0.0, 3600.0)
    for name in ("lon", "lat", "p"):
        np.testing.assert_array_equal(getattr(tmet2, name).numpy(),
                                      getattr(tmet, name).numpy())
    for k in tmet.fields3d:
        np.testing.assert_array_equal(tmet2.fields3d[k].numpy(),
                                      tmet.fields3d[k].numpy())
    np.testing.assert_array_equal(tclim2.tropo.numpy(), tclim.tropo.numpy())
    assert tclim2.tropo.dtype == torch.float32
    # (the reference state was sorted after conversion: compare sets)
    a0 = tstates[0][0]
    for name in ("lon", "lat", "p"):
        np.testing.assert_array_equal(
            np.sort(getattr(tatm2, name).numpy()),
            np.sort(getattr(a0, name).numpy()))
    assert tatm2.np == a0.np and tatm2.time.dtype == torch.float64


def test_convert_round_trip(runs):
    """State carried across and back keeps values and dtypes: time
    float64, the state float32, uvwp float32, rng_ctr and np ints."""
    from helpers.torch_bridge import atm_to_numpy, cache_to_numpy
    from mptrac_tpu_torch.convert import to_reference_numpy
    _, jstates, _ = runs
    ja, jc = jstates[3]
    a0, c0 = atm_to_numpy(ja), cache_to_numpy(jc)
    ta, tc, _, _ = to_torch(ja, jc)
    a1, c1 = to_reference_numpy(ta, tc)
    for k in ("time", "p", "lon", "lat"):
        np.testing.assert_array_equal(a1[k], a0[k])
        assert a1[k].dtype == a0[k].dtype, k
    assert a1["time"].dtype == np.float64 and a1["lon"].dtype == np.float32
    for k in a0["q"]:
        np.testing.assert_array_equal(a1["q"][k], a0["q"][k])
    for k in ("uvwp", "dt", "iso_var", "iso_ps", "iso_ts"):
        np.testing.assert_array_equal(c1[k], c0[k])
        assert c1[k].dtype == c0[k].dtype, k
    assert c1["uvwp"].dtype == np.float32
    assert (a1["np"], c1["rng_ctr"], c1["iso_n"]) == \
        (a0["np"], c0["rng_ctr"], c0["iso_n"])
    assert isinstance(c1["rng_ctr"], int) and c1["rng_ctr"] > 0


def _compare(jstate, tstate, atol_pos, atol_uvwp):
    (ja, jc), (ta, tc) = jstate, tstate
    assert tc.rng_ctr == int(jc.rng_ctr)
    np.testing.assert_array_equal(ta.time.numpy(), np.asarray(ja.time))
    np.testing.assert_array_equal(tc.dt.numpy(), np.asarray(jc.dt))
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), rtol=0,
                                   atol=atol_pos, err_msg=name)
    np.testing.assert_allclose(ta.q["t"].numpy(), np.asarray(ja.q["t"]),
                               rtol=0, atol=6.2e-5)
    np.testing.assert_allclose(ta.q["m"].numpy(), np.asarray(ja.q["m"]),
                               rtol=2e-6, atol=0)
    np.testing.assert_allclose(tc.uvwp.numpy(), np.asarray(jc.uvwp),
                               rtol=0, atol=atol_uvwp)
    assert ta.lon.dtype == torch.float32 and ta.time.dtype == torch.float64


def test_one_step(runs):
    """One step from the same state.  The two sides do the same float32
    operations; they differ by XLA's fused multiply-adds inside its
    jitted kernels, by cos/log/exp of two math libraries (a few ulp of
    normals up to ~5, times a displacement of ~1e-2 deg or ~1 hPa) and
    by 1 ulp of a position (1.5e-5 at 180 deg, 6e-5 at 900 hPa):
    positions 6.2e-5, uvwp (sigma 2e-3 off at worst, see
    test_torch_rk_fused, times 0.16 * normal) 5e-4.  Measured: lon and
    lat 1.9e-6, p, T and m equal, uvwp 6.9e-5."""
    setup, jstates, tstates = runs
    _compare(jstates[1], tstates[1], atol_pos=6.2e-5, atol_uvwp=5e-4)
    (ja0, _), (ja1, _) = jstates[0], jstates[1]
    assert float(jnp.max(jnp.abs(ja1.lon - ja0.lon))) > 1e-3


def test_ten_steps_with_sort(runs):
    """Ten steps with a sort before the sixth.  Differences add up
    step by step (each step's position feeds the next interpolation):
    ten times the one-step bounds.  Both sorts must have put the
    parcels into the same order for this to hold at all.  Measured:
    lon 1.5e-5, lat 1.9e-6, p, T and m equal, uvwp 1.4e-4."""
    setup, jstates, tstates = runs
    _compare(jstates[NSTEPS], tstates[NSTEPS], atol_pos=6.2e-4,
             atol_uvwp=5e-3)
    ta, tc = tstates[NSTEPS]
    assert tc.rng_ctr == NSTEPS * 2 * (3 * ta.npmax + 1)
    m = ta.q["m"].numpy()
    np.testing.assert_allclose(
        m, np.exp(-180.0 / 259200.0) ** NSTEPS, rtol=1e-5)


def test_simulation_loop_matches_manual_steps(runs):
    """The run loop (sort by SORT_DT, run_timestep, advance t) reproduces
    the hand-written sequence above bit for bit: SORT_DT 900 makes the
    sort due at t = 900 (before step 5) and t = 1800 (before 10)."""
    setup, _, tstates = runs
    tctl = setup["tctl"].replace(sort_dt=900.0, tpu_fast=2)
    atm, cache = tstates[0]
    # (the loop builds its own pack from TPU_FAST and SORT_DT: the cell
    # pack, as setup["tpack"] is)
    sim = Simulation(tctl, atm, setup["tclim"], met=FixedMet(setup["tmet"]),
                     cache=cache)
    ref_a, ref_c = atm, cache
    for i in range(1, 11):
        t = 180.0 * i
        if i in (5, 10):
            ref_a, ref_c = tsort(setup["tmet"], ref_a, ref_c)
        ref_a, ref_c = tpipe.run_timestep(tctl, setup["tclim"],
                                          setup["tmet"], ref_a, ref_c, t,
                                          pack=setup["tpack"])
    sim.run(write_output=False, ts=[180.0 * i for i in range(1, 11)])
    assert sim.nsorts == 2
    np.testing.assert_array_equal(sim.atm.lon.numpy(), ref_a.lon.numpy())
    np.testing.assert_array_equal(sim.atm.p.numpy(), ref_a.p.numpy())
    assert sim.cache.rng_ctr == ref_c.rng_ctr


# ------------------------------------------------- module by module

@pytest.fixture(scope="module")
def mid(runs):
    """A mid-run state (after step 3) with dt set for the next step."""
    setup, jstates, tstates = runs
    (ja, jc), (ta, tc) = jstates[3], tstates[3]
    # same inputs on both sides: take the JAX state across
    ta, tc, _, _ = to_torch(ja, jc)
    t = 180.0 * 4
    jc = jts.module_timesteps(setup["ctl"], jc, setup["met01"], ja,
                              jnp.asarray(t, jnp.float64))
    tc = tts.module_timesteps(setup["tctl"], tc, setup["tmet"], ta, t)
    return setup, (ja, jc), (ta, tc)


def test_module_timesteps(mid):
    setup, (ja, jc), (ta, tc) = mid
    np.testing.assert_array_equal(tc.dt.numpy(), np.asarray(jc.dt))
    assert tc.dt.dtype == torch.float32 and float(tc.dt.max()) == 180.0
    # past T_STOP nothing moves
    tc2 = tts.module_timesteps(setup["tctl"].replace(t_stop=100.0), tc,
                               setup["tmet"], ta, 900.0)
    assert float(tc2.dt.abs().max()) == 0.0


def test_module_position(mid):
    """Pure selects and a reflection: equal to 1 ulp (the reflection
    ps*ps/p)."""
    setup, (ja, jc), (ta, tc) = mid
    rng = np.random.default_rng(12)
    n = ja.npmax
    lon = rng.uniform(-400, 400, n).astype(np.float32)
    lat = rng.uniform(-100, 100, n).astype(np.float32)
    p = rng.uniform(0.05, 1100, n).astype(np.float32)
    ja2 = ja.replace(lon=jnp.asarray(lon), lat=jnp.asarray(lat),
                     p=jnp.asarray(p))
    ta2 = ta.replace(lon=torch.from_numpy(lon), lat=torch.from_numpy(lat),
                     p=torch.from_numpy(p))
    ej = jpos.module_position(jc, setup["met01"], ja2)
    gt = tpos.module_position(tc, setup["tmet"], ta2)
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(ej, name)),
                                   rtol=2e-7, atol=0, err_msg=name)


def test_module_diff_turb(mid):
    """Same normals to a few ulp, same float32 operations: 1e-4 on
    positions (see test_one_step)."""
    setup, (ja, jc), (ta, tc) = mid
    jpack = jbuild(setup["met01"], cell=True)
    ej, ejc = jdiff.module_diff_turb(setup["ctl"], jc, setup["clim"],
                                     setup["met01"], ja, None, jpack.sfcT)
    gt, gtc = tdiff.module_diff_turb(setup["tctl"], tc, setup["tclim"],
                                     setup["tmet"], ta,
                                     setup["tpack"].sfcT)
    assert gtc.rng_ctr == int(ejc.rng_ctr)
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(ej, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert float((gt.lon - ta.lon).abs().max()) > 1e-4
    # and without the surface table (exact interp_time_2d) the same
    g2, _ = tdiff.module_diff_turb(setup["tctl"], tc, setup["tclim"],
                                   setup["tmet"], ta, None)
    np.testing.assert_allclose(g2.p.numpy(), gt.p.numpy(), rtol=0,
                               atol=1e-4)


def test_module_diff_meso(mid):
    setup, (ja, jc), (ta, tc) = mid
    rng = np.random.default_rng(13)
    n = ja.npmax
    sig = [rng.uniform(0.0, 3.0, n).astype(np.float32) for _ in range(3)]
    ej, ejc = jdiff.module_diff_meso(
        setup["ctl"], jc, setup["met01"], ja,
        sig=tuple(jnp.asarray(s) for s in sig))
    gt, gtc = tdiff.module_diff_meso(
        setup["tctl"], tc, setup["tmet"], ta,
        sig=tuple(torch.from_numpy(s) for s in sig))
    assert gtc.rng_ctr == int(ejc.rng_ctr)
    np.testing.assert_allclose(gtc.uvwp.numpy(), np.asarray(ejc.uvwp),
                               rtol=0, atol=1e-5)
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(ej, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    # without sig= the module computes the sigma itself (below)
    g2, _ = tdiff.module_diff_meso(setup["tctl"], tc, setup["tmet"], ta)
    assert float((g2.lon - ta.lon).abs().max()) > 0


def test_module_decay(mid):
    setup, (ja, jc), (ta, tc) = mid
    ej = jdecay.module_decay(setup["ctl"], jc, setup["clim"], ja)
    gt = tdecay.module_decay(setup["tctl"], tc, setup["tclim"], ta)
    np.testing.assert_allclose(gt.q["m"].numpy(), np.asarray(ej.q["m"]),
                               rtol=2e-7, atol=0)
    assert float(gt.q["m"].max()) < float(ta.q["m"].max())


def test_unported_gate_raises(mid, monkeypatch):
    """The modules whose gates this test held until they were ported (the
    PBL scheme, sedimentation, radioactive decay, KPP, and the domain
    decomposition's branch of module_timesteps) run now
    (tests/test_torch_pbl.py, test_torch_kpp.py and test_torch_dd.py hold
    them).  ``DD 1`` on this global grid is the step without it, bit for
    bit: the local-domain freeze that DD skips never applies there.  KPP
    waits for its interval: with ``do_kpp`` False the step is the step
    without KPP, bit for bit, as in the JAX step."""
    setup, _, (ta, tc) = mid
    plain, _ = tpipe.run_timestep(setup["tctl"], setup["tclim"],
                                  setup["tmet"], ta, tc, 720.0,
                                  pack=setup["tpack"])
    dd, _ = tpipe.run_timestep(setup["tctl"].replace(dd=1), setup["tclim"],
                               setup["tmet"], ta, tc, 720.0,
                               pack=setup["tpack"])
    for name in ("lon", "lat", "p"):
        torch.testing.assert_close(getattr(dd, name), getattr(plain, name),
                                   rtol=0, atol=0)
    for kw in (dict(turb_pbl_scheme=1),
               dict(qnt_name=("t", "m", "rp", "rhop")),
               dict(radio_decay=1)):
        ctl = setup["tctl"].replace(**kw)
        q = dict(ta.q, rp=torch.ones_like(ta.p),
                 rhop=torch.full_like(ta.p, 2500.0))
        got, _ = tpipe.run_timestep(ctl, setup["tclim"], setup["tmet"],
                                    ta.replace(q=q), tc, 720.0,
                                    pack=setup["tpack"])
        assert bool(torch.isfinite(got.p).all()), kw
    calls = []
    monkeypatch.setattr(tpipe.m_kpp, "module_kpp_chem",
                        lambda *a, **k: calls.append(1) or a[-1])
    without, _ = tpipe.run_timestep(setup["tctl"], setup["tclim"],
                                    setup["tmet"], ta, tc, 720.0,
                                    pack=setup["tpack"])
    ctl = setup["tctl"].replace(kpp_chem=1)
    skipped, _ = tpipe.run_timestep(
        ctl, setup["tclim"], setup["tmet"], ta, tc, 720.0,
        flags=tpipe.StepFlags(do_kpp=False), pack=setup["tpack"])
    assert not calls
    assert torch.equal(skipped.p, without.p)
    assert torch.equal(skipped.q["m"], without.q["m"])
    tpipe.run_timestep(ctl, setup["tclim"], setup["tmet"], ta, tc, 720.0,
                       flags=tpipe.StepFlags(do_kpp=True),
                       pack=setup["tpack"])
    assert calls == [1]
    # (the zeta/eta and model-level advection are ported:
    # tests/test_torch_zeta.py)
    # a climatological quantity of module_meteo is ported now: without
    # its table in the Clim the step runs and leaves the quantity alone
    # (tests/test_torch_clim.py holds the quantities themselves)
    ctl = setup["tctl"].replace(qnt_name=("t", "m", "oh"))
    mark = torch.full_like(ta.p, 3.0)
    got, _ = tpipe.run_timestep(
        ctl, setup["tclim"], setup["tmet"],
        ta.replace(q=dict(ta.q, oh=mark)), tc, 720.0, pack=None)
    assert torch.equal(got.q["oh"], mark)


# ------------------------------- the unfused and the exact path, whole

def _run_pair(jstate, tstate, ctl, tctl, clim, tclim, met01, tmet, jpack,
              tpack):
    """NSTEPS steps on both sides from one state, a sort before step
    SORT_AT; the states after each step."""
    (atm, cache), (tatm, tcache) = jstate, tstate
    jstates, tstates = [jstate], [tstate]
    for i in range(1, NSTEPS + 1):
        t = 180.0 * i
        if i == SORT_AT:
            atm, cache = jax.jit(jsort)(met01, atm, cache)
            tatm, tcache = tsort(tmet, tatm, tcache)
        atm, cache = jpipe.run_timestep(
            ctl, clim, met01, atm, cache, jnp.asarray(t, jnp.float64),
            pack=jpack)
        tatm, tcache = tpipe.run_timestep(tctl, tclim, tmet, tatm, tcache,
                                          t, pack=tpack)
        jstates.append((atm, cache))
        tstates.append((tatm, tcache))
    return jstates, tstates


@pytest.fixture(scope="module")
def unfused(runs):
    """The unfused step: the port on its kernels' plain versions
    (``cell=False``) against the JAX step on the packed tables of
    TPU_FAST 1 (``build_met_pack(met01)``: XLA row gathers with the
    arithmetic of the slab kernel's modes, every parcel served)."""
    setup, jstates, tstates = runs
    tpack = tbuild(setup["tmet"], cell=False)
    assert tpack.cell is None and tpack.packT is not None
    assert tuple(tpack.packT.shape) == (8, 37, 19, 8)
    js, ts = _run_pair(jstates[0], tstates[0], setup["ctl"], setup["tctl"],
                       setup["clim"], setup["tclim"], setup["met01"],
                       setup["tmet"], jbuild(setup["met01"]), tpack)
    return setup, tpack, js, ts


def test_unfused_one_step(unfused):
    """One unfused step from the same state: the same float32
    operations in the same order on both sides (the packed form
    ``w*(a-b)+b``; z, y, x, time), so the bounds of test_one_step hold
    with room.  Measured: positions, T, m and uvwp equal to the last
    bit or one ulp."""
    setup, tpack, js, ts = unfused
    _compare(js[1], ts[1], atol_pos=6.2e-5, atol_uvwp=5e-4)
    assert float((ts[1][0].lon - ts[0][0].lon).abs().max()) > 1e-3


def test_unfused_ten_steps_with_sort(unfused):
    """Ten unfused steps with a sort before the sixth: ten times the
    one-step bounds, as test_ten_steps_with_sort."""
    setup, tpack, js, ts = unfused
    _compare(js[NSTEPS], ts[NSTEPS], atol_pos=6.2e-4, atol_uvwp=5e-3)
    ta, tc = ts[NSTEPS]
    assert tc.rng_ctr == NSTEPS * 2 * (3 * ta.npmax + 1)


def test_unfused_differs_from_fused_by_design(runs, unfused):
    """The unfused path samples sigma and T after the turbulent
    displacement (the reference's module order), the fused path at the
    advected position: close, not equal."""
    _, _, fused_states = runs
    _, _, _, ts = unfused
    # (a parcel that the turbulent displacement carries into another
    # cell gets that cell's sigma: the median is close, the maximum not)
    d = (fused_states[1][1].uvwp - ts[1][1].uvwp).abs()
    assert float(d.max()) > 0.0 and float(d.median()) < 0.05
    np.testing.assert_allclose(fused_states[1][0].lon.numpy(),
                               ts[1][0].lon.numpy(), rtol=0, atol=2e-2)


def test_unfused_step_against_pallas_slab_kernels(unfused):
    """One step against the JAX step on the slab kernels themselves
    (``lane=True``, interpret mode).  That step cannot be the yardstick
    for every parcel: its kernels' cyclic unwrap serves a few percent
    of 2048 parcels on this grid wrong wind, sigma and T (T comes back
    as 0 K for some), on the flagship's own wind, which varies from
    column to column.  So the share that agrees is asserted (> 95 %)
    and printed; the every-parcel comparison is the one above."""
    setup, tpack, js, ts = unfused
    (atm, cache), (ta, tc) = js[0], ts[1]
    ja, jc = jpipe.run_timestep(
        setup["ctl"], setup["clim"], setup["met01"], atm, cache,
        jnp.asarray(180.0, jnp.float64),
        pack=jbuild(setup["met01"], lane=True))
    assert tc.rng_ctr == int(jc.rng_ctr)
    ok = np.ones(ta.npmax, bool)
    for name in ("lon", "lat", "p"):
        ok &= np.isclose(getattr(ta, name).numpy(),
                         np.asarray(getattr(ja, name)), rtol=0, atol=6.2e-5)
    ok &= np.isclose(ta.q["t"].numpy(), np.asarray(ja.q["t"]), rtol=0,
                     atol=6.2e-5)
    zeros = int((np.asarray(ja.q["t"]) == 0.0).sum())
    print(f"unfused step: the Pallas slab path agrees on {ok.mean():.4f} "
          f"of the parcels; it returns T = 0 for {zeros}")
    assert ok.mean() > 0.95, ok.mean()


@pytest.fixture(scope="module", params=["float32", "float64"])
def exact(request):
    """The exact step (no pack) in both compute modes, both packages
    from one state."""
    import __graft_entry__ as g
    if request.param == "float32":
        ctl, clim, met01, atm, cache = small_flagship_fp32()
    else:
        ctl, clim, met01, atm, cache = g._make_setup(2048, nx=36, ny=19,
                                                     nz=8)
    tatm, tcache, tmet, tclim = to_torch(atm, cache, met01, clim)
    dtype = getattr(torch, request.param)
    tctl, tclim2, tmet2, tatm2, tcache2 = flagship.make_setup(
        atm.npmax, nx=36, ny=19, nz=8, device="cpu", dtype=dtype)
    # the port's own set-up is the converted one in this mode too
    for a, b in ((tatm2.lon, tatm.lon), (tatm2.p, tatm.p),
                 (tmet2.lat, tmet.lat), (tmet2.p, tmet.p),
                 (tclim2.tropo, tclim.tropo), (tcache2.dt, tcache.dt)):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tatm.time.dtype == torch.float64
    assert tmet.fields3d["u"].dtype == torch.float32
    js, ts = _run_pair((atm, cache), (tatm, tcache), ctl, tctl, clim, tclim,
                       met01, tmet, None, None)
    return request.param, js, ts


def _compare_exact(mode, jstate, tstate, steps):
    """float32: the bounds of the fused comparison.  float64: all but
    the normals agrees to rtol 1e-12 a step (float64 arithmetic that
    differs by XLA's multiply-add contraction and by cos, log, exp of
    two math libraries).  The normals do not: the reference's
    Box-Muller takes cos and sin in single precision in this mode too,
    so the two math libraries leave them up to 4 float32 ulp apart
    (5e-7 of an O(1) factor, tests/test_torch_rng.py), times a step's
    random displacement (~1e-2 deg, ~10 hPa): atol 5e-9 on lon and lat
    and 5e-8 on p a step, ten times that over ten steps.  Measured:
    lon 3.1e-10 and p 2.0e-8 after one step, 1.7e-9 and 3.3e-8 after
    ten."""
    (ja, jc), (ta, tc) = jstate, tstate
    assert tc.rng_ctr == int(jc.rng_ctr)
    np.testing.assert_array_equal(ta.time.numpy(), np.asarray(ja.time))
    if mode == "float32":
        _compare(jstate, tstate, atol_pos=6.2e-5 * steps,
                 atol_uvwp=5e-4 * steps)
        return
    rtol = 1e-12 * steps
    for name, atol in (("lon", 5e-9), ("lat", 5e-9), ("p", 5e-8)):
        x = getattr(ta, name)
        assert x.dtype == torch.float64
        d = np.abs(x.numpy() - np.asarray(getattr(ja, name)))
        print(f"float64 exact, {steps} steps, {name}: max abs diff "
              f"{d.max():.3e}")
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(ja, name)),
                                   rtol=rtol, atol=atol * steps,
                                   err_msg=name)
    np.testing.assert_allclose(ta.q["t"].numpy(), np.asarray(ja.q["t"]),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(ta.q["m"].numpy(), np.asarray(ja.q["m"]),
                               rtol=rtol, atol=0)
    # uvwp is stored in float32: one ulp of values up to ~4
    np.testing.assert_allclose(tc.uvwp.numpy(), np.asarray(jc.uvwp),
                               rtol=0, atol=5e-7)
    assert tc.dt.dtype == torch.float64


def test_convert_keeps_float64(exact):
    """``convert.from_reference`` and back: a float64 state and met
    pair cross unchanged in dtype and value (float32 in that mode)."""
    from helpers.torch_bridge import atm_to_numpy, cache_to_numpy
    from mptrac_tpu_torch.convert import to_reference_numpy
    mode, js, ts = exact
    ja, jc = js[2]
    a0, c0 = atm_to_numpy(ja), cache_to_numpy(jc)
    a1, c1 = to_reference_numpy(*to_torch(ja, jc)[:2])
    for k in ("time", "p", "lon", "lat"):
        np.testing.assert_array_equal(a1[k], a0[k])
        assert a1[k].dtype == a0[k].dtype, k
    assert a1["lon"].dtype == np.dtype(mode)
    assert c1["dt"].dtype == np.dtype(mode) == c0["dt"].dtype
    assert c1["uvwp"].dtype == np.float32
    np.testing.assert_array_equal(c1["uvwp"], c0["uvwp"])


def test_exact_one_step(exact):
    mode, js, ts = exact
    _compare_exact(mode, js[1], ts[1], 1)
    assert float((ts[1][0].lon - ts[0][0].lon).abs().max()) > 1e-3


def test_exact_ten_steps_with_sort(exact):
    mode, js, ts = exact
    _compare_exact(mode, js[NSTEPS], ts[NSTEPS], NSTEPS)
    ta, tc = ts[NSTEPS]
    assert tc.rng_ctr == NSTEPS * 2 * (3 * ta.npmax + 1)


# ------------------------- the unfused and the exact path, by module

@pytest.fixture(scope="module")
def mid2(unfused):
    """A mid-run state of the unfused run (after step 3) with dt set
    for the next step, the JAX state taken across."""
    setup, tpack, js, ts = unfused
    ja, jc = js[3]
    ta, tc, _, _ = to_torch(ja, jc)
    t = 180.0 * 4
    jc = jts.module_timesteps(setup["ctl"], jc, setup["met01"], ja,
                              jnp.asarray(t, jnp.float64))
    tc = tts.module_timesteps(setup["tctl"], tc, setup["tmet"], ta, t)
    return setup, tpack, jbuild(setup["met01"]), (ja, jc), (ta, tc)


@pytest.mark.parametrize("branch", ["kernel", "exact"])
@pytest.mark.parametrize("scheme", [1, 2, 4])
def test_advect_plev(mid2, scheme, branch):
    """``_advect_plev`` for Euler, midpoint and RK4, through the wind
    kernel's plain version (against the JAX packed-table branch) and
    through the exact interpolation (against the JAX exact branch): the
    same float32 operations; XLA's eager kernels may contract
    multiply-adds: 2 ulp of a position (3.1e-5 at 180 deg, 1.3e-4 at
    900 hPa).  Measured: equal or one ulp."""
    from mptrac_tpu.physics import advect as jadv
    from mptrac_tpu_torch.physics import advect as tadv
    setup, tpack, jpack, (ja, jc), (ta, tc) = mid2
    ctl = setup["ctl"].replace(advect=scheme)
    tctl = setup["tctl"].replace(advect=scheme)
    kernel = branch == "kernel"
    ej, _ = jadv.module_advect(ctl, jc, setup["met01"], ja,
                               jpack.w64 if kernel else None)
    gt, gc = tadv.module_advect(tctl, tc, setup["tmet"], ta,
                                tpack.packT if kernel else None)
    assert gc is tc
    np.testing.assert_array_equal(gt.time.numpy(), np.asarray(ej.time))
    for name, tol in (("lon", 3.1e-5), ("lat", 3.1e-5), ("p", 1.3e-4)):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(ej, name)), rtol=0,
                                   atol=tol, err_msg=name)
    assert float((gt.lon - ta.lon).abs().max()) > 1e-3
    assert [tadv._rk_weight(tctl, i) for i in range(scheme)] == \
        [jadv._rk_weight(ctl, i) for i in range(scheme)]


@pytest.mark.parametrize("branch", ["kernel", "exact", "table"])
def test_module_diff_meso_unfused(mid2, branch):
    """``module_diff_meso`` without ``sig=``: its own locate, then the
    sigma kernel's plain version (against the JAX packed-table branch),
    gathered from the pack's sigma table (``table``, against the same),
    or the stencil on the met fields (against the JAX exact branch).
    The sums run in the same order in float32; bounds of
    test_module_diff_meso."""
    setup, tpack, jpack, (ja, jc), (ta, tc) = mid2
    kernel = branch != "exact"
    ej, ejc = jdiff.module_diff_meso(setup["ctl"], jc, setup["met01"], ja,
                                     jpack.w64 if kernel else None)
    gt, gtc = tdiff.module_diff_meso(
        setup["tctl"], tc, setup["tmet"], ta,
        tpack.packT if kernel else None,
        sigT=tpack.sigT if branch == "table" else None)
    assert gtc.rng_ctr == int(ejc.rng_ctr)
    np.testing.assert_allclose(gtc.uvwp.numpy(), np.asarray(ejc.uvwp),
                               rtol=0, atol=1e-5)
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(ej, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert float((gtc.uvwp - tc.uvwp).abs().max()) > 1e-3


def test_unfused_step_reads_the_sigma_table(mid2):
    """The unfused step takes the sigma from the pack's table: a table
    planted with NaN gives NaN sigmas, so NaN winds, in
    ``module_diff_meso`` (every active parcel) and in the step that
    hands the pack to it; the pack's own table gives finite ones."""
    setup, tpack, jpack, (ja, jc), (ta, tc) = mid2
    nan = tpack._replace(sigT=torch.full_like(tpack.sigT, float("nan")))
    args = (setup["tctl"], tc, setup["tmet"], ta, tpack.packT)
    _, gc = tdiff.module_diff_meso(*args, sigT=nan.sigT)
    _, ok = tdiff.module_diff_meso(*args, sigT=tpack.sigT)
    active = (tc.dt != 0.0) & ta.mask
    assert int(active.sum()) > 0
    assert bool(torch.isnan(gc.uvwp[:, active]).all())
    assert bool(torch.isfinite(ok.uvwp).all())
    step = (setup["tctl"], setup["tclim"], setup["tmet"], ta, tc, 180.0 * 4)
    _, sc = tpipe.run_timestep(*step, pack=nan)
    assert int(torch.isnan(sc.uvwp[0]).sum()) == int(active.sum())
    _, sc = tpipe.run_timestep(*step, pack=tpack)
    assert bool(torch.isfinite(sc.uvwp).all())


def test_module_diff_meso_locates_on_the_raw_position(mid2):
    """The module locates with ``locate_reg``/``locate_irr`` on the raw
    position, without the longitude wrap of ``locate_3d``: a parcel at
    lon + 360 is put into the last longitude cell, not into the cell of
    lon.  Both branches of the port follow the JAX module there."""
    setup, tpack, jpack, (ja, jc), (ta, tc) = mid2
    n = ja.npmax
    shift = np.where(np.arange(n) % 2 == 0, 360.0, 0.0).astype(np.float32)
    ja2 = ja.replace(lon=ja.lon + jnp.asarray(shift))
    ta2 = ta.replace(lon=ta.lon + torch.from_numpy(shift))
    ej, ejc = jdiff.module_diff_meso(setup["ctl"], jc, setup["met01"], ja2)
    for packT in (None, tpack.packT):
        gt, gtc = tdiff.module_diff_meso(setup["tctl"], tc, setup["tmet"],
                                         ta2, packT)
        np.testing.assert_allclose(gtc.uvwp.numpy(), np.asarray(ejc.uvwp),
                                   rtol=0, atol=1e-5)
    # and that is another sigma than the wrapped position's
    _, base = tdiff.module_diff_meso(setup["tctl"], tc, setup["tmet"], ta)
    moved = (gtc.uvwp - base.uvwp).abs().amax(dim=0).numpy()
    assert (moved[shift > 0] > 1e-4).mean() > 0.5
    assert (moved[shift == 0] == 0).all()


METEO_QNT = ("t", "m", "u", "v", "w", "zg", "theta", "rho", "vh", "vz",
             "rh", "zeta_d", "ps", "h2o", "p", "lapse", "tdew", "pbl")


@pytest.mark.parametrize("branch", ["kernel", "exact"])
def test_module_meteo_quantities(mid2, branch):
    """``module_meteo`` for straight 3-D samplings, derived quantities
    and surface fields on a met pair with water vapour.  Exact branch:
    the same operations on both sides.  Kernel branch: the port takes
    u, v, w, T from the wind kernel and the JAX module (TPU_FAST 1)
    takes T from its packed table and u, v, w from the exact
    interpolation; the two forms differ in the order of space and time
    (tests/test_slab_interp.py:58: rtol 3e-6, atol 2e-5).  The derived
    quantities pass that on through log, exp and pow of two math
    libraries: rtol 1e-5 (atol 2e-5; rh in percent 2e-3)."""
    from mptrac_tpu.physics import meteo as jmeteo
    from mptrac_tpu_torch.physics import meteo as tmeteo
    setup, tpack, jpack, (ja, jc), (ta, tc) = mid2
    rng = np.random.default_rng(31)
    met01 = setup["met01"]
    f3 = dict(met01.fields3d)
    h2o = rng.uniform(1e-4, 4e-3, f3["h2o"].shape).astype(np.float32)
    h2o[:, -1] = h2o[:, 0]
    f3["h2o"] = jnp.asarray(h2o)
    met01 = met01.replace(fields3d=f3)
    _, _, tmet, _ = to_torch(met01=met01)
    ctl = setup["ctl"].replace(qnt_name=METEO_QNT)
    tctl = setup["tctl"].replace(qnt_name=METEO_QNT)
    kernel = branch == "kernel"
    ej = jmeteo.module_meteo(ctl, jc, setup["clim"], met01, ja,
                             jpack if kernel else None)
    gt = tmeteo.module_meteo(tctl, tc, setup["tclim"], tmet, ta,
                             tpack if kernel else None)
    assert set(gt.q) == set(ej.q)
    for name in METEO_QNT:
        if name == "m":
            continue
        g, e = gt.q[name].numpy(), np.asarray(ej.q[name])
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, e, rtol=1e-5, atol=2e-3 if name == "rh" else 2e-5,
            err_msg=name)
    assert float(gt.q["rh"].max()) > 1.0 and float(gt.q["vh"].min()) > 0
    assert float(gt.q["theta"].min()) > 280.0


def test_build_pack_follows_tpu_fast(runs):
    """``sim.build_pack``: TPU_FAST 0 no tables (the exact path),
    TPU_FAST 1 the unfused kernels' tables, TPU_FAST 2 with SORT_DT the
    fused kernel's, TPU_FAST 2 without SORT_DT the unfused ones again,
    as the JAX ``Simulation._get_pack`` chooses."""
    from mptrac_tpu_torch.sim import build_pack
    setup, _, _ = runs
    tctl, tmet = setup["tctl"], setup["tmet"]
    assert tctl.tpu_fast == 0 and build_pack(tctl, tmet) is None
    p1 = build_pack(tctl.replace(tpu_fast=1, sort_dt=900.0), tmet)
    assert p1.cell is None and p1.packT is not None and p1.sfcT is not None
    p2 = build_pack(tctl.replace(tpu_fast=2, sort_dt=900.0), tmet)
    assert p2.cell is not None and p2.packT is None and p2.sfcT is not None
    p3 = build_pack(tctl.replace(tpu_fast=2, sort_dt=0.0), tmet)
    assert p3.cell is None and p3.packT is not None
    np.testing.assert_array_equal(p1.packT.numpy(), p2.cell.table.numpy())


@pytest.mark.parametrize("diffusion, mesox, mesoz, built", [
    (1, 0.16, 0.16, True), (1, 0.16, 0.0, True), (1, 0.0, 0.16, True),
    (1, 0.0, 0.0, False), (0, 0.16, 0.16, False)])
def test_build_pack_builds_the_sigma_table_for_meso_only(runs, diffusion,
                                                         mesox, mesoz,
                                                         built):
    """``sim.build_pack`` builds the unfused pack's sigma table only
    where ``module_diff_meso`` runs (DIFFUSION and TURB_MESOX or
    TURB_MESOZ); otherwise the pack carries ``sigT=None``."""
    from mptrac_tpu_torch.sim import build_pack
    setup, _, _ = runs
    ctl = setup["tctl"].replace(tpu_fast=1, diffusion=diffusion,
                                turb_mesox=mesox, turb_mesoz=mesoz)
    pack = build_pack(ctl, setup["tmet"])
    assert pack.packT is not None
    assert (pack.sigT is not None) == built


def test_build_met_pack_carries_the_sigma_table(runs):
    """``build_met_pack(cell=False)`` builds the sigma table of its wind
    table, equal to the plain table cell for cell; the fused pack
    (``cell=True``) carries none."""
    from mptrac_tpu_torch.ops import slab_interp as tsl
    setup, _, _ = runs
    p1 = tbuild(setup["tmet"], cell=False)
    assert torch.equal(p1.sigT, tsl.sigma_table_plain(p1.packT))
    assert tbuild(setup["tmet"], cell=True).sigT is None
    assert tbuild(setup["tmet"], cell=False, sigma=False).sigT is None


def _small_pair():
    return flagship.make_setup(16, nx=12, ny=7, nz=5, device="cpu")[2]


@pytest.mark.parametrize("axis", ["lat", "p"])
@pytest.mark.parametrize("flip", [False, True])
def test_build_cell_pack_accepts_monotonic_axes(axis, flip):
    """An ascending and a descending latitude or pressure axis: the pack
    records the direction that the kernel's binary search reads."""
    import dataclasses

    from mptrac_tpu_torch.ops import rk_fused
    met = _small_pair()
    ax = getattr(met, axis)
    if flip:
        met = dataclasses.replace(met, **{axis: ax.flip(-1)})
    pack = rk_fused.build_cell_pack(met)
    up = bool(getattr(met, axis)[0, 1] > getattr(met, axis)[0, 0])
    assert (pack.lat_asc if axis == "lat" else pack.p_asc) == up


@pytest.mark.parametrize("axis,name", [("lat", "latitude"),
                                       ("p", "pressure")])
@pytest.mark.parametrize("fault", ["repeat", "turn", "nan"])
def test_build_cell_pack_raises_on_a_non_monotonic_axis(axis, name, fault):
    """The kernel's binary search equals the JAX compare-count only on a
    strictly monotonic axis: any other axis is refused by name (a
    deliberate difference from the JAX package, ROADMAP section 3)."""
    import dataclasses

    from mptrac_tpu_torch.ops import rk_fused
    met = _small_pair()
    ax = getattr(met, axis).clone()
    if fault == "repeat":
        ax[:, 2] = ax[:, 1]
    elif fault == "turn":
        ax[:, [1, 2]] = ax[:, [2, 1]]
    else:
        ax[:, 3] = float("nan")
    with pytest.raises(ValueError, match=f"{name} axis .* not strictly "
                       "monotonic"):
        rk_fused.build_cell_pack(dataclasses.replace(met, **{axis: ax}))


def test_rk_errors_by_latitude_band_on_the_cpu(capsys):
    """perf/rk_errors on the CPU: both sides are the plain version, so
    every band holds parcels and every difference is 0."""
    import json

    from mptrac_tpu_torch.perf import rk_errors
    assert rk_errors.main(["--n", "500", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["nstage"] for x in lines] == [1, 2, 4]
    for x in lines:
        assert set(x["bands"]) == {f"{lo:g}-{hi:g}"
                                   for lo, hi in rk_errors.BANDS}
        for band in x["bands"].values():
            assert band.pop("parcels") > 0
            assert set(band.values()) == {0.0}


def test_pack_is_ignored_in_float64():
    """The kernels compute in float32: with a float64 state a pack is
    left aside and the exact path runs (as in the JAX pipeline)."""
    tctl, tclim, tmet, tatm, tcache = flagship.make_setup(
        256, nx=36, ny=19, nz=8, device="cpu", dtype=torch.float64)
    outs = [tpipe.run_timestep(tctl, tclim, tmet, tatm, tcache, 180.0,
                               pack=pack)
            for pack in (None, tbuild(tmet, cell=False),
                         tbuild(tmet, cell=True))]
    for a, c in outs[1:]:
        np.testing.assert_array_equal(a.lon.numpy(), outs[0][0].lon.numpy())
        np.testing.assert_array_equal(a.q["t"].numpy(),
                                      outs[0][0].q["t"].numpy())
        np.testing.assert_array_equal(c.uvwp.numpy(),
                                      outs[0][1].uvwp.numpy())
    assert outs[0][0].lon.dtype == torch.float64


@pytest.mark.parametrize("fast", ["0", "1"])
def test_humid_setup_samples_humidity(fast):
    """``make_setup(q=...)`` gives the met a uniform water vapour mixing
    ratio, and a step on it samples rh and sh of that ratio at the
    parcels' p and T (rtol 1e-5: the interpolation of a constant is
    exact to an ulp)."""
    from mptrac_tpu_torch.ops import thermo
    from mptrac_tpu_torch.sim import build_pack
    q = 4e-3
    tctl, tclim, tmet, tatm, tcache = flagship.make_setup(
        256, nx=36, ny=19, nz=8, device="cpu", q=q, extra_args=(
            "TPU_FAST", fast, "NQ", "4", "QNT_NAME[2]", "rh",
            "QNT_NAME[3]", "sh"))
    h = tmet.fields3d["h2o"]
    assert float(h.min()) == float(h.max()) == np.float32(q)
    a, _ = tpipe.run_timestep(tctl, tclim, tmet, tatm, tcache, 180.0,
                              pack=build_pack(tctl, tmet))
    h2o = torch.full_like(a.p, q)
    np.testing.assert_allclose(a.q["rh"].numpy(),
                               thermo.rh(a.p, a.q["t"], h2o).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(a.q["sh"].numpy(), thermo.sh(h2o).numpy(),
                               rtol=1e-5)
    assert float(a.q["rh"].min()) > 1.0
