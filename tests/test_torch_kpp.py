"""KPP full chemistry of the port against the JAX package: the
mechanism tables, the rate constants, one Rodas3 step, the adaptive
integration (on the exponential decay of tests/test_kpp.py) and
``module_kpp_chem`` on the state of tests/test_kpp.py at 64 parcels.

Tolerances, in float64:
- the tables and the coefficients: equal;
- the rate constants: rtol 1e-12 (pow, exp and log10 of two math
  libraries; measured 1.9e-15);
- one Rodas3 step: rtol 1e-11 on the concentrations and the error
  norm.  The step solves (I / (h gamma) - J) k = f on the stiff HOx
  system, so the ulps of the two LU factorisations (LAPACK's getrf
  through PyTorch and through jaxlib) and of the two Jacobians (the
  analytic one here, ``jax.jacfwd`` there) grow with h: measured 1.1e-14
  at h = 6e-4 s, 2.3e-13 at h = 60 s;
- the integration and the module: rtol 1e-5 on the concentrations
  (with ``ATOL_VMR``), ``m`` and ``Cx`` (and ``mloss_kpp`` at atol
  1e-9 of the unit mass).  Several hundred accepted and rejected steps a
  parcel (up to the 1000 of ``max_steps``) carry the step's differences
  on through the step-size control: measured 1.8e-6 in HO2, 1.4e-10 in
  SO2 and the mass.

A pass of parcels gives each parcel the same result as one pass of all
(bit for bit) in passes of any multiple of 16 parcels: PyTorch's CPU loops
evaluate exp, log and pow with vector code in blocks of 16 doubles and
with scalar code in a pass's remainder, which round differently.
"""

import os

os.environ.setdefault("LOGLEV", "0")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import to_torch
from mptrac_tpu.climatology import read_clim as jread_clim
from mptrac_tpu.config import read_ctl as jread_ctl
from mptrac_tpu.met.synthetic import make_wind_met as jwind
from mptrac_tpu.physics import kpp as jkpp
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu.types import Cache as JCache
from mptrac_tpu.types import astype_state as jastype
from mptrac_tpu.types import stack_met as jstack
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.physics import kpp as tkpp

N = 64
#: the solver's error norm scales each species by 1 + 1e-3 |c| molecules
#: per cm^3, so concentrations below ~1 molecule/cm^3 (a mixing ratio
#: of ~1e-18 at these pressures) are not resolved: mixing ratios of
#: O(3P), O(1D) and H of O(1e-24) differ by 50 % and more between the two
#: packages.  Mixing ratios are held at this absolute tolerance.
ATOL_VMR = 1e-18


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batches of a few hundred parcels at most: more intra-op threads
    would only spin, on the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ARGS = ["NQ", "9", "QNT_NAME[0]", "m", "QNT_NAME[1]", "Cx",
        "QNT_NAME[2]", "Coh", "QNT_NAME[3]", "Cho2",
        "QNT_NAME[4]", "Ch2o2", "QNT_NAME[5]", "mloss_kpp",
        "QNT_NAME[6]", "Co3p", "QNT_NAME[7]", "Co1d", "QNT_NAME[8]", "Ch",
        "METBASE", "-", "KPP_CHEM", "1", "DT_KPP", "600",
        "SPECIES", "SO2", "T_STOP", "3600"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(got - want) / np.abs(want)
    return float(np.nanmax(np.where(got == want, 0.0, rel)))


@pytest.fixture(scope="module")
def case():
    """The state of tests/test_kpp.py (daytime, 50-300 hPa, SO2 and HOx
    set) at 64 parcels, with O3P, O1D and H as quantities; 4 parcels
    dead, 4 with dt = 0."""
    jctl, tctl = jread_ctl(None, ARGS), tread_ctl(None, ARGS)
    jclim = jread_clim(jctl)
    met01 = jstack(
        jwind(nx=36, ny=19, nz=8, q=5e-6, o3=2e-6),
        jwind(t0=86400.0, nx=36, ny=19, nz=8, q=5e-6, o3=2e-6))
    rng = np.random.default_rng(1)
    atm = JAtm.zeros(N, jctl.qnt_name).replace(
        time=jnp.full(N, 6 * 3600.0),
        lon=jnp.asarray(rng.uniform(-30, 30, N)),
        lat=jnp.asarray(rng.uniform(-30, 30, N)),
        p=jnp.asarray(rng.uniform(50, 300, N)),
        np=jnp.asarray(N - 4, jnp.int32))
    q = dict(atm.q)
    q["m"] = jnp.ones(N)
    q["Cx"] = jnp.asarray(10.0 ** rng.uniform(-10, -8, N))
    q["Coh"] = jnp.full(N, 1e-13)
    q["Cho2"] = jnp.full(N, 1e-12)
    q["Ch2o2"] = jnp.full(N, 1e-10)
    atm = atm.replace(q=q)
    dt = np.full(N, 600.0)
    dt[rng.choice(N - 4, 4, replace=False)] = 0.0
    cache = JCache.zeros(N).replace(dt=jnp.asarray(dt))
    out = jax.jit(lambda a: jkpp.module_kpp_chem(jctl, cache, jclim,
                                                 met01, a))(atm)
    tatm, tcache, tmet, tclim = to_torch(atm, cache, met01, jclim)
    return dict(jctl=jctl, tctl=tctl, jclim=jclim, jmet=met01, jatm=atm,
                jcache=cache, jout=out, tatm=tatm, tcache=tcache, tmet=tmet,
                tclim=tclim)


def test_mechanism_tables_equal():
    m = tkpp.mechanism()
    assert (tkpp.NVAR, tkpp.NREACT) == (jkpp.NVAR, jkpp.NREACT) == (15, 39)
    assert list(m.var_species) == jkpp.VAR_SPECIES
    assert list(m.fix_species) == jkpp.FIX_SPECIES == ["o2", "h2", "n2"]
    for name in ("react_v", "react_f", "net_v"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(jkpp, name.upper())))
    assert tkpp.SPECIES_QNT == jkpp.SPECIES_QNT
    assert (np.asarray(tkpp._ALPHA) == jkpp._ALPHA).all()
    assert (np.asarray(tkpp._C) == jkpp._C).all()
    assert (np.asarray(tkpp._M) == jkpp._M).all()
    assert (np.asarray(tkpp._E) == jkpp._E).all()
    assert tkpp._GAMMA == jkpp._GAMMA


def test_rate_constants(case):
    """All 39 constants, with cloud water for the aqueous SO2 + H2O2
    reaction and solar zenith angles across the photolysis table."""
    rng = np.random.default_rng(2)
    t = rng.uniform(190.0, 300.0, N)
    p = rng.uniform(5.0, 1000.0, N)
    M = 7.243e18 * p / t
    sza = rng.uniform(0.0, 1.8, N)
    o3c = rng.uniform(200.0, 450.0, N)
    lwc = rng.uniform(0.0, 3e-4, N)
    want = np.asarray(jkpp.rate_constants(
        case["jclim"], *(jnp.asarray(a) for a in (t, M, p, sza, o3c, lwc))))
    got = tkpp.rate_constants(
        case["tclim"], *(torch.tensor(a) for a in (t, M, p, sza, o3c, lwc)))
    assert tuple(got.shape) == (N, 39) and got.dtype == torch.float64
    assert (want[:, 29:37] > 0).any() and (want[:, 37] > 0).all()
    print(f"rate constants: max rel diff {_rel(got.numpy(), want):.2e}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def _start(case):
    """The module's concentrations, fixed species and rate constants of
    the case's parcels (the port's, held to the JAX module's by the
    module test)."""
    got = {}

    def grab(c0, fix, rconst, dt):
        got.update(c0=c0, fix=fix, rconst=rconst)
        return c0, torch.zeros(c0.shape[0], dtype=torch.int32)

    orig = tkpp.integrate
    tkpp.integrate = grab
    try:
        tkpp.module_kpp_chem(case["tctl"], case["tcache"], case["tclim"],
                             case["tmet"], case["tatm"])
    finally:
        tkpp.integrate = orig
    return got["c0"], got["fix"], got["rconst"]


@pytest.mark.parametrize("h", [6e-4, 1.0, 60.0])
def test_one_rodas3_step(case, h):
    c0, fix, rconst = _start(case)
    cj, ej = jax.vmap(jkpp._rosenbrock_step, in_axes=(0, 0, 0, None))(
        jnp.asarray(c0.numpy()), jnp.asarray(fix.numpy()),
        jnp.asarray(rconst.numpy()), h)
    ct, et = tkpp.rosenbrock_step(c0, fix, rconst,
                                  torch.full((N,), h, dtype=torch.float64))
    print(f"step h={h}: c {_rel(ct.numpy(), cj):.2e}, "
          f"err {_rel(et.numpy(), ej):.2e}")
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-11,
                               atol=0)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-11,
                               atol=0)


def test_integrate_exponential_decay():
    """With a single first-order loss the solver reproduces exp(-k t)
    (tests/test_kpp.py:32), and the JAX package's integration."""
    i = jkpp.VAR_SPECIES.index("ccl3f")
    c0 = np.zeros(15)
    c0[i] = 1e9
    rconst = np.zeros(39)
    rconst[35] = 1e-4
    want = np.asarray(jkpp.integrate(jnp.asarray(c0), jnp.zeros(3),
                                     jnp.asarray(rconst), 3600.0))
    got, steps = tkpp.integrate(torch.tensor(c0)[None], torch.zeros(1, 3,
                                dtype=torch.float64),
                                torch.tensor(rconst)[None], 3600.0)
    expected = 1e9 * np.exp(-1e-4 * 3600.0)
    assert abs(float(got[0, i]) - expected) / expected < 1e-3
    assert 1 < int(steps[0]) < 1000
    print(f"decay: {_rel(got[0].numpy(), want):.2e} in {int(steps[0])} "
          "steps")
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-12, atol=0)


def test_module_kpp_chem(case):
    """The module at 64 parcels, 600 s, against the JAX module."""
    stats = {}
    out = tkpp.module_kpp_chem(case["tctl"], case["tcache"], case["tclim"],
                               case["tmet"], case["tatm"], stats=stats)
    jout = case["jout"]
    print(stats)
    assert stats["steps_max"] > stats["steps_mean"] > 1
    for name in ("m", "Cx", "Coh", "Cho2", "Ch2o2", "Co3p", "Co1d", "Ch"):
        print(f"kpp {name}: max rel diff "
              f"{_rel(out.q[name].numpy(), jout.q[name]):.2e}")
        np.testing.assert_allclose(out.q[name].numpy(),
                                   np.asarray(jout.q[name]), rtol=1e-5,
                                   atol=ATOL_VMR, err_msg=name)
    np.testing.assert_allclose(out.q["mloss_kpp"].numpy(),
                               np.asarray(jout.q["mloss_kpp"]), rtol=1e-5,
                               atol=1e-9)
    ta = case["tatm"]
    still = (case["tcache"].dt == 0) | ~ta.mask
    for name in ta.q:
        assert torch.equal(out.q[name][still], ta.q[name][still]), name
    assert bool((out.q["Cx"] <= ta.q["Cx"]).all())
    assert not torch.equal(out.q["Coh"], ta.q["Coh"])
    # the input state is left as it was
    assert float(ta.q["mloss_kpp"].abs().max()) == 0.0


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunks_equal_one_pass(case, chunk, monkeypatch):
    whole = tkpp.module_kpp_chem(case["tctl"], case["tcache"],
                                 case["tclim"], case["tmet"], case["tatm"])
    monkeypatch.setattr(tkpp, "KPP_CHUNK", chunk)
    part = tkpp.module_kpp_chem(case["tctl"], case["tcache"],
                                case["tclim"], case["tmet"], case["tatm"])
    for name in whole.q:
        assert torch.equal(part.q[name], whole.q[name]), name


def test_float32_state_runs_in_float64(case):
    """On a float32 state the JAX module stops (its float64 tables
    promote the ``while_loop`` carry); the port integrates in float64
    and writes back in float32, within float32 rounding of the met
    sampling of its float64 run."""
    ja, jc, jm = jastype(case["jatm"], case["jcache"], case["jmet"])
    with pytest.raises(TypeError, match="while_loop"):
        jkpp.module_kpp_chem(case["jctl"], jc, case["jclim"], jm, ja)
    ta, tc, tm, _ = to_torch(ja, jc, jm)
    out = tkpp.module_kpp_chem(case["tctl"], tc, case["tclim"], tm, ta)
    ref = tkpp.module_kpp_chem(case["tctl"], case["tcache"], case["tclim"],
                               case["tmet"], case["tatm"])
    for name in ("m", "Cx", "Coh", "Cho2", "Ch2o2"):
        assert out.q[name].dtype == torch.float32
        np.testing.assert_allclose(out.q[name].numpy(),
                                   ref.q[name].numpy(), rtol=1e-3,
                                   err_msg=name)


def test_run_trac_runs_kpp_every_other_step(tmp_path, monkeypatch):
    """``KPP_CHEM 1`` with ``DT_KPP = 2 DT_MOD`` through ``run_trac`` on
    the files of tests/test_torch_trac.py's case (five steps of 120 s
    from a start time that is a multiple of 240 s, SO2 and OH among the
    quantities): the port calls the module on the steps whose time is a
    multiple of DT_KPP, three of five, as the JAX package's step flags
    do, and both packages end at the module test's tolerances."""
    from test_torch_trac import QNT, T0, _particles_with, make_case

    from mptrac_tpu.sim import run_trac as jrun_trac
    from mptrac_tpu_torch.physics import pipeline as tpipe
    from mptrac_tpu_torch.sim import run_trac as trun_trac
    run = ("KPP_CHEM", "1", "DT_KPP", "240", "SPECIES", "SO2",
           "QNT_NAME[9]", "Cx", "QNT_NAME[10]", "Coh", "ATM_BASENAME", "-",
           "T_STOP", f"{T0 + 480.0:.2f}")
    jdir = make_case(tmp_path / "jax", meso=False)
    tdir = make_case(tmp_path / "torch", meso=False)
    for d in (jdir, tdir):
        _particles_with(d, {9: 1e-9, 10: 1e-13})
    calls = []
    orig = tpipe.m_kpp.module_kpp_chem

    def counted(ctl, cache, clim, met01, atm):
        calls.append(float(atm.time[0]))
        return orig(ctl, cache, clim, met01, atm)

    monkeypatch.setattr(tpipe.m_kpp, "module_kpp_chem", counted)
    jsim = jrun_trac(jdir, "trac.ctl", "atm_in.tab", list(run))
    tsim = trun_trac(tdir, "trac.ctl", "atm_in.tab", run, device="cpu")
    assert tsim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 5
    assert calls == [T0, T0 + 240.0, T0 + 480.0]
    steps = [T0 + 120.0 * k for k in range(5)]
    flags = [jsim._flags(t).do_kpp for t in steps]
    assert flags == [tsim._flags(t).do_kpp for t in steps] == [
        True, False, True, False, True]
    ja, ta = jsim.atm, tsim.atm
    assert len(ta.q) == len(QNT)
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), rtol=1e-9)
    for name in ("m", "Cx", "Coh"):
        np.testing.assert_allclose(ta.q[name].numpy(), np.asarray(ja.q[name]),
                                   rtol=1e-5, atol=ATOL_VMR, err_msg=name)
    assert not torch.equal(ta.q["Coh"], torch.full_like(ta.q["Coh"], 1e-13))
