"""The physics that no golden set switches on, module by module, against
the JAX package: the PBL scheme (``TURB_PBL_SCHEME 1``), sedimentation,
the isosurface constraint (``ISOSURF`` 1-4, mode 4 with a balloon file)
and radioactive decay.

Both packages get the same state, made with numpy from a seed, on the
synthetic wind met pair with a boundary layer, surface stresses, heat
flux, temperature and humidity planted from the same seed (the synthetic
met holds zero stress and heat flux, where the PBL scheme sees only the
neutral regime).  Some parcels are dead (beyond ``np``), some have
``dt = 0``.  The PBL scheme's normals are one numpy draw handed to both
packages (tests/test_torch_rng.py holds the generators).

Tolerance in float64: rtol 1e-12, atol 0.  The two sides do the same
float64 operations in the same order and differ by the math libraries'
exp, log, pow and sqrt (an ulp or two); measured at most 1.6e-15 (printed
by each test).  In float32 (the kernels' compute mode) the same
libraries differ by float32 ulps: the PBL scheme's positions to rtol
1e-5 (measured 3.7e-7) and its perturbations to rtol 1e-4 with atol
1e-6 m/s (they are sums of terms that cancel; measured 8.6e-4 relative
on a value near 0), the sedimentation and the isosurface to 1e-6
(measured 8.5e-7), the decay to 2e-7 (measured 0).
"""

import os

os.environ.setdefault("LOGLEV", "0")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import met_to_numpy, to_torch
from mptrac_tpu.config import read_ctl as jread_ctl
from mptrac_tpu.met.synthetic import make_wind_met as jwind
from mptrac_tpu.physics import decay as jdecay
from mptrac_tpu.physics import isosurf as jiso
from mptrac_tpu.physics import pbl as jpbl
from mptrac_tpu.physics import sedi as jsedi
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu.types import Cache as JCache
from mptrac_tpu.types import astype_state as jastype
from mptrac_tpu.types import stack_met as jstack
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.physics import decay as tdecay
from mptrac_tpu_torch.physics import isosurf as tiso
from mptrac_tpu_torch.physics import pbl as tpbl
from mptrac_tpu_torch.physics import sedi as tsedi

NPMAX = 1200
NP = 1150                      # live parcels; the rest are padding
T0 = 360547200.0 + 1800.0      # 2011-06-05 00:30 UTC
DT_MOD = 180.0
QNT = ("t", "m", "rp", "rhop", "Arn222", "Apb210", "Abe7", "Acs137",
       "Ai131", "Axe133")
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batches of a few hundred parcels at most: more intra-op threads
    would only spin, on the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plant_pbl_met(jmet, rng):
    """The JAX met pair with a boundary layer 0.3-2.5 km deep, surface
    stresses 0.01-0.5 N/m^2, sensible heat flux -300..300 W/m^2 (both
    signs: unstable and stable), temperature 230-300 K, humidity
    1e-4..2e-2, and CAPE, CIN and an equilibrium level at 150-500 hPa
    planted from ``rng``."""
    d = met_to_numpy(jmet)
    f2, f3 = dict(d["fields2d"]), dict(d["fields3d"])
    s2, s3 = f2["ps"].shape, f3["t"].shape

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    f2["ps"] = u(960.0, 1030.0, s2)
    depth = u(0.3, 2.5, s2)
    f2["pbl"] = (f2["ps"] * np.exp(-depth / 7.0)).astype(np.float32)
    f2["ess"] = u(0.01, 0.5, s2)
    f2["nss"] = u(0.01, 0.5, s2)
    # a few calm, flux-free columns: the neutral regime of |shf| <= 1e-6
    shf = u(-300.0, 300.0, s2)
    shf[rng.random(s2) < 0.1] = 0.0
    f2["shf"] = shf
    f3["t"] = u(230.0, 300.0, s3)
    f3["h2o"] = u(1e-4, 2e-2, s3)
    # convection up to an equilibrium level in the troposphere (the
    # synthetic met has none: convection would lift to the model top)
    f2["cape"] = u(0.0, 2000.0, s2)
    f2["cin"] = u(0.0, 300.0, s2)
    f2["pel"] = u(150.0, 500.0, s2)
    return jmet.replace(
        fields2d={k: jnp.asarray(v) for k, v in f2.items()},
        fields3d={k: jnp.asarray(v) for k, v in f3.items()})


def _args(extra=()):
    args = ["NQ", str(len(QNT))]
    for i, name in enumerate(QNT):
        args += [f"QNT_NAME[{i}]", name]
    return args + ["METBASE", "-", "DT_MOD", str(DT_MOD), "DIFFUSION", "1",
                   "TURB_PBL_SCHEME", "1", "RADIO_DECAY", "1"] + list(extra)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(21)
    balloon = tmp_path_factory.mktemp("balloon") / "balloon.tab"
    bt = T0 + np.sort(rng.uniform(-400.0, 400.0, 12))
    with open(balloon, "w") as f:
        f.write("# time [s]  pressure [hPa]\n")
        for t, p in zip(bt, rng.uniform(50.0, 300.0, 12)):
            f.write(f"{t:.3f} {p:.6f} extra\n")
        f.write("not a number\n")
    args = _args(["BALLOON", str(balloon)])
    jctl, tctl = jread_ctl(None, args), tread_ctl(None, args)
    met01 = jstack(jwind(t0=T0 - 1800.0, nx=36, ny=19, nz=8, alpha=30.0),
                   jwind(t0=T0 + 1800.0, nx=36, ny=19, nz=8, alpha=30.0))
    jmet = plant_pbl_met(met01, rng)

    def u(lo, hi):
        return rng.uniform(lo, hi, NPMAX)

    q = {name: u(0.5, 2.0) for name in QNT}
    q.update(rp=u(0.5, 20.0), rhop=u(800.0, 2600.0))
    # most parcels in the lowest 3 km (inside and just above the PBL),
    # some in the free troposphere and stratosphere
    p = np.where(rng.random(NPMAX) < 0.85, u(700.0, 1030.0), u(20.0, 700.0))
    time = T0 + rng.choice([0.0, 0.0, 0.0, 45.0, -500.0, 600.0], NPMAX)
    jatm = JAtm(time=jnp.asarray(time), p=jnp.asarray(p),
                lon=jnp.asarray(u(-180.0, 180.0)),
                lat=jnp.asarray(u(-85.0, 85.0)),
                q={k: jnp.asarray(v) for k, v in q.items()},
                np=jnp.asarray(NP, jnp.int32))
    dt = rng.choice([DT_MOD, DT_MOD, DT_MOD, -DT_MOD, 0.0], NPMAX)
    uvwp = rng.normal(0.0, 0.5, (3, NPMAX)).astype(np.float32)
    jcache = JCache.zeros(NPMAX).replace(
        dt=jnp.asarray(dt), uvwp=jnp.asarray(uvwp),
        rng_ctr=jnp.asarray(777, jnp.uint64))
    normals = rng.normal(size=(3, NPMAX))
    return dict(jctl=jctl, tctl=tctl, jmet=jmet, jatm=jatm, jcache=jcache,
                normals=normals)


def _state(case, dtype):
    """(jatm, jcache, jmet, tatm, tcache, tmet) in ``dtype``."""
    ja, jc, jm = case["jatm"], case["jcache"], case["jmet"]
    if dtype == "float32":
        ja, jc, jm = jastype(ja, jc, jm)
    ta, tc, tm, _ = to_torch(ja, jc, jm)
    return ja, jc, jm, ta, tc, tm


def _close(tag, got, want, rtol=RTOL, atol=0.0):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(got - want) / np.abs(want)
    rel = np.where(got == want, 0.0, rel)
    print(f"{tag}: max rel diff {np.nanmax(rel):.2e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=tag)


@pytest.fixture
def same_normals(case, monkeypatch):
    """Both packages' PBL scheme draw ``case["normals"]`` (in the
    state's dtype) and advance the counter by 3n + 1."""
    z = case["normals"]

    def jdraw(rng_type, ctr, n, dtype=jnp.float64, key=None):
        return jnp.asarray(z[:, :n], dtype), ctr + jnp.uint64(3 * n + 1)

    def tdraw(rng_type, ctr, n, dtype=torch.float64, device="cuda",
              part=None):
        assert part is None          # (a whole state, no shard's slice)
        return (torch.tensor(z[:, :n], dtype=dtype, device=device),
                ctr + 3 * n + 1)

    monkeypatch.setattr(jpbl, "module_rng3", jdraw)
    monkeypatch.setattr(tpbl, "module_rng3", tdraw)


#: float32 tolerances (rtol) of the PBL scheme's outputs
PBL_RTOL32 = dict(lon=1e-5, lat=1e-5, p=1e-5, uvwp=1e-4)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("chunk", [1 << 23, 96])
def test_module_diff_pbl(case, same_normals, dtype, chunk, monkeypatch):
    """One step of the PBL scheme: positions and AR(1) perturbations.
    The port runs the scheme in passes of ``PBL_CHUNK`` parcels; a pass
    of 96 gives the same numbers as one pass (bit for bit)."""
    ja, jc, jm, ta, tc, tm = _state(case, dtype)
    jo, jco = jpbl.module_diff_pbl(case["jctl"], jc, jm, ja)
    monkeypatch.setattr(tpbl, "PBL_CHUNK", chunk)
    to, tco = tpbl.module_diff_pbl(case["tctl"], tc, tm, ta)
    assert tco.rng_ctr == int(jco.rng_ctr) == 777 + 3 * NPMAX + 1
    f64 = dtype == "float64"
    for name in ("lon", "lat", "p"):
        _close(f"pbl {dtype} {name}", getattr(to, name), getattr(jo, name),
               rtol=RTOL if f64 else PBL_RTOL32[name])
    # float32 perturbations: atol for the ones that cancel to ~0
    _close(f"pbl {dtype} uvwp", tco.uvwp, jco.uvwp,
           rtol=RTOL if f64 else PBL_RTOL32["uvwp"],
           atol=0.0 if f64 else 1e-6)
    assert tco.uvwp.dtype == torch.float32
    moved = (to.p != ta.p) & ta.mask
    assert 0.3 < float(moved.double().mean()) < 0.9
    if chunk != 1 << 23:
        monkeypatch.setattr(tpbl, "PBL_CHUNK", 1 << 23)
        whole, wc = tpbl.module_diff_pbl(case["tctl"], tc, tm, ta)
        assert torch.equal(whole.p, to.p) and torch.equal(wc.uvwp, tco.uvwp)


def test_pbl_reaches_every_branch(case):
    """The planted met puts parcels into every branch of the scheme that
    can be reached: neutral, the unstable regime's four zeta bands and
    stable; and the parcels that it leaves alone (dead, dt = 0, above the
    PBL).  The band 0.03 <= zeta < 0.4 has two forms of sigma_w, s1 and
    s2, and takes the smaller; s1 < s2 never holds there: with ol < 0,
    s1 >= 0.96 (3 zeta)^(1/3) and s1 / s2 >= 1.81 zeta^0.158 >= 1.04.
    The parcels of that band all take s2 (in both packages: the float64
    test above holds every parcel)."""
    _, _, _, ta, tc, tm = _state(case, "float64")
    code = tpbl.pbl_branches(case["tctl"], tc, tm, ta)
    counts = dict(zip(tpbl.BRANCHES, torch.bincount(
        code.long(), minlength=len(tpbl.BRANCHES)).tolist()))
    print(counts)
    never = "unstable_0.03-0.4_s1<s2"
    assert counts.pop(never) == 0
    assert min(counts.values()) >= 5, counts
    zeta = np.linspace(0.03, 0.4, 1001)
    assert (0.96 * (3.0 * zeta) ** (1.0 / 3.0)
            / (0.763 * zeta ** 0.175)).min() > 1.04
    # what leaves a parcel alone: dead, dt = 0, above the PBL top
    inactive = code == 0
    assert bool(inactive[~ta.mask].all()) and bool(inactive[tc.dt == 0].all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_module_sedi(case, dtype):
    ja, jc, jm, ta, tc, tm = _state(case, dtype)
    jo = jsedi.module_sedi(case["jctl"], jc, jm, ja)
    to = tsedi.module_sedi(case["tctl"], tc, tm, ta)
    _close(f"sedi {dtype} p", to.p, jo.p,
           rtol=RTOL if dtype == "float64" else 1e-6)
    assert not torch.equal(to.p, ta.p)
    still = (tc.dt == 0) | ~ta.mask
    assert torch.equal(to.p[still], ta.p[still])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_module_isosurf(case, mode, dtype):
    """The initialisation and one step, after the parcels were moved off
    their surface.  Every live parcel is put back, whatever its dt.
    Mode 4: the balloon track stays float64 in the port, and the new
    pressure keeps the state's dtype, where the JAX step's ``where``
    promotes a float32 pressure to float64 (the values agree to the
    float32 rounding)."""
    jctl = case["jctl"].replace(isosurf=mode)
    tctl = case["tctl"].replace(isosurf=mode)
    ja, jc, jm, ta, tc, tm = _state(case, dtype)
    jc = jiso.module_isosurf_init(jctl, jc, jm, ja)
    tc = tiso.module_isosurf_init(tctl, tc, tm, ta)
    f64 = dtype == "float64"
    if mode == 4:
        assert tc.iso_n == int(jc.iso_n) == 12
        assert tc.iso_ts.dtype == torch.float64
        np.testing.assert_array_equal(tc.iso_ts.numpy(), np.asarray(jc.iso_ts))
        np.testing.assert_array_equal(tc.iso_ps.numpy(), np.asarray(jc.iso_ps))
    else:
        _close(f"iso {mode} {dtype} init", tc.iso_var, jc.iso_var,
               rtol=RTOL if f64 else 1e-6)
    # move the parcels off their surface
    ja = ja.replace(p=ja.p * 0.9)
    ta = ta.replace(p=ta.p * 0.9)
    jo = jiso.module_isosurf(jctl, jc, jm, ja)
    to = tiso.module_isosurf(tctl, tc, tm, ta)
    assert to.p.dtype == ta.p.dtype
    want = np.asarray(jo.p)
    if mode == 4 and not f64:
        assert want.dtype == np.float64
        want = want.astype(np.float32)
    _close(f"iso {mode} {dtype} p", to.p, want, rtol=RTOL if f64 else 1e-6)
    live = ta.mask
    assert not bool((to.p[live] == ta.p[live]).any())
    assert torch.equal(to.p[~live], ta.p[~live])
    if mode == 4:
        assert bool((to.p[live] >= 50.0).all() & (to.p[live] <= 300.0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_module_radio_decay(case, dtype):
    """Rn-222 with its Pb-210 in-growth and the single decays."""
    ja, jc, jm, ta, tc, tm = _state(case, dtype)
    jo = jdecay.module_radio_decay(case["jctl"], jc, ja)
    to = tdecay.module_radio_decay(case["tctl"], tc, ta)
    for name in QNT:
        _close(f"radio {dtype} {name}", to.q[name], jo.q[name],
               rtol=RTOL if dtype == "float64" else 2e-7)
    for name in ("Arn222", "Apb210", "Ai131", "Axe133"):
        assert not torch.equal(to.q[name], ta.q[name]), name
    assert torch.equal(to.q["m"], ta.q["m"])


def test_module_radio_decay_without_lead(case):
    """Rn-222 alone: no in-growth to write."""
    _, jc, _, ta, tc, _ = _state(case, "float64")
    q = {"Arn222": ta.q["Arn222"], "m": ta.q["m"]}
    to = tdecay.module_radio_decay(case["tctl"], tc, ta.replace(q=q))
    jq = {"Arn222": case["jatm"].q["Arn222"], "m": case["jatm"].q["m"]}
    jo = jdecay.module_radio_decay(case["jctl"], jc,
                                   case["jatm"].replace(q=jq))
    assert set(to.q) == {"Arn222", "m"}
    _close("radio Arn222 alone", to.q["Arn222"], jo.q["Arn222"])


# --------------------------------------------- the slice as a whole

ALL_QNT = ("m", "vmr", "t", "ens", "Cx", "loss_rate", "mloss_oh", "aoa",
           "rp", "rhop", "Arn222", "Apb210")


def _all_modules_args():
    """The control parameters of tests/test_physics.py's
    test_full_pipeline_all_modules, with radionuclides among the
    quantities and without the vertical mesoscale diffusion: the PBL
    scheme's vertical perturbation (m/s) and the mesoscale diffusion's
    (hPa/s) share ``uvwp[2]`` in both packages, so with both on a PBL
    perturbation of 1 m/s becomes a mesoscale step of 600 hPa, which
    takes parcels near the model top to negative pressures (ROADMAP
    section 3, F7)."""
    args = ["NQ", str(len(ALL_QNT))]
    for i, name in enumerate(ALL_QNT):
        args += [f"QNT_NAME[{i}]", name]
    return args + [
        "METBASE", "-", "DIFFUSION", "1", "TURB_PBL_SCHEME", "1",
        "TURB_MESOZ", "0", "CONV_CAPE", "0", "CONV_MIX_PBL", "1",
        "TDEC_TROP", "86400", "TDEC_STRAT", "86400",
        "MIXING_TROP", "0.5", "MIXING_STRAT", "0.1",
        "SPECIES", "SO2", "RADIO_DECAY", "1",
        "BOUND_LAT0", "-90", "BOUND_LAT1", "90",
        "BOUND_P0", "1e10", "BOUND_P1", "500", "BOUND_MASS", "1",
        "DRY_DEPO_VDEP", "0.01", "T_STOP", "86400", "DT_MOD", "600"]


#: the all-modules step after 3 steps (float64): positions to 1e-6 deg,
#: pressure to rtol 1e-8, quantities to rtol 1e-8, the perturbations to
#: 1e-4 m/s.  The Squares normals of the two packages differ by their
#: float32 cos and sin (5e-7, tests/test_torch_rng.py), which moves a
#: parcel by ~1e-9 deg a step through the turbulent diffusion and the PBL
#: scheme; the mesoscale diffusion's float32 variance carries a last-bit
#: difference of its sum into sigma (tests/test_torch_trac.py
#: ATOL_DEG); the chemistry then sees pressures and temperatures that
#: far apart.  Measured: 2.5e-7 deg, 3.0e-9 in p, 3.2e-9 in the
#: quantities (mloss_oh), 2.6e-5 m/s in uvwp.
ALL_TOL = dict(deg=1e-6, p=1e-8, q=1e-8, uvwp=1e-4)


def _rel_max(got, want):
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(got - want) / np.abs(want)
    return float(np.nanmax(np.where(got == want, 0.0, rel)))


def test_all_modules_three_steps(case):
    """The port's twin of tests/test_physics.py's
    test_full_pipeline_all_modules: every module of the step at once,
    the PBL scheme, sedimentation and radioactive decay among the
    chemistry, on the met with the planted boundary layer, 3 steps of
    both packages from one float64 state, and the same modules reached
    (the RNG counter)."""
    import jax

    from mptrac_tpu.climatology import read_clim as jread_clim
    from mptrac_tpu.physics import pipeline as jpipe
    from mptrac_tpu_torch.physics import pipeline as tpipe
    args = _all_modules_args()
    jctl = jread_ctl(None, args).replace(t_start=0.0)
    tctl = tread_ctl(None, args).replace(t_start=0.0)
    assert jctl.oh_chem_reaction == 3 and jctl.wet_depo_ic_h[0] > 0
    jclim = jread_clim(jctl)
    met01 = plant_pbl_met(jstack(jwind(t0=0.0, nx=36, ny=19, nz=8),
                                 jwind(t0=3600.0, nx=36, ny=19, nz=8)),
                          np.random.default_rng(4))
    n = 500
    rng = np.random.default_rng(1)
    q = {name: np.zeros(n) for name in ALL_QNT}
    q.update(m=np.ones(n), vmr=np.full(n, 1e-9), rp=np.full(n, 1.0),
             rhop=np.full(n, 1000.0), Arn222=np.full(n, 1e3),
             Apb210=np.full(n, 10.0))
    p = np.where(rng.random(n) < 0.5, rng.uniform(800, 1030, n),
                 rng.uniform(100, 1000, n))
    ja = JAtm(time=jnp.zeros(n), p=jnp.asarray(p),
              lon=jnp.asarray(rng.uniform(-180, 180, n)),
              lat=jnp.asarray(rng.uniform(-85, 85, n)),
              q={k: jnp.asarray(v) for k, v in q.items()},
              np=jnp.asarray(n, jnp.int32))
    jc = JCache.zeros(n)
    ta, tc, tm, tclim = to_torch(ja, jc, met01, jclim)
    ja, jc = jpipe.init_modules(jctl, jclim, met01, ja, jc)
    ta, tc = tpipe.init_modules(tctl, tclim, tm, ta, tc)
    step = jpipe.make_step(jctl, jclim)
    for i in (1, 2, 3):
        ja, jc = step(met01, ja, jc, jnp.asarray(i * 600.0, jnp.float64))
        ta, tc = tpipe.run_timestep(tctl, tclim, tm, ta, tc, i * 600.0)
    jax.block_until_ready(ja.lon)
    assert tc.rng_ctr == int(jc.rng_ctr) == 3 * (3 * (3 * n + 1) + n + 1)
    for name in ("lon", "lat", "p"):
        got, want = getattr(ta, name).numpy(), np.asarray(getattr(ja, name))
        print(f"all modules {name}: max abs diff "
              f"{np.abs(got - want).max():.2e}, rel "
              f"{(np.abs(got - want) / np.abs(want)).max():.2e}")
    for name in ("lon", "lat"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), rtol=0,
                                   atol=ALL_TOL["deg"], err_msg=name)
    np.testing.assert_allclose(ta.p.numpy(), np.asarray(ja.p),
                               rtol=ALL_TOL["p"], atol=0)
    for name in ALL_QNT:
        got, want = ta.q[name].numpy(), np.asarray(ja.q[name])
        print(f"all modules {name}: max abs diff "
              f"{np.abs(got - want).max():.2e}, rel "
              f"{_rel_max(got, want):.2e}")
        np.testing.assert_allclose(got, want, rtol=ALL_TOL["q"],
                                   atol=1e-300, err_msg=name)
    np.testing.assert_allclose(tc.uvwp.numpy(), np.asarray(jc.uvwp),
                               rtol=0, atol=ALL_TOL["uvwp"])
    assert bool(torch.isfinite(ta.p).all()) and bool((ta.q["m"] <= 1.0).all())
    assert float(ta.q["Apb210"].min()) > 10.0   # in-growth from Rn-222
