"""The chemistry step of the port against the JAX package, module by
module: convection, boundary conditions, mixing, the chemistry grid,
OH / H2O2 / tracer chemistry, wet and dry deposition.

Both packages get the same float64 state, made with numpy from a seed,
on the synthetic wind met pair with clouds, CAPE, equilibrium level,
boundary layer and cloud top and bottom planted from the same seed (the
synthetic met holds zeros or NaN there, so nothing would rain or
convect).  The climatology is the JAX package's, carried across.  Some
parcels are dead (beyond ``np``), some have ``dt = 0`` and some lie
outside the time window, the mixing grid or the chemistry grid (the
overflow bucket).

Tolerance: rtol 1e-12, atol 0 on every quantity a module writes, and on
the pressure that convection writes.  The two sides do the same float64
operations in the same order; they differ by the math libraries' exp,
log, pow, sin and cos (an ulp or two) and by the order in which
``index_add_`` and XLA's ``segment_sum`` add the parcels of a box (a few
ulp of a box sum).  Measured (printed by each test): at most 2.9e-13
relative, in ``mloss_oh``, where ``m * (1 - exp(-k dt))`` with
``exp(-k dt)`` near 1 loses the leading digits of exp's last ulp; 3.7e-14
in the H2O2 chemistry, where exp of a large argument carries its
argument's rounding; 5e-16 and below elsewhere.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mptrac_tpu
from helpers.torch_bridge import met_to_numpy, to_torch
from mptrac_tpu.climatology import read_clim as jread_clim
from mptrac_tpu.config import read_ctl as jread_ctl
from mptrac_tpu.met.synthetic import make_wind_met as jwind
from mptrac_tpu.physics import bound as jbound
from mptrac_tpu.physics import chem as jchem
from mptrac_tpu.physics import convection as jconv
from mptrac_tpu.physics import depo as jdepo
from mptrac_tpu.physics import mixing as jmix
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu.types import Cache as JCache
from mptrac_tpu.types import stack_met as jstack
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.physics import bound as tbound
from mptrac_tpu_torch.physics import chem as tchem
from mptrac_tpu_torch.physics import convection as tconv
from mptrac_tpu_torch.physics import depo as tdepo
from mptrac_tpu_torch.physics import mixing as tmix

NPMAX = 640
NP = 600                       # live parcels; the rest are padding
T0 = 360547200.0 + 1800.0      # 2011-06-05 00:30 UTC
DT_MOD = 120.0
QNT = ("m", "vmr", "Cx", "Cccl4", "Cccl3f", "Cccl2f2", "Cn2o", "Csf6",
       "aoa", "loss_rate", "mloss_oh", "mloss_h2o2", "mloss_wet",
       "mloss_dry", "ens", "rp", "rhop")
RTOL = 1e-12


def _ctl_args():
    data = os.path.join(os.path.dirname(mptrac_tpu.__file__), "data")
    args = ["NQ", str(len(QNT))]
    for i, name in enumerate(QNT):
        args += [f"QNT_NAME[{i}]", name]
    args += ["METBASE", "-", "DT_MOD", str(DT_MOD), "SPECIES", "SO2",
             "H2O2_CHEM_REACTION", "1", "TRACER_CHEM", "1",
             "CLIM_PHOTO", f"{data}/clams_photolysis_rates.nc"]
    for key, f in (("CCL4", "ccl4"), ("CCL3F", "cfc11"),
                   ("CCL2F2", "cfc12"), ("N2O", "n2o"), ("SF6", "sf6")):
        args += [f"CLIM_{key}_TIMESERIES", f"{data}/noaa_gml_{f}.tab"]
    return args


def _plant(rng, shape, lo, hi, nan=0.0, zero=0.0):
    x = rng.uniform(lo, hi, shape)
    x[rng.random(shape) < zero] = 0.0
    x[rng.random(shape) < nan] = np.nan
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    args = _ctl_args()
    jctl = jread_ctl(None, args)
    tctl = tread_ctl(None, args)
    jclim = jread_clim(jctl)
    assert {"oh", "h2o2", "o1d"} <= set(jclim.zm)
    assert {"ccl4", "ccl3f", "ccl2f2", "n2o", "sf6"} <= set(jclim.ts)
    assert "ccl3f" in jclim.photo

    # the synthetic pair with weather planted into it
    met01 = jstack(jwind(t0=T0 - 1800.0, nx=36, ny=19, nz=8, alpha=30.0),
                   jwind(t0=T0 + 1800.0, nx=36, ny=19, nz=8, alpha=30.0))
    d = met_to_numpy(met01)
    s2 = d["fields2d"]["ps"].shape
    s3 = d["fields3d"]["t"].shape
    f2 = dict(d["fields2d"], ps=_plant(rng, s2, 950, 1030),
              pbl=_plant(rng, s2, 600, 950),
              cape=_plant(rng, s2, 0, 2000, nan=0.1),
              cin=_plant(rng, s2, 0, 300, nan=0.2),
              pel=_plant(rng, s2, 150, 500, nan=0.1),
              pct=_plant(rng, s2, 150, 500, nan=0.2),
              pcb=_plant(rng, s2, 550, 950),
              cl=_plant(rng, s2, 0, 3, zero=0.2),
              o3c=_plant(rng, s2, 200, 450))
    f3 = dict(d["fields3d"], t=_plant(rng, s3, 200, 300))
    for name in ("lwc", "rwc", "iwc", "swc"):
        f3[name] = _plant(rng, s3, 0, 2e-4, zero=0.6)
    jmet = met01.replace(fields2d={k: jnp.asarray(v) for k, v in f2.items()},
                         fields3d={k: jnp.asarray(v) for k, v in f3.items()})

    def u(lo, hi):
        return rng.uniform(lo, hi, NPMAX)

    q = {name: u(0.0, 1.0) for name in QNT}
    q.update(m=u(0.5, 2.0), vmr=u(1e-9, 1e-6),
             Cx=10.0 ** u(-12.0, -6.0), aoa=u(0.0, 1e6),
             loss_rate=u(0.0, 1e-5), ens=rng.integers(0, 3, NPMAX) * 1.0,
             rp=u(0.1, 10.0), rhop=u(500.0, 2500.0))
    for name in ("Cccl4", "Cccl3f", "Cccl2f2", "Cn2o", "Csf6"):
        q[name] = u(1e-12, 1e-9)
    time = T0 + rng.choice([0.0, 0.0, 0.0, 0.0, 45.0, -90.0, 300.0], NPMAX)
    p = np.exp(u(np.log(3.0), np.log(1020.0)))
    jatm = JAtm(time=jnp.asarray(time), p=jnp.asarray(p),
                lon=jnp.asarray(u(-180.0, 180.0)),
                lat=jnp.asarray(u(-89.0, 89.0)),
                q={k: jnp.asarray(v) for k, v in q.items()},
                np=jnp.asarray(NP, jnp.int32))
    dt = rng.choice([DT_MOD, DT_MOD, DT_MOD, 0.0], NPMAX)
    jcache = JCache.zeros(NPMAX, iso_npmax=1).replace(
        dt=jnp.asarray(dt), rng_ctr=jnp.asarray(12345, jnp.uint64))
    tatm, tcache, tmet, tclim = to_torch(jatm, jcache, jmet, jclim)
    return dict(jctl=jctl, tctl=tctl, jclim=jclim, tclim=tclim, jmet=jmet,
                tmet=tmet, jatm=jatm, tatm=tatm, jcache=jcache,
                tcache=tcache)


def _ctls(case, **kw):
    return case["jctl"].replace(**kw), case["tctl"].replace(**kw)


def _close(tag, got, want, rtol=RTOL):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float64, tag
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(got - want) / np.abs(want)
    rel = np.where(got == want, 0.0, rel)
    print(f"{tag}: max rel diff {np.nanmax(rel):.2e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=tag)


def _same_atm(tag, ja, ta):
    """Every field of the two states agrees."""
    for name in ("time", "p", "lon", "lat"):
        _close(f"{tag} {name}", getattr(ta, name), getattr(ja, name))
    assert set(ta.q) == set(ja.q)
    for name in ta.q:
        _close(f"{tag} {name}", ta.q[name], ja.q[name])
    return ta


def _changed(before, after, names):
    """Each of ``names`` (``p`` or a quantity) changed somewhere."""
    for name in names:
        a = before.p if name == "p" else before.q[name]
        b = after.p if name == "p" else after.q[name]
        assert not torch.equal(a, b), f"{name} did not change"


@pytest.mark.parametrize("kw", [
    dict(conv_mix_pbl=1, conv_pbl_trans=0.5, conv_cape=0.0),
    dict(conv_cape=500.0, conv_cin=50.0),
    dict(conv_mix_pbl=1, conv_pbl_trans=0.0),
], ids=["pbl-cape", "cape-cin", "pbl"])
def test_module_convection(case, kw):
    """The uniform draws are bit for bit the same (tests/test_torch_rng.py),
    so the new pressures agree to the rounding of the density
    interpolation."""
    jctl, tctl = _ctls(case, **kw)
    ja, jc = jconv.module_convection(jctl, case["jcache"], case["jmet"],
                                     case["jatm"])
    ta, tc = tconv.module_convection(tctl, case["tcache"], case["tmet"],
                                     case["tatm"])
    assert tc.rng_ctr == int(jc.rng_ctr) == 12345 + NPMAX + 1
    _same_atm("convection", ja, ta)
    _changed(case["tatm"], ta, ["p"])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bound_dps=150.0, bound_dzs=1.0),
    dict(bound_zetas=400.0, bound_pbl=1),
], ids=["box", "dps-dzs", "zetas-pbl"])
def test_module_bound_cond(case, kw):
    jctl, tctl = _ctls(case, bound_lat0=-60.0, bound_lat1=70.0,
                       bound_p0=900.0, bound_p1=20.0, bound_mass=0.5,
                       bound_mass_trend=1e-9, bound_vmr=1e-7,
                       bound_vmr_trend=1e-16, **kw)
    ja = jbound.module_bound_cond(jctl, case["jcache"], case["jclim"],
                                  case["jmet"], case["jatm"])
    ta = tbound.module_bound_cond(tctl, case["tcache"], case["tclim"],
                                  case["tmet"], case["tatm"])
    _same_atm("bound", ja, ta)
    _changed(case["tatm"], ta, ["m", "vmr", "Cccl4", "Csf6", "aoa"])


MIX_GRID = dict(mixing_nx=12, mixing_ny=6, mixing_nz=8, mixing_z0=0.0,
                mixing_z1=32.0, mixing_lat0=-80.0, mixing_lat1=80.0)


@pytest.mark.parametrize("kw", [
    dict(mixing_trop=0.3, mixing_strat=0.1, nens=0),
    dict(mixing_trop=0.3, mixing_strat=0.1, nens=3),
    dict(mixing_trop=1.0, mixing_strat=1.0, nens=0),
], ids=["weighted", "ensembles", "full"])
def test_module_mixing(case, kw):
    """A coarse grid (dozens of parcels a box) that leaves out the
    parcels above 32 km, poleward of 80 deg and off the time window:
    they go to the overflow bucket and keep their values."""
    jctl, tctl = _ctls(case, **MIX_GRID, **kw)
    t = T0
    ja = jmix.module_mixing(jctl, case["jclim"], case["jatm"], t)
    ta = tmix.module_mixing(tctl, case["tclim"], case["tatm"], t)
    _same_atm("mixing", ja, ta)
    _changed(case["tatm"], ta, ["m", "vmr", "Cccl3f", "aoa"])
    ix, iy, iz, ok = tmix.grid_indices(tctl, case["tatm"], t)
    assert 0 < int(ok.sum()) < NP
    out = ~ok
    assert torch.equal(ta.q["m"][out], case["tatm"].q["m"][out])


CHEM_GRID = dict(chemgrid_nx=10, chemgrid_ny=8, chemgrid_nz=6,
                 chemgrid_z0=0.0, chemgrid_z1=30.0, chemgrid_lat0=-70.0,
                 chemgrid_lat1=85.0)


@pytest.mark.parametrize("nens", [0, 3])
def test_module_chem_grid(case, nens):
    jctl, tctl = _ctls(case, **CHEM_GRID, nens=nens)
    ja = jchem.module_chem_grid(jctl, case["jmet"], case["jatm"], T0)
    ta = tchem.module_chem_grid(tctl, case["tmet"], case["tatm"], T0)
    _same_atm("chem grid", ja, ta)
    _changed(case["tatm"], ta, ["Cx"])
    _, _, _, ok = tmix.grid_indices(tctl, case["tatm"], T0, "chemgrid")
    assert torch.equal(ta.q["Cx"][~ok], case["tatm"].q["Cx"][~ok])


@pytest.mark.parametrize("kw", [
    dict(oh_chem_reaction=1, oh_chem=(2.4e-13, 0.0, 0.0, 0.0)),
    dict(oh_chem_reaction=2, oh_chem=(2.45e-12, 1775.0, 0.0, 0.0)),
    dict(),
    dict(oh_chem_beta=0.5),
], ids=["const", "arrhenius", "termolecular", "diurnal"])
def test_module_oh_chem(case, kw):
    """SO2's termolecular preset and the other reaction types; Cx spans
    both sides of the high-SO2 correction's threshold."""
    jctl, tctl = _ctls(case, **kw)
    ja = jchem.module_oh_chem(jctl, case["jcache"], case["jclim"],
                              case["jmet"], case["jatm"])
    ta = tchem.module_oh_chem(tctl, case["tcache"], case["tclim"],
                              case["tmet"], case["tatm"])
    _same_atm("oh chem", ja, ta)
    _changed(case["tatm"], ta, ["m", "vmr", "mloss_oh", "loss_rate"])


def test_module_h2o2_chem(case):
    ja = jchem.module_h2o2_chem(case["jctl"], case["jcache"], case["jclim"],
                                case["jmet"], case["jatm"])
    ta = tchem.module_h2o2_chem(case["tctl"], case["tcache"], case["tclim"],
                                case["tmet"], case["tatm"])
    _same_atm("h2o2 chem", ja, ta)
    _changed(case["tatm"], ta, ["m", "vmr", "mloss_h2o2"])


def test_module_tracer_chem(case):
    ja = jchem.module_tracer_chem(case["jctl"], case["jcache"],
                                  case["jclim"], case["jmet"], case["jatm"])
    ta = tchem.module_tracer_chem(case["tctl"], case["tcache"],
                                  case["tclim"], case["tmet"], case["tatm"])
    _same_atm("tracer chem", ja, ta)
    _changed(case["tatm"], ta, ["Cccl4", "Cccl3f", "Cccl2f2", "Cn2o"])


def test_clim_photo(case):
    """The photolysis lookup alone, at pressures, zenith angles and
    ozone columns beyond the table on both sides."""
    rng = np.random.default_rng(3)
    p = rng.uniform(0.01, 1100.0, 300)
    sza = rng.uniform(-0.2, 3.3, 300)
    o3c = rng.uniform(50.0, 700.0, 300)
    jc, tc = case["jclim"], case["tclim"]
    for key in ("ccl4", "n2o"):
        want = jchem.clim_photo(jc.photo[key], jc, jnp.asarray(p),
                                jnp.asarray(sza), jnp.asarray(o3c))
        got = tchem.clim_photo(tc.photo[key], tc, torch.from_numpy(p),
                               torch.from_numpy(sza), torch.from_numpy(o3c))
        _close(f"clim_photo {key}", got, want)
        assert float(got.max()) > 0.0


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wet_depo_so2_ph=5.0, wet_depo_ic_ret_ratio=0.5,
         wet_depo_bc_ret_ratio=0.3),
    dict(wet_depo_ic_a=2.6e-5, wet_depo_ic_b=0.62, wet_depo_bc_a=2e-6,
         wet_depo_bc_b=0.62),
], ids=["henry", "henry-ph-retention", "coefficients"])
def test_module_wet_depo(case, kw):
    """SO2's Henry constants (the SPECIES preset) or the exponential
    coefficients of particles."""
    jctl, tctl = _ctls(case, **kw)
    assert tctl.wet_depo_ic_h[0] > 0 and tctl.wet_depo_bc_h[0] > 0
    ja = jdepo.module_wet_depo(jctl, case["jcache"], case["jmet"],
                               case["jatm"])
    ta = tdepo.module_wet_depo(tctl, case["tcache"], case["tmet"],
                               case["tatm"])
    _same_atm("wet depo", ja, ta)
    _changed(case["tatm"], ta, ["m", "vmr", "mloss_wet"])


@pytest.mark.parametrize("sedi", [False, True], ids=["vdep", "sedimentation"])
def test_module_dry_depo(case, sedi):
    """A deposition velocity, or the parcels' sedimentation velocity where
    the state carries rp and rhop."""
    names = QNT if sedi else tuple(q for q in QNT if q not in ("rp", "rhop"))
    jctl, tctl = _ctls(case, dry_depo_vdep=0.15, dry_depo_dp=300.0,
                       qnt_name=names)
    ja0, ta0 = case["jatm"], case["tatm"]
    if not sedi:
        ja0 = ja0.replace(q={k: ja0.q[k] for k in names})
        ta0 = ta0.replace(q={k: ta0.q[k] for k in names})
    ja = jdepo.module_dry_depo(jctl, case["jcache"], case["jmet"], ja0)
    ta = tdepo.module_dry_depo(tctl, case["tcache"], case["tmet"], ta0)
    _same_atm("dry depo", ja, ta)
    _changed(ta0, ta, ["m", "vmr", "mloss_dry"])


def test_modules_need_mass_or_vmr(case):
    ta = case["tatm"].replace(q={"Cx": case["tatm"].q["Cx"]})
    for fn in (lambda: tdepo.module_dry_depo(case["tctl"], case["tcache"],
                                             case["tmet"], ta),
               lambda: tchem.module_h2o2_chem(case["tctl"], case["tcache"],
                                              case["tclim"], case["tmet"],
                                              ta)):
        with pytest.raises(ValueError, match="mass or volume"):
            fn()


def test_chem_molec_dens_is_the_reference_macro():
    """The chemistry's molecular density is MOLEC_DENS of the reference
    (the JAX chemistry's), not ops.thermo.molec_dens."""
    p = torch.tensor([1000.0, 250.0])
    t = torch.tensor([300.0, 220.0])
    want = jchem.molec_dens(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(tchem.molec_dens(p, t).numpy(),
                                  np.asarray(want))
    # 2.41e19 molecules a cm^3 at 1000 hPa and 300 K
    assert abs(float(tchem.molec_dens(p, t)[0]) / 2.4143e19 - 1.0) < 1e-3
