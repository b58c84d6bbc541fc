"""The climatologies of the port against the JAX package: the readers
(photolysis, zonal means, time series), the lookups, and the seven
climatological quantities of module_meteo."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu import climatology as jclim
from mptrac_tpu.physics import chem as jchem
from mptrac_tpu.physics import meteo as jmeteo
from mptrac_tpu_torch import climatology as tclim
from mptrac_tpu_torch.flagship import FLAGSHIP_ARGS
from mptrac_tpu_torch.physics import chem as tchem
from mptrac_tpu_torch.physics import meteo as tmeteo

from helpers.torch_bridge import clim_to_numpy, to_torch

os.environ.setdefault("LOGLEV", "0")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDATA = os.path.join(ROOT, "mptrac_tpu", "data")
TDATA = os.path.join(ROOT, "mptrac_tpu_torch", "data")

CLIM_QNT = ("t", "m", "hno3", "oh", "h2o2", "ho2", "o1d", "tice", "tnat",
            "tsts")
_SERIES = (("CCL4", "noaa_gml_ccl4.tab"), ("CCL3F", "noaa_gml_cfc11.tab"),
           ("CCL2F2", "noaa_gml_cfc12.tab"), ("N2O", "noaa_gml_n2o.tab"),
           ("SF6", "noaa_gml_sf6.tab"))


def all_clim_args(data):
    """Control parameters that switch every climatology on, with the
    time series read from ``data``."""
    args = ["NQ", str(len(CLIM_QNT))]
    for i, name in enumerate(CLIM_QNT):
        args += [f"QNT_NAME[{i}]", name]
    args += ["TRACER_CHEM", "1", "OH_CHEM_REACTION", "2",
             "H2O2_CHEM_REACTION", "1", "OH_CHEM_BETA", "0.6"]
    for key, fname in _SERIES:
        args += [f"CLIM_{key}_TIMESERIES", os.path.join(data, fname)]
    return args + list(FLAGSHIP_ARGS)[6:]


@pytest.fixture(scope="module")
def clims():
    jctl = mt.read_ctl(None, all_clim_args(JDATA))
    tctl = mtt.read_ctl(None, all_clim_args(TDATA))
    return jctl, tctl, jclim.read_clim(jctl), tclim.read_clim(
        tctl, device="cpu")


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_read_clim_tables_equal(clims):
    """Every table of both readers is the same numpy array (the readers
    share their host code): equal to the bit."""
    _, _, cj, ct = clims
    exp = dict(_flat(clim_to_numpy(cj)))
    got = dict(_flat(clim_to_numpy(ct)))
    assert sorted(exp) == sorted(got)
    assert {"zm.oh.vmr", "zm.h2o2.vmr", "zm.o1d.vmr", "zm.hno3.vmr",
            "ts.ccl4.vmr", "ts.sf6.time", "photo.n2o", "photo.o3_1",
            "photo_sza"} <= set(exp)
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k], k)
        assert got[k].dtype == exp[k].dtype, k
        assert got[k].size > 1, k


def test_data_files_are_copies():
    """The port reads its own copies of the climatology files."""
    names = sorted(n for n in os.listdir(TDATA)
                   if n.endswith((".nc", ".tab")))
    assert len(names) == 14
    for n in names:
        with open(os.path.join(JDATA, n), "rb") as a, \
                open(os.path.join(TDATA, n), "rb") as b:
            assert a.read() == b.read(), n


def _points(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-4e7, 9e8, n)
    lat = rng.uniform(-90, 90, n)
    lon = rng.uniform(-180, 180, n)
    p = np.exp(rng.uniform(np.log(0.05), np.log(1100.0), n))
    lat[:4] = [-90.0, 90.0, 0.0, 2.5]
    return t, lon, lat, p


@pytest.mark.parametrize("name", ["oh", "h2o2", "o1d", "hno3"])
def test_clim_zm(clims, name):
    """float64, the same operations in the same order on equal tables:
    rtol 1e-12 (the two libraries' divisions and products round alike;
    the margin is for a contracted multiply-add)."""
    _, _, cj, ct = clims
    t, _, lat, p = _points()
    exp = np.asarray(jclim.clim_zm(cj.zm[name], jnp.asarray(t),
                                   jnp.asarray(lat), jnp.asarray(p)))
    got = tclim.clim_zm(ct.zm[name], torch.from_numpy(t),
                        torch.from_numpy(lat), torch.from_numpy(p)).numpy()
    assert got.dtype == np.float64 and float(got.max()) > 0.0
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["ccl4", "ccl3f", "ccl2f2", "n2o", "sf6"])
def test_clim_ts(clims, name):
    """As test_clim_zm: rtol 1e-12."""
    _, _, cj, ct = clims
    t = _points()[0]
    exp = np.asarray(jclim.clim_ts(cj.ts[name], jnp.asarray(t)))
    got = tclim.clim_ts(ct.ts[name], torch.from_numpy(t)).numpy()
    assert float(got.max()) > float(got.min()) > 0.0
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)


def test_clim_tropo_and_host_version(clims):
    """clim_tropo on the full Clim, and the host version that the met
    preprocessing calls (the same numpy code: equal)."""
    _, _, cj, ct = clims
    t, _, lat, _ = _points()
    exp = np.asarray(jclim.clim_tropo(cj, jnp.asarray(t), jnp.asarray(lat)))
    got = tclim.clim_tropo(ct, torch.from_numpy(t),
                           torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)
    lats = np.linspace(-90, 90, 37)
    for tt in (-3.0e7, 1.0e6, 4.2e8):
        np.testing.assert_array_equal(tclim.clim_tropo_np(None, tt, lats),
                                      jclim.clim_tropo_np(None, tt, lats))


@pytest.mark.parametrize("beta", [0.0, 0.6])
def test_clim_oh(clims, beta):
    """The OH climatology with and without the diurnal correction.  The
    correction goes through sin, cos, atan2 and exp of the two math
    libraries: rtol 1e-12 (observed 2e-15) still holds in float64."""
    jctl, tctl, cj, ct = clims
    jctl = jctl.replace(oh_chem_beta=beta)
    tctl = tctl.replace(oh_chem_beta=beta)
    t, lon, lat, p = _points()
    exp = np.asarray(jchem.clim_oh(jctl, cj, jnp.asarray(t), jnp.asarray(lon),
                                   jnp.asarray(lat), jnp.asarray(p)))
    got = tchem.clim_oh(tctl, ct, torch.from_numpy(t), torch.from_numpy(lon),
                        torch.from_numpy(lat), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)
    if beta:
        csza = tchem.cos_sza(torch.from_numpy(t), torch.from_numpy(lon),
                             torch.from_numpy(lat)).numpy()
        np.testing.assert_allclose(
            csza, np.asarray(jchem.cos_sza(jnp.asarray(t), jnp.asarray(lon),
                                           jnp.asarray(lat))),
            rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def meteo_state(clims):
    """A humid synthetic met pair and parcels in float64, the same arrays
    on both sides; the Clim gets an ``ho2`` table by hand (no reader
    fills it in either package)."""
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.types import Atm, Cache, stack_met
    jctl, tctl, cj, _ = clims
    cj = cj.replace(zm=dict(cj.zm, ho2=cj.zm["h2o2"]))
    kw = dict(nx=36, ny=19, nz=8, alpha=30.0, q=4e-6, temp0=200.0,
              temp1=190.0, z1=30.0)
    met01 = stack_met(make_wind_met(t0=0.0, **kw),
                      make_wind_met(t0=3600.0, **kw))
    n = 1024
    rng = np.random.default_rng(4)
    atm = Atm(time=jnp.full(n, 900.0), p=jnp.asarray(rng.uniform(20, 900, n)),
              lon=jnp.asarray(rng.uniform(-180, 180, n)),
              lat=jnp.asarray(rng.uniform(-89, 89, n)),
              q={k: jnp.zeros(n) for k in CLIM_QNT}, np=n)
    cache = Cache.zeros(n, jnp.float64)
    tatm, tcache, tmet, tcl = to_torch(atm, cache, met01, cj)
    return (jctl, cj, met01, atm, cache), (tctl, tcl, tmet, tatm, tcache)


def test_module_meteo_climatological_quantities(meteo_state):
    """hno3, oh, h2o2, ho2, o1d, tnat and tsts through module_meteo of
    both packages, float64: rtol 1e-10 (tnat is a log10 and a square root
    of the interpolated table; observed 1e-15).  The met is cold and dry
    enough for NAT and ice temperatures of the usual size."""
    (jctl, cj, met01, atm, cache), (tctl, tcl, tmet, tatm, tcache) = \
        meteo_state
    ja = jmeteo.module_meteo(jctl, cache, cj, met01, atm)
    ta = tmeteo.module_meteo(tctl, tcache, tcl, tmet, tatm)
    for k in ("hno3", "oh", "h2o2", "ho2", "o1d", "tice", "tnat", "tsts"):
        exp, got = np.asarray(ja.q[k]), ta.q[k].numpy()
        assert np.isfinite(got).all() and float(np.abs(got).max()) > 0.0, k
        np.testing.assert_allclose(got, exp, rtol=1e-10, atol=0, err_msg=k)
    assert 150.0 < float(ta.q["tnat"].min()) < float(
        ta.q["tnat"].max()) < 260.0


def test_absent_table_leaves_quantity(meteo_state):
    """A quantity whose table the Clim does not hold is left untouched,
    in both packages (the JAX reader never loads ``ho2``)."""
    (jctl, cj, met01, atm, cache), (tctl, tcl, tmet, tatm, tcache) = \
        meteo_state
    zm = {k: v for k, v in tcl.zm.items() if k != "ho2"}
    jzm = {k: v for k, v in cj.zm.items() if k != "ho2"}
    mark = 7.0
    tatm = tatm.replace(q=dict(tatm.q, ho2=torch.full_like(tatm.p, mark)))
    atm = atm.replace(q=dict(atm.q, ho2=jnp.full_like(atm.p, mark)))
    ta = tmeteo.module_meteo(tctl, tcache, tcl.replace(zm=zm), tmet, tatm)
    ja = jmeteo.module_meteo(jctl, cache, cj.replace(zm=jzm), met01, atm)
    assert float(ta.q["ho2"].min()) == float(ta.q["ho2"].max()) == mark
    assert float(ja.q["ho2"].min()) == float(ja.q["ho2"].max()) == mark


def test_module_chem_init(meteo_state):
    """The chemistry quantities that the first step fills from met and
    climatology: rtol 1e-10 in float64."""
    (jctl, cj, met01, atm, cache), (tctl, tcl, tmet, tatm, tcache) = \
        meteo_state
    names = ("Ch2o", "Co3", "Coh", "Cho2", "Ch2o2", "Co1d")
    atm = atm.replace(q=dict(atm.q, **{k: jnp.zeros_like(atm.p)
                                       for k in names}))
    tatm = tatm.replace(q=dict(tatm.q, **{k: torch.zeros_like(tatm.p)
                                          for k in names}))
    ja = jchem.module_chem_init(jctl, cj, met01, atm)
    ta = tchem.module_chem_init(tctl, tcl, tmet, tatm)
    for k in names:
        np.testing.assert_allclose(ta.q[k].numpy(), np.asarray(ja.q[k]),
                                   rtol=1e-10, atol=0, err_msg=k)
    assert float(ta.q["Ch2o"].max()) > 0.0 and float(ta.q["Coh"].max()) > 0.0


@pytest.mark.parametrize("key,what", [
    ("CLIM_OH_FILENAME", "OH zonal mean"),
    ("CLIM_HNO3_FILENAME", "HNO3 zonal mean"),
    ("CLIM_PHOTO", "photolysis rates"),
    ("CLIM_SF6_TIMESERIES", "time series")])
def test_named_missing_file_raises(tmp_path, key, what):
    """A deliberate difference: a climatology file that the control
    parameters name and the disk lacks raises, naming it; the JAX reader
    skips it silently and a later module fails on the absent table."""
    missing = str(tmp_path / "no_such_file.nc")
    args = [key, missing] + all_clim_args(TDATA)
    with pytest.raises(FileNotFoundError, match="no_such_file.nc") as err:
        tclim.read_clim(mtt.read_ctl(None, args), device="cpu")
    assert what in str(err.value)
    jargs = [key, missing] + all_clim_args(JDATA)
    cj = jclim.read_clim(mt.read_ctl(None, jargs))
    assert "oh" not in cj.zm or key != "CLIM_OH_FILENAME"


def test_dash_leaves_table_absent():
    """``-`` names no file: the table stays absent and nothing raises."""
    args = ["CLIM_HNO3_FILENAME", "-"] + all_clim_args(TDATA)
    ct = tclim.read_clim(mtt.read_ctl(None, args), device="cpu")
    assert "hno3" not in ct.zm and "oh" in ct.zm
