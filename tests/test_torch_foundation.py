"""Foundation of the port against the JAX package: control parameters,
thermodynamic helpers, synthetic met, tropopause climatology."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu import climatology as jclim
from mptrac_tpu.met.synthetic import make_wind_met as jmake
from mptrac_tpu.ops import thermo as jthermo
from mptrac_tpu_torch import climatology as tclim
from mptrac_tpu_torch.flagship import FLAGSHIP_ARGS
from mptrac_tpu_torch.met.synthetic import make_wind_met as tmake
from mptrac_tpu_torch.ops import thermo as tthermo

os.environ.setdefault("LOGLEV", "0")


def test_read_ctl_fields_equal():
    """read_ctl(None, args) gives equal fields for the flagship args;
    the default climatology file names point into each package's own
    data directory, so those compare by base name."""
    jargs = ["NQ", "2", "QNT_NAME[0]", "t", "QNT_NAME[1]", "m",
             "METBASE", "-", "DT_MOD", "180", "DIFFUSION", "1",
             "TDEC_TROP", "259200", "TDEC_STRAT", "259200",
             "T_STOP", "86400"]
    assert list(FLAGSHIP_ARGS) == jargs
    a = mt.read_ctl(None, jargs)
    b = mtt.read_ctl(None, list(FLAGSHIP_ARGS))
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if name.startswith("clim_") and isinstance(va, str):
            va, vb = os.path.basename(va), os.path.basename(vb)
        assert va == vb, name
    assert a.qnt("m") == b.qnt("m") and a.qnt("rp") == b.qnt("rp")


@pytest.mark.parametrize("name", [
    "psat", "psice", "sh", "altitude", "dy2deg", "rho", "theta", "pw",
    "tdew", "tice", "tvirt", "dp2dz", "dz2dp", "dx2deg", "deg2dx",
    "molec_dens", "rh", "rhice", "zeta", "nat_temperature",
    "sedi_velocity", "fmod", "dx2coord"])
def test_thermo_f64(name):
    """float64, same operations in the same order: rtol 1e-12 leaves
    room only for the math libraries' last bits in exp/log/pow."""
    rng = np.random.default_rng(1)
    n = 257
    p = rng.uniform(10, 1000, n)
    t = rng.uniform(180, 310, n)
    h2o = rng.uniform(1e-7, 2e-2, n)
    lat = rng.uniform(-90, 90, n)
    lat[:3] = [-89.9995, 89.9995, 0.0]
    x = rng.uniform(-500, 500, n)
    args = {
        "psat": (t,), "psice": (t,), "sh": (h2o,), "altitude": (p,),
        "dy2deg": (x,), "rho": (p, t), "theta": (p, t), "pw": (p, h2o),
        "tdew": (p, h2o), "tice": (p, h2o), "tvirt": (t, h2o),
        "dp2dz": (x, p), "dz2dp": (x, p), "dx2deg": (x, lat),
        "deg2dx": (x, lat), "molec_dens": (p, t), "rh": (p, t, h2o),
        "rhice": (p, t, h2o), "zeta": (p + 50.0, p, t),
        "nat_temperature": (p, h2o, h2o * 1e-3),
        "sedi_velocity": (p, t, rng.uniform(0.1, 10, n),
                          rng.uniform(500, 2000, n)),
        "fmod": (x * 3, 360.0), "dx2coord": (x, lat, False),
    }[name]
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args]
    exp = np.asarray(getattr(jthermo, name)(*ja))
    got = getattr(tthermo, name)(*ta).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)


def test_make_wind_met_fields_equal():
    """Both packages build the fields with the same numpy code and one
    rounding to float32: equal bit for bit."""
    kw = dict(t0=3600.0, nx=36, ny=19, nz=8, alpha=30.0)
    a = jmake(**kw)
    b = tmake(device="cpu", **kw)
    # (the port keeps a snapshot's time on the host)
    assert isinstance(b.time, float) and b.time == float(a.time) == 3600.0
    for name in ("lon", "lat", "p", "hybrid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), name)
    assert set(a.fields3d) == set(b.fields3d)
    assert set(a.fields2d) == set(b.fields2d)
    for k in a.fields3d:
        np.testing.assert_array_equal(np.asarray(a.fields3d[k]),
                                      b.fields3d[k].numpy(), k)
    for k in a.fields2d:
        np.testing.assert_array_equal(np.asarray(a.fields2d[k]),
                                      b.fields2d[k].numpy(), k)
    assert (a.coord_type, a.reg_lon, a.reg_lat, a.lon_periodic) == \
        (b.coord_type, b.reg_lon, b.reg_lat, b.lon_periodic)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_clim_tropo(dtype):
    """The JAX one-hot products select single table entries, so direct
    indexing agrees to the rounding of the dtype: f64 rtol 1e-13; f32
    rtol 2e-6 (XLA may contract a*b+c differently, one f32 ulp or
    two)."""
    ctl = mt.read_ctl(None, list(FLAGSHIP_ARGS))
    cj = jclim.read_clim(ctl)
    ct = tclim.read_clim(mtt.read_ctl(None, list(FLAGSHIP_ARGS)),
                         device="cpu")
    np.testing.assert_array_equal(np.asarray(cj.tropo), ct.tropo.numpy())
    rng = np.random.default_rng(2)
    n = 4096
    t = rng.uniform(-4e7, 9e8, n)
    lat = rng.uniform(-90, 90, n)
    lat[:4] = [-90.0, 90.0, 0.0, 2.5]
    if dtype == "float32":
        from mptrac_tpu.types import astype_state as jast
        from mptrac_tpu_torch.types import astype_state as tast
        cj, ct = jast(clim=cj), tast(clim=ct)
        lat = lat.astype(np.float32)
    exp = np.asarray(jclim.clim_tropo(cj, jnp.asarray(t), jnp.asarray(lat)))
    got = tclim.clim_tropo(ct, torch.from_numpy(t),
                           torch.from_numpy(lat)).numpy()
    assert got.dtype == exp.dtype
    rtol = 1e-13 if dtype == "float64" else 2e-6
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=0)


def test_read_clim_raises_for_unported_climatology(tmp_path):
    """Every climatology is ported now, so nothing raises as unported:
    the OH zonal mean loads, and what still raises is a file that the
    control parameters name and the disk lacks (the readers themselves
    are held in tests/test_torch_clim.py)."""
    ctl = mtt.read_ctl(None, list(FLAGSHIP_ARGS)
                       + ["OH_CHEM_REACTION", "2"])
    assert "oh" in tclim.read_clim(ctl, device="cpu").zm
    ctl = mtt.read_ctl(None, list(FLAGSHIP_ARGS) + [
        "OH_CHEM_REACTION", "2", "CLIM_OH_FILENAME",
        str(tmp_path / "absent_OH.nc")])
    with pytest.raises(FileNotFoundError, match="OH zonal mean"):
        tclim.read_clim(ctl, device="cpu")


def test_cuda_entry_points_raise_without_gpu():
    """Nothing carries on on the CPU by itself: asking for "cuda" where
    there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mtt.Atm.zeros(8, ("m",))
    with pytest.raises(RuntimeError, match="cuda"):
        tmake(nx=8, ny=5, nz=3)
    # the readers place their tensors on the card by default as well
    from mptrac_tpu_torch.met.build import read_met
    ctl = mtt.read_ctl(None, ["MET_TROPO", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        tclim.read_clim(ctl)
    with pytest.raises(RuntimeError, match="cuda"):
        read_met(os.path.join(ROOT, "parity", "golden_long", "data",
                              "met_2011_06_05_00.nc"), ctl)


GOLDEN_CTLS = ("golden_chem", "golden_long", "golden_utm", "golden_zeta")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unknown_keys(err):
    return sorted(line.rsplit(": ", 1)[1] for line in err.splitlines()
                  if "Unknown control parameter" in line)


@pytest.mark.parametrize("name", GOLDEN_CTLS)
def test_read_ctl_golden_files_fields_equal(name, capsys):
    """read_ctl on the golden control files: every field equal to the
    JAX package's (the files name their climatology paths themselves;
    where one is left to the default it points into each package's own
    data directory and compares by base name), and the same unknown-key
    warnings (none of these files holds an array index that no scan
    reaches)."""
    path = os.path.join(ROOT, "parity", name, "data", "trac.ctl")
    a = mt.read_ctl(path)
    err_a = capsys.readouterr().err
    b = mtt.read_ctl(path)
    err_b = capsys.readouterr().err
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name.startswith("clim_") and isinstance(va, str):
            va, vb = os.path.basename(va), os.path.basename(vb)
        assert va == vb, f.name
    assert a.nq == b.nq > 5 and a.qnt_name == b.qnt_name
    assert _unknown_keys(err_a) == _unknown_keys(err_b)


def test_unknown_key_check_sees_out_of_range_indices(tmp_path, capsys):
    """A deliberate difference (config.py:207 of the JAX package): an
    array element that no scan reaches, like QNT_NAME[7] with NQ = 2, is
    reported as unknown; the JAX check lets it pass because other
    elements of the array were scanned.  A wildcard element and keys
    that were scanned stay unreported in both."""
    path = str(tmp_path / "trac.ctl")
    with open(path, "w") as f:
        f.write("NQ = 2\nQNT_NAME[0] = t\nQNT_NAME[1] = m\n"
                "QNT_NAME[7] = zg\nQNT_UNIT[*] = K\nDT_MOD = 180\n"
                "DT_MODD = 90\nDT_MOD[0] = 60\n")
    a = mt.read_ctl(path)
    err_a = capsys.readouterr().err
    b = mtt.read_ctl(path)
    err_b = capsys.readouterr().err
    for f in dataclasses.fields(a):
        if not f.name.startswith("clim_"):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert b.qnt_name == ("t", "m") and b.qnt_unit == ("K", "K")
    assert b.dt_mod == 180.0
    assert _unknown_keys(err_a) == ["DT_MODD"]
    assert _unknown_keys(err_b) == ["DT_MODD", "DT_MOD[0]", "QNT_NAME[7]"]
