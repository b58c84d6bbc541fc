"""The port's met tools, which sample the met on a device
(``mptrac_tpu_torch.tools``: ``_met_sample``, met_map, met_prof, met_zm,
met_sample, cape, tropo, met_lapse, met_spec, met_subgrid,
met_check_dt), held against the JAX package's tools with
``--device cpu``, on three 36x19x8 met files of the solid-body wind
(``tests/test_web.py``'s met) with weather planted from a numpy seed:
``sample_met`` and ``find_theta_level`` at rtol 1e-12 in float64, every
text file to its printed precision (one unit in the last printed
digit), and tropo's netCDF product value for value."""

import contextlib
import importlib
import io
import os
import re

import numpy as np
import pytest
import torch

from mptrac_tpu.tools._cli import run_tool as jrun_tool
from mptrac_tpu_torch.tools._cli import run_tool

os.environ.setdefault("LOGLEV", "0")

#: three met files six hours apart
TIMES = (0.0, 21600.0, 43200.0)
CTL = ("NQ = 2\nQNT_NAME[0] = m\nQNT_NAME[1] = hno3\n"
       "DT_MET = 21600\nOH_CHEM_REACTION = 2\nH2O2_CHEM_REACTION = 1\n"
       "TRACER_CHEM = 1\nT_STOP = 43200\n")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def quiet_logs():
    """Both packages echo the control file to the standard output that
    these tests compare: LOGLEV 0 for both, whatever level an earlier
    test file's import left them at."""
    from mptrac_tpu.utils import log as jlog
    from mptrac_tpu_torch.utils import log as tlog
    levels = jlog.get_level(), tlog.get_level()
    jlog.set_level(0)
    tlog.set_level(0)
    yield
    jlog.set_level(levels[0])
    tlog.set_level(levels[1])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(directory, ctl file) with the met files ``wind_*.nc``: the JAX
    package's synthetic wind with a lapse rate, and noise planted in T,
    u, v, w, H2O and O3."""
    import jax.numpy as jnp
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.met.write_nc import write_met_nc
    d = tmp_path_factory.mktemp("met")
    rng = np.random.default_rng(21)
    for t0 in TIMES:
        met = make_wind_met(t0=t0, nx=36, ny=19, nz=8, alpha=30.0,
                            temp0=295.0, temp1=210.0)
        f3 = dict(met.fields3d)
        shape = f3["t"].shape
        for name, scale in (("t", 3.0), ("u", 5.0), ("v", 5.0),
                            ("w", 0.05)):
            f3[name] = f3[name] + jnp.asarray(
                rng.normal(0, scale, shape), jnp.float32)
        lev = np.exp(-np.arange(shape[2]) / 2.0)[None, None, :]
        f3["h2o"] = jnp.asarray(rng.uniform(0.2, 1.0, shape) * 1e-2 * lev,
                                jnp.float32)
        f3["o3"] = jnp.asarray(rng.uniform(1e-8, 8e-6, shape), jnp.float32)
        hour = int(t0 // 3600)
        write_met_nc(str(d / f"wind_2000_01_01_{hour:02d}.nc"),
                     met.replace(fields3d=f3), drop_wrap_column=True)
    ctl = d / "met.ctl"
    ctl.write_text(CTL + f"METBASE = {d / 'wind'}\n")
    return d, ctl


def metfile(d, k):
    return d / f"wind_2000_01_01_{int(TIMES[k] // 3600):02d}.nc"


def readers(case):
    """(JAX ctl, clim, met; port ctl, clim, met) of the first file."""
    from mptrac_tpu.climatology import read_clim as jread_clim
    from mptrac_tpu.config import read_ctl as jread_ctl
    from mptrac_tpu.met.build import read_met as jread_met
    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    d, ctl_file = case
    jctl = jread_ctl(str(ctl_file), [])
    tctl = read_ctl(str(ctl_file), [])
    jclim = jread_clim(jctl)
    tclim = read_clim(tctl, device="cpu")
    f = str(metfile(d, 0))
    return (jctl, jclim, jread_met(f, jctl, jclim), tctl, tclim,
            read_met(f, tctl, tclim, device="cpu"))


def points(n, seed):
    rng = np.random.default_rng(seed)
    return (np.exp(rng.uniform(np.log(0.5), np.log(1100.0), n)),
            rng.uniform(-200, 200, n), rng.uniform(-92, 92, n))


def test_sample_met_matches_jax(case):
    """Every variable of the record at 400 points (some beyond the grid
    and above its top) at rtol 1e-12 in float64."""
    from mptrac_tpu.tools import _met_sample as jms
    from mptrac_tpu_torch.tools import _met_sample as tms
    jctl, jclim, jmet, tctl, tclim, tmet = readers(case)
    assert {"oh", "h2o2", "o1d", "hno3"} <= set(tclim.zm)
    p, lon, lat = points(400, 1)
    js = jms.sample_met(jctl, jclim, jmet, p, lon, lat)
    ts = tms.sample_met(tctl, tclim, tmet, p, lon, lat)
    assert set(ts) == set(js)
    for k in js:
        assert ts[k].dtype == np.float64, k
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-12, atol=0,
                                   equal_nan=True, err_msg=k)
    assert np.isfinite(ts["t"]).all() and ts["oh"].max() > 0
    assert tms.MET_HEADER == jms.MET_HEADER
    assert tms.record_columns(0, 1, 2, 3, 4, ts) == jms.record_columns(
        0, 1, 2, 3, 4, ts)


def test_find_theta_level_matches_jax(case):
    from mptrac_tpu.tools import _met_sample as jms
    from mptrac_tpu_torch.tools import _met_sample as tms
    _, _, jmet, _, _, tmet = readers(case)
    _, lon, lat = points(300, 2)
    for theta in (320.0, 400.0, 600.0):
        np.testing.assert_allclose(
            tms.find_theta_level(tmet, theta, lon, lat),
            jms.find_theta_level(jmet, theta, lon, lat), rtol=1e-12)


def _unit(token):
    """One unit in the last printed digit of a number."""
    m = re.fullmatch(r"[-+]?\d*(?:\.(\d*))?(?:[eE]([-+]?\d+))?", token)
    if m is None:
        return 0.0
    return 10.0 ** (int(m.group(2) or 0) - len(m.group(1) or ""))


def same_to_printed_precision(jtext, ttext):
    """The port's text is the JAX tool's, each number within one unit in
    its last printed digit; returns how many numbers differ."""
    jl, tl = jtext.splitlines(), ttext.splitlines()
    assert len(tl) == len(jl) > 0
    differ = 0
    for a, b in zip(jl, tl):
        if a.startswith("#") or "=" in a or not a.strip():
            if "=" in a and not a.startswith("#"):
                a, b = a.split("=")[-1], b.split("=")[-1]
            else:
                assert b == a
                continue
        ja, tb = a.split(), b.split()
        assert len(tb) == len(ja), (a, b)
        for x, y in zip(ja, tb):
            if x == y:
                continue
            fx, fy = float(x), float(y)
            assert abs(fx - fy) <= max(_unit(x), _unit(y)) * (1 + 1e-9), (
                x, y, a)
            differ += 1
    return differ


def run_both(tool, argv_of, tmp_path):
    """The JAX tool and the port's (``--device cpu``) on ``argv_of(d)``,
    a directory each; returns (jax dir, port dir, jax stdout, port
    stdout)."""
    outs = []
    for pkg, runner, extra in (("mptrac_tpu", jrun_tool, []),
                               ("mptrac_tpu_torch", run_tool,
                                ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir(parents=True, exist_ok=True)
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = runner(mod.main, [tool] + [str(a) for a in argv_of(d)]
                        + extra)
        assert rc == 0, (pkg, tool)
        outs.append((d, buf.getvalue()))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


def _sample_atm(d, n=16):
    """Points over the three files' span, in no order, as an atm file."""
    rng = np.random.default_rng(3)
    rows = np.column_stack([rng.uniform(0, 43200, n),
                            rng.uniform(0.5, 30, n),
                            rng.uniform(-180, 180, n),
                            rng.uniform(-85, 85, n), np.ones(n),
                            np.zeros(n)])
    f = d / "points.tab"
    np.savetxt(f, rows, fmt="%.10g")
    return f


#: tool -> (arguments after the output file, given the met directory)
TEXT_TOOLS = {
    "met_map": lambda d: [metfile(d, 0), metfile(d, 1), "MAP_Z0", "7"],
    "met_map-theta": lambda d: [metfile(d, 1), "MAP_THETA", "350",
                                "MAP_DLON", "20", "MAP_DLAT", "20"],
    "met_prof": lambda d: [metfile(d, 0), metfile(d, 2), "PROF_LON0",
                           "-40", "PROF_LON1", "40", "PROF_LAT0", "-30",
                           "PROF_LAT1", "30", "PROF_DZ", "2"],
    "met_zm": lambda d: [metfile(d, 1), "ZM_DZ", "3", "ZM_DLAT", "20"],
    "met_sample": lambda d: [_sample_atm(d)],
    "met_lapse": lambda d: [metfile(d, 0), metfile(d, 2), "LAPSE_Z0", "2",
                            "LAPSE_Z1", "12", "LAPSE_LAT0", "-60",
                            "LAPSE_LAT1", "60"],
    "met_spec": lambda d: [metfile(d, 2), "SPEC_WAVEMAX", "5"],
    "met_subgrid": lambda d: [metfile(d, 0), metfile(d, 1)],
    "met_check_dt": lambda d: [metfile(d, 0), "DX", "50"],
}


@pytest.mark.parametrize("name", sorted(TEXT_TOOLS))
def test_met_tool_writes_the_jax_text(name, case, tmp_path):
    d, ctl = case
    tool = name.split("-")[0]
    jdir, tdir, _, _ = run_both(tool, lambda o: [
        ctl, o / "out.tab", *TEXT_TOOLS[name](d)], tmp_path)
    text = (tdir / "out.tab").read_text()
    differ = same_to_printed_precision((jdir / "out.tab").read_text(), text)
    print(name, "lines", len(text.splitlines()), "numbers that differ",
          differ)


@pytest.mark.parametrize("where", [(10.0, 20.0), (-95.0, -33.0)])
def test_cape_prints_the_jax_values(where, case, tmp_path):
    d, ctl = case
    _, _, jout, tout = run_both("cape", lambda o: [
        ctl, metfile(d, 1), *map(str, where)], tmp_path)
    assert "cape = " in tout
    same_to_printed_precision(jout, tout)


def test_tropo_writes_the_jax_product(case, tmp_path):
    """Every variable of the netCDF product, value for value (the
    tropopause search is numpy on the host in both packages)."""
    from scipy.io import netcdf_file
    d, ctl = case
    jdir, tdir, _, _ = run_both("tropo", lambda o: [
        ctl, o / "tropo.nc", metfile(d, 0), metfile(d, 1)], tmp_path)
    jnc = netcdf_file(str(jdir / "tropo.nc"), mmap=False)
    tnc = netcdf_file(str(tdir / "tropo.nc"), mmap=False)
    assert set(tnc.variables) == set(jnc.variables)
    assert "wmo_1st_p" in tnc.variables
    for k, v in jnc.variables.items():
        np.testing.assert_array_equal(tnc.variables[k][:], v[:],
                                      err_msg=k)
    assert np.isfinite(tnc.variables["wmo_1st_p"][:]).any()
    jnc.close()
    tnc.close()


@pytest.mark.parametrize("tool", ["met_map", "met_sample", "cape", "tropo"])
def test_device_tools_need_the_card_they_are_asked_for(tool, case,
                                                       tmp_path):
    """``--device cuda`` (the default) raises without a GPU: no tool
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, ctl = case
    mod = importlib.import_module(f"mptrac_tpu_torch.tools.{tool}")
    args = {"cape": [ctl, metfile(d, 0), "10", "20"],
            "met_sample": [ctl, tmp_path / "o.tab", _sample_atm(tmp_path)]
            }.get(tool, [ctl, tmp_path / "o", metfile(d, 0)])
    with pytest.raises(RuntimeError, match="device .cuda. requested"):
        mod.main([tool] + [str(a) for a in args])
