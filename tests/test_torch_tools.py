"""The port's command-line tools that run on the host
(``mptrac_tpu_torch.tools``) held against the JAX package's tools
(``mptrac_tpu.tools``): every tool keeps the CLI conventions of
``tests/test_tools.py``, and each host tool writes the JAX tool's output
file byte for byte from the same inputs, made from a numpy seed (the
calendar, NAT and sedimentation tools, atm_init, atm_split with
SPLIT_SEED, atm_conv through every format, atm_select, atm_stat,
atm_dist, atm2grid, the three tropopause-file tools, wind and met_conv).
The round trips of ``tests/test_tools.py`` are run on the port too."""

import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch

from mptrac_tpu.tools._cli import run_tool as jrun_tool
from mptrac_tpu_torch.tools._cli import run_tool

os.environ.setdefault("LOGLEV", "0")

#: the 29 tools of tests/test_tools.py
TOOLS = ["trac", "atm_init", "atm_split", "atm_conv", "atm_select",
         "atm_stat", "atm_dist", "atm2grid", "wind", "met_map",
         "met_prof", "met_zm", "met_sample", "met_conv", "time2jsec",
         "jsec2time", "day2doy", "doy2day", "tnat", "sedi", "cape",
         "tropo", "tropo_sample", "tropo_zm", "tropo_clim", "met_lapse",
         "met_subgrid", "met_check_dt", "met_spec"]


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


def both(tool, argv_of, tmp_path):
    """Run the JAX tool and the port's on ``argv_of(dir)`` with a
    directory each; returns (jax dir, port dir, jax stdout, port
    stdout)."""
    outs = []
    for pkg, runner in (("mptrac_tpu", jrun_tool),
                        ("mptrac_tpu_torch", run_tool)):
        d = tmp_path / pkg
        d.mkdir(parents=True, exist_ok=True)
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = runner(mod.main, [tool] + [str(a) for a in argv_of(d)])
        assert rc == 0, (pkg, tool)
        outs.append((d, buf.getvalue()))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


def same_files(jdir, tdir, *names):
    for name in names:
        jb = (jdir / name).read_bytes()
        tb = (tdir / name).read_bytes()
        assert len(jb) > 0 and tb == jb, name


def write_ctl(path, text):
    path.write_text(text)
    return path


def atm_rows(seed, n, nq, t0=0.0):
    """``time z lon lat q...`` rows of an ASCII particle file."""
    rng = np.random.default_rng(seed)
    rows = np.column_stack([
        t0 + rng.uniform(0, 3600, n), rng.uniform(2, 20, n),
        rng.uniform(-170, 170, n), rng.uniform(-70, 70, n)]
        + [rng.uniform(0.5, 2.0, n) for _ in range(nq)])
    return rows


def write_atm_tab(path, rows):
    np.savetxt(path, rows, fmt="%.10g")
    return path


@pytest.mark.parametrize("tool", TOOLS)
def test_cli_conventions(tool, capsys):
    """Every port tool fails without arguments and prints its usage with
    -h (reference tests/cli_test/run.sh)."""
    mod = importlib.import_module(f"mptrac_tpu_torch.tools.{tool}")
    rc = run_tool(mod.main, [tool])
    assert rc not in (0, None)
    rc = run_tool(mod.main, [tool, "-h"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Usage" in out or "usage" in out
    assert "mptrac_tpu_torch.tools." + tool in out


@pytest.mark.parametrize("tool,args", [
    ("time2jsec", ["2011", "6", "5", "13", "7", "9", "0.25"]),
    ("jsec2time", ["360547200.5"]),
    ("jsec2time", ["-86400.75"]),
    ("day2doy", ["2012", "12", "31"]),
    ("doy2day", ["2011", "156"]),
    ("tnat", ["50", "4e-6", "9e-9"]),
    ("sedi", ["300", "220", "5", "1500"]),
], ids=["time2jsec", "jsec2time", "jsec2time-neg", "day2doy", "doy2day",
        "tnat", "sedi"])
def test_printing_tools_print_the_jax_line(tool, args, tmp_path):
    _, _, jout, tout = both(tool, lambda d: args, tmp_path)
    assert jout and tout == jout


def test_calendar_tools(capsys):
    """tests/test_tools.py::test_calendar_tools on the port."""
    from mptrac_tpu_torch.tools import day2doy, doy2day, jsec2time, time2jsec
    run_tool(time2jsec.main,
             ["t", "2011", "6", "5", "0", "0", "0", "0"])
    t = float(capsys.readouterr().out)
    run_tool(jsec2time.main, ["j", str(t)])
    assert capsys.readouterr().out.split()[:3] == ["2011", "6", "5"]
    run_tool(day2doy.main, ["d", "2011", "6", "5"])
    assert capsys.readouterr().out.strip() == "156"
    run_tool(doy2day.main, ["d", "2011", "156"])
    assert capsys.readouterr().out.split() == ["6", "5"]


def test_kernel_weight_matches_jax(tmp_path):
    from mptrac_tpu.io import kernel as jkernel
    from mptrac_tpu_torch.io import kernel as tkernel
    kf = tmp_path / "kernel.tab"
    kf.write_text("2 0.1\n5 1.0\n9 0.5\n9 0.3\n14 0.0\n")
    kz, kw = tkernel.read_kernel(str(kf))
    p = np.random.default_rng(3).uniform(50, 1100, 500)
    np.testing.assert_array_equal(tkernel.kernel_weight(kz, kw, p),
                                  jkernel.kernel_weight(kz, kw, p))
    np.testing.assert_array_equal(tkernel.kernel_weight(None, None, p),
                                  np.ones_like(p))
    # the tensor version takes torch's log, which may end an ulp away
    np.testing.assert_allclose(
        tkernel.kernel_weight_t(kz, kw, torch.from_numpy(p)).numpy(),
        jkernel.kernel_weight(kz, kw, p), rtol=1e-12, atol=1e-15)


INIT_CASES = {
    "point": ["INIT_T0", "0", "INIT_T1", "0", "INIT_Z0", "10",
              "INIT_Z1", "10", "INIT_LON0", "-72", "INIT_LON1", "-72",
              "INIT_LAT0", "-40", "INIT_LAT1", "-40", "INIT_MASS", "1e9"],
    "scatter": ["INIT_T0", "0", "INIT_T1", "7200", "INIT_DT", "3600",
                "INIT_Z0", "5", "INIT_Z1", "15", "INIT_DZ", "5",
                "INIT_LON0", "-20", "INIT_LON1", "20", "INIT_DLON", "10",
                "INIT_LAT0", "-30", "INIT_LAT1", "30", "INIT_DLAT", "15",
                "INIT_ST", "600", "INIT_SZ", "0.5", "INIT_SLON", "1",
                "INIT_SLAT", "1", "INIT_SX", "50", "INIT_UT", "300",
                "INIT_UZ", "0.2", "INIT_ULON", "0.5", "INIT_ULAT", "0.5",
                "INIT_EVENLY", "1", "INIT_REP", "3", "INIT_MASS", "5e8",
                "INIT_VMR", "1e-9", "INIT_SEED", "17"],
    "bell": ["INIT_Z0", "8", "INIT_Z1", "8", "INIT_LON0", "-30",
             "INIT_LON1", "30", "INIT_DLON", "2", "INIT_LAT0", "-20",
             "INIT_LAT1", "20", "INIT_DLAT", "2", "INIT_BELLRAD", "2000",
             "INIT_IDX_OFFSET", "100", "INIT_ENS", "3"],
}


@pytest.mark.parametrize("atm_type", ["0", "1", "2"])
@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_atm_init_writes_the_jax_file(case, atm_type, tmp_path):
    """Each atm_init case (a point, every scatter option with INIT_SEED,
    the cosine bell) in ASCII, binary and netCDF."""
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 6\nQNT_NAME[0] = m\nQNT_NAME[1] = vmr\nQNT_NAME[2] = idx\n"
        "QNT_NAME[3] = aoa\nQNT_NAME[4] = ens\nQNT_NAME[5] = t\n"
        "METBASE = -\nT_STOP = 86400\n"))
    jdir, tdir, _, _ = both("atm_init", lambda d: [
        ctl, d / "init.out", *INIT_CASES[case],
        "ATM_TYPE_OUT", atm_type], tmp_path)
    same_files(jdir, tdir, "init.out")


SPLIT_CASES = {
    "mass": ["SPLIT_N", "300", "SPLIT_M", "1e9", "SPLIT_DX", "30",
             "SPLIT_DZ", "1", "SPLIT_DT", "600", "SPLIT_UM", "1e7"],
    "boxes": ["SPLIT_N", "200", "SPLIT_T0", "0", "SPLIT_T1", "3600",
              "SPLIT_Z0", "3", "SPLIT_Z1", "9", "SPLIT_LON0", "-10",
              "SPLIT_LON1", "10", "SPLIT_LAT0", "40", "SPLIT_LAT1", "50"],
    "kernel": ["SPLIT_N", "150", "SPLIT_DX", "10"],
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_atm_split_writes_the_jax_file(case, tmp_path):
    """A seeded split draws what the JAX tool draws, in its order: the
    mass-weighted source choice, the time and height scatter, the
    altitude kernel's rejection, the horizontal scatter."""
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 2\nQNT_NAME[0] = m\nQNT_NAME[1] = idx\nMETBASE = -\n"
        "T_STOP = 86400\n"))
    src = write_atm_tab(tmp_path / "src.tab", atm_rows(4, 40, 2))
    (tmp_path / "kernel.tab").write_text("2 0.1\n5 1.0\n9 0.5\n14 0.0\n")
    extra = (["SPLIT_KERNEL", str(tmp_path / "kernel.tab")]
             if case == "kernel" else [])
    jdir, tdir, _, _ = both("atm_split", lambda d: [
        ctl, src, d / "split.tab", *SPLIT_CASES[case], *extra,
        "SPLIT_SEED", "42"], tmp_path)
    same_files(jdir, tdir, "split.tab")


def test_atm_init_split_roundtrip(tmp_path):
    """tests/test_tools.py::test_atm_init_split_roundtrip on the port:
    one parcel, split into 500 with the mass kept and the scatter of
    SPLIT_DX / SPLIT_DZ, then ASCII -> binary -> ASCII."""
    from mptrac_tpu_torch.tools import atm_conv, atm_init, atm_split
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 2\nQNT_NAME[0] = m\nQNT_NAME[1] = idx\n"
        "METBASE = -\nT_STOP = 86400\n"))
    init = tmp_path / "init.tab"
    rc = run_tool(atm_init.main, ["atm_init", str(ctl), str(init),
                                  *INIT_CASES["point"]])
    assert rc == 0
    rows = np.loadtxt(init)
    assert rows.ndim == 1 and rows[2] == -72 and rows[3] == -40

    split = tmp_path / "split.tab"
    rc = run_tool(atm_split.main, [
        "atm_split", str(ctl), str(init), str(split),
        "SPLIT_N", "500", "SPLIT_M", "1e9", "SPLIT_DX", "30",
        "SPLIT_DZ", "1", "SPLIT_SEED", "42"])
    assert rc == 0
    rows = np.loadtxt(split)
    assert rows.shape[0] == 500
    np.testing.assert_allclose(rows[:, 4].sum(), 1e9, rtol=1e-9)
    assert 0.1 < np.std(rows[:, 2]) < 0.25
    assert 0.35 < np.std(rows[:, 1]) < 0.55

    binf = tmp_path / "split.bin"
    asc2 = tmp_path / "split2.tab"
    run_tool(atm_conv.main, ["atm_conv", str(ctl), str(split), "0",
                             str(binf), "1"])
    run_tool(atm_conv.main, ["atm_conv", str(ctl), str(binf), "1",
                             str(asc2), "0"])
    rows2 = np.loadtxt(asc2)
    np.testing.assert_allclose(rows2[:, :4], rows[:, :4], rtol=1e-6)


@pytest.mark.parametrize("chain", [("0", "1", "0"), ("0", "2", "4", "0"),
                                   ("0", "3", "0")],
                         ids=["bin", "nc-clams", "clams3"])
def test_atm_conv_chain_writes_the_jax_files(chain, tmp_path):
    """Every file of a conversion chain is the JAX tool's."""
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 2\nQNT_NAME[0] = m\nQNT_NAME[1] = t\nMETBASE = -\n"
        "T_STOP = 1\n"))
    src = write_atm_tab(tmp_path / "a.tab", atm_rows(8, 25, 2))
    names = []
    prev, prev_type = src, chain[0]
    for k, typ in enumerate(chain[1:]):
        name = f"step{k}.t{typ}"
        p_, pt = prev, prev_type
        jdir, tdir, _, _ = both("atm_conv", lambda d: [
            ctl, p_ if k == 0 else d / p_, pt, d / name, typ], tmp_path)
        names.append(name)
        prev, prev_type = name, typ
    same_files(jdir, tdir, *names)


def test_atm_nc_clams_roundtrip(tmp_path):
    """tests/test_tools.py::test_atm_nc_clams_roundtrip on the port."""
    from mptrac_tpu_torch.tools import atm_conv
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 1\nQNT_NAME[0] = m\nMETBASE = -\nT_STOP = 1\n"))
    asc = tmp_path / "a.tab"
    asc.write_text("0.0 10.0 -72.0 -40.0 5.0\n0.0 12.0 -70.0 -42.0 7.0\n")
    ncf = tmp_path / "a.nc"
    clams = tmp_path / "a_clams.nc"
    asc2 = tmp_path / "a2.tab"
    run_tool(atm_conv.main, ["atm_conv", str(ctl), str(asc), "0",
                             str(ncf), "2"])
    run_tool(atm_conv.main, ["atm_conv", str(ctl), str(ncf), "2",
                             str(clams), "4"])
    run_tool(atm_conv.main, ["atm_conv", str(ctl), str(clams), "4",
                             str(asc2), "0"])
    np.testing.assert_allclose(np.loadtxt(asc2), np.loadtxt(asc),
                               rtol=1e-12)


@pytest.mark.parametrize("select", [
    ["SELECT_STRIDE", "3"],
    ["SELECT_IP0", "5", "SELECT_IP1", "40", "SELECT_T0", "100",
     "SELECT_T1", "3000", "SELECT_Z0", "4", "SELECT_Z1", "15"],
    ["SELECT_LON0", "-90", "SELECT_LON1", "90", "SELECT_LAT0", "-40",
     "SELECT_LAT1", "60", "SELECT_R0", "0", "SELECT_R1", "6000",
     "SELECT_LON", "10", "SELECT_LAT", "20"],
], ids=["stride", "index-time-height", "box-radius"])
def test_atm_select_writes_the_jax_file(select, tmp_path):
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 1\nQNT_NAME[0] = m\nMETBASE = -\nT_STOP = 1\n"))
    f1 = write_atm_tab(tmp_path / "a1.tab", atm_rows(1, 60, 1))
    f2 = write_atm_tab(tmp_path / "a2.tab", atm_rows(2, 50, 1))
    jdir, tdir, _, _ = both("atm_select", lambda d: [
        ctl, d / "sel.tab", f1, f2, *select], tmp_path)
    same_files(jdir, tdir, "sel.tab")


def _stat_files(tmp_path, nq):
    """Three particle files of one parcel set an hour apart."""
    base = atm_rows(5, 80, nq)
    files = []
    for h in range(3):
        rows = base.copy()
        rows[:, 2] += 2.0 * h
        rows[:, 1] += 0.3 * h
        files.append(write_atm_tab(
            tmp_path / f"atm_2011_06_05_{h:02d}_00_00.tab", rows))
    return files


@pytest.mark.parametrize("param", ["mean", "stddev", "min", "max", "skew",
                                   "kurt", "median", "absdev", "mad"])
def test_atm_stat_writes_the_jax_file(param, tmp_path):
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 2\nQNT_NAME[0] = m\nQNT_NAME[1] = ens\nMETBASE = -\n"
        "T_STOP = 1\n"))
    files = _stat_files(tmp_path, 2)
    jdir, tdir, _, _ = both("atm_stat", lambda d: [
        ctl, d / "stat.tab", param, *files, "STAT_Z0", "3", "STAT_Z1",
        "19", "STAT_LAT0", "-60"], tmp_path)
    same_files(jdir, tdir, "stat.tab")


@pytest.mark.parametrize("param", ["mean", "stddev", "min", "max",
                                   "median"])
def test_atm_dist_writes_the_jax_file(param, tmp_path):
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 1\nQNT_NAME[0] = m\nMETBASE = -\nT_STOP = 1\n"))
    files = _stat_files(tmp_path, 1)
    rng = np.random.default_rng(9)
    pairs = []
    for f in files:
        rows = np.loadtxt(f)
        rows[:, 1:5] += rng.normal(0, 0.2, (rows.shape[0], 4))
        other = tmp_path / ("b_" + os.path.basename(f))
        write_atm_tab(other, rows)
        pairs += [f, other]
    jdir, tdir, _, _ = both("atm_dist", lambda d: [
        ctl, d / "dist.tab", param, *pairs, "DIST_ZSCORE", "3",
        "DIST_REL_MIN", "0.1"], tmp_path)
    same_files(jdir, tdir, "dist.tab")


def test_atm_stat(tmp_path):
    """tests/test_tools.py::test_atm_stat on the port."""
    from mptrac_tpu_torch.tools import atm_stat
    ctl = write_ctl(tmp_path / "c.ctl",
                    "NQ = 0\nMETBASE = -\nT_STOP = 86400\n")
    atmf = tmp_path / "atm_2011_06_05_00_00_00.tab"
    atmf.write_text("0.0 10.0 -72.0 -40.0\n0.0 12.0 -70.0 -42.0\n")
    out = tmp_path / "stat.tab"
    assert run_tool(atm_stat.main, ["atm_stat", str(ctl), str(out),
                                    "mean", str(atmf)]) == 0
    rows = np.loadtxt(out)
    assert rows[2] == pytest.approx(11.0)
    assert rows[3] == pytest.approx(-71.0)
    assert int(rows[-1]) == 2


def test_atm2grid_writes_the_jax_file(tmp_path):
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 1\nQNT_NAME[0] = m\nMETBASE = -\nT_STOP = 1\n"
        "GRID_NX = 12\nGRID_NY = 6\nGRID_NZ = 4\nGRID_Z0 = 0\n"
        "GRID_Z1 = 20\nGRID_LON0 = -180\nGRID_LON1 = 180\n"
        "GRID_LAT0 = -90\nGRID_LAT1 = 90\nDT_MOD = 7200\n"))
    rows = atm_rows(6, 300, 1, t0=360547200.0 - 1800.0)
    f = write_atm_tab(tmp_path / "atm_2011_06_05_00_00_00.tab", rows)
    jdir, tdir, _, _ = both("atm2grid", lambda d: [
        ctl, f, "GRID_BASENAME", d / "grid"], tmp_path)
    same_files(jdir, tdir, "grid_2011_06_05_00_00_00.tab")


def _tropo_file(path, seed, t0):
    """A tropopause product as the tropo tool writes it (two times,
    NaN columns)."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    lat = np.linspace(-90, 90, 19)
    lon = np.linspace(-180, 170, 36)
    nc = netcdf_file(str(path), "w")
    nc.createDimension("time", None)
    nc.createDimension("lat", lat.size)
    nc.createDimension("lon", lon.size)
    nc.createVariable("time", "d", ("time",))[:] = [t0, t0 + 21600.0]
    nc.createVariable("lat", "d", ("lat",))[:] = lat
    nc.createVariable("lon", "d", ("lon",))[:] = lon
    v = rng.uniform(80, 300, (2, lat.size, lon.size)).astype(np.float32)
    v[rng.random(v.shape) < 0.1] = np.nan
    nc.createVariable("wmo_1st_p", "f", ("time", "lat", "lon"))[:] = v
    nc.close()
    return path


def test_tropo_file_tools_write_the_jax_files(tmp_path):
    """tropo_sample, tropo_zm and tropo_clim on a tropopause product."""
    ctl = write_ctl(tmp_path / "c.ctl", (
        "NQ = 1\nQNT_NAME[0] = m\nMETBASE = -\nT_STOP = 1\n"))
    f1 = _tropo_file(tmp_path / "tropo1.nc", 1, 0.0)
    f2 = _tropo_file(tmp_path / "tropo2.nc", 2, 43200.0)
    atm = write_atm_tab(tmp_path / "a.tab", atm_rows(7, 50, 1) * np.array(
        [6.0, 1, 1, 1, 1]))
    for tool, argv in (
            ("tropo_sample", lambda d: [ctl, d / "out.tab", f1,
                                        "wmo_1st_p", atm]),
            ("tropo_zm", lambda d: [ctl, d / "out.tab", "wmo_1st_p", f1]),
            ("tropo_clim", lambda d: [ctl, d / "out.tab", "wmo_1st_p",
                                      f1, f2])):
        jdir, tdir, _, _ = both(tool, argv, tmp_path / tool)
        same_files(jdir, tdir, "out.tab")


def test_wind_tool_and_met_roundtrip(tmp_path):
    """tests/test_tools.py::test_wind_tool_and_met_roundtrip on the
    port, and both tools' files the JAX tools' byte for byte: wind's
    netCDF file and met_conv's containers (raw, packed, LZ4) and its
    netCDF copy."""
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    ctl_file = write_ctl(tmp_path / "c.ctl",
                         "NQ = 0\nMETBASE = -\nT_STOP = 86400\n")
    jdir, tdir, jout, tout = both("wind", lambda d: [
        ctl_file, d / "wind", "WIND_NX", "36", "WIND_NY", "19",
        "WIND_NZ", "8", "WIND_ALPHA", "20", "WIND_W0", "1e-3",
        "WIND_TEMP1", "220"], tmp_path)
    same_files(jdir, tdir, "wind_2000_01_01_00.nc")
    assert tout == jout.replace(str(jdir), str(tdir))
    metfile = tdir / "wind_2000_01_01_00.nc"

    ctl = read_ctl(str(ctl_file), ["MET_TROPO", "0", "MET_CAPE", "0",
                                   "MET_PBL", "3"])
    met = read_met(str(metfile), ctl, device="cpu")
    u = met.fields3d["u"].numpy()
    iy_eq = np.argmin(np.abs(met.lat.numpy()))
    assert abs(u[5, iy_eq, 3] - 38.5876 * np.cos(np.deg2rad(20))) < 0.01

    for met_type, tol in ((0, 0.0), (1, 0.0), (2, 1e-3), (8, 0.0)):
        name = f"wind.t{met_type}.bin"
        jdir, tdir, _, _ = both("met_conv", lambda d: [
            ctl_file, metfile, "0", d / name, met_type, "MET_TROPO", "0",
            "MET_CAPE", "0"], tmp_path)
        same_files(jdir, tdir, name)
        if met_type == 0:
            continue
        ctl_bin = read_ctl(str(ctl_file), ["MET_TYPE", str(met_type)])
        met2 = read_met(str(tdir / name), ctl_bin, device="cpu")
        np.testing.assert_allclose(met2.fields3d["u"].numpy(), u,
                                   atol=max(tol * 40, 1e-6))
