"""The output writers of the port (``mptrac_tpu_torch.io.writers`` and
``io.output.OutputManager``) against the JAX package's, file by file.

Both packages get the same float64 state, made with numpy from a seed,
on a small synthetic met pair with a temperature lapse and non-zero
H2O and O3 (what the grid, profile and sample writers interpolate).
Some parcels are dead (beyond ``np``), some lie outside the output time
window, and a few sit just below the first cell edge of each axis,
where the grid writer (floor) drops them and the CSI and profile writers
(truncation) put them into cell 0.  The quantities are printed with
``%.17g``, so the files hold every digit the writers computed.

Tolerances.  Headers and every non-numeric token must be equal as text.
Numbers: rtol 1e-12, atol 0.  Both sides do the same float64 operations;
they differ by the order in which ``index_add_`` and ``np.bincount`` or
XLA add a cell's parcels (a few ulp of a sum) and by the math libraries'
log, exp, sin and cos (an ulp).  The ensemble writer's sigma columns are
``sqrt(E[q^2] - E[q]^2)``: the JAX writer sums with numpy's pairwise
``np.mean``, the port with ``index_add_`` in float64, and the difference
of the two means amplifies their ulps by ``E[q^2] / var`` (here below
1e3); they are held to rtol 1e-9 (measured: 2.7e-14; every other number
of every file 9.3e-16 or equal).  Counts are exact.
"""

import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import to_torch
from mptrac_tpu.config import read_ctl as jread_ctl
from mptrac_tpu.io import kernel as jkernel
from mptrac_tpu.io import obs as jobs
from mptrac_tpu.io import output as joutput
from mptrac_tpu.io import writers as jw
from mptrac_tpu.met.synthetic import make_wind_met as jwind
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu.types import stack_met as jstack
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.io import kernel as tkernel
from mptrac_tpu_torch.io import obs as tobs
from mptrac_tpu_torch.io import output as toutput
from mptrac_tpu_torch.io import writers as tw

NPMAX = 900
NP = 860                       # live parcels; the rest are padding
T0 = 360547200.0 + 1800.0      # 2011-06-05 00:30 UTC
DT_MOD = 120.0
QNT = ("t", "m", "stat", "ens", "aoa")
RTOL = 1e-12
RTOL_SIGMA = 1e-9
#: grid of the grid, CSI and profile writers (a coarse global grid)
GRID = dict(LON0=-180.0, LON1=180.0, NX=12, LAT0=-90.0, LAT1=90.0, NY=9,
            Z0=0.0, Z1=50.0, NZ=5)


def _ctl_args(extra=()):
    args = ["NQ", str(len(QNT))]
    for i, name in enumerate(QNT):
        args += [f"QNT_NAME[{i}]", name, f"QNT_FORMAT[{i}]", "%.17g"]
    args += ["METBASE", "-", "DT_MOD", str(DT_MOD), "MOLMASS", "64.066",
             "CSI_OBSMIN", "1e-5", "CSI_MODMIN", "1e-13", "SAMPLE_DZ", "2",
             "SAMPLE_DX", "800", "STAT_LON", "20", "STAT_LAT", "10",
             "STAT_R", "3000", "CSI_DT_OUT", str(2 * DT_MOD)]
    for pre in ("GRID", "CSI", "PROF"):
        for k, v in GRID.items():
            args += [f"{pre}_{k}", str(v)]
    return list(extra) + args


def _ctls(*extra):
    args = _ctl_args(extra)
    return jread_ctl(None, args), tread_ctl(None, args)


def _obs_rows(rng, n=120):
    """Observations in the windows of the steps from T0 on (and one
    later), a few outside the grid and a few NaN values."""
    t = np.sort(T0 + rng.choice([-30.0, 0.0, 20.0, DT_MOD - 10.0, DT_MOD,
                                 DT_MOD + 40.0, 2 * DT_MOD + 5.0,
                                 3 * DT_MOD, 5 * DT_MOD], n))
    lon = rng.uniform(-185.0, 185.0, n)
    lat = rng.uniform(-89.0, 89.0, n)
    z = rng.uniform(-1.0, 52.0, n)
    obs = 10.0 ** rng.uniform(-7.0, -3.0, n)
    obs[rng.random(n) < 0.05] = np.nan
    return t, z, lon, lat, obs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of parcels: more intra-op threads would only spin, on the
    cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("torch_output")
    met01 = jstack(
        jwind(t0=T0 - 1800.0, nx=36, ny=19, nz=8, alpha=30.0, temp0=290.0,
              temp1=210.0, q=1e-3, o3=3e-7),
        jwind(t0=T0 + 1800.0, nx=36, ny=19, nz=8, alpha=30.0, temp0=291.0,
              temp1=212.0, q=1.2e-3, o3=3.3e-7))

    def u(lo, hi):
        return rng.uniform(lo, hi, NPMAX)

    lon, lat = u(-180.0, 180.0), u(-89.0, 89.0)
    p = np.exp(u(np.log(2.0), np.log(1010.0)))
    # a few parcels half a cell below the first edge of each axis
    dlon = (GRID["LON1"] - GRID["LON0"]) / GRID["NX"]
    dlat = (GRID["LAT1"] - GRID["LAT0"]) / GRID["NY"]
    dz = (GRID["Z1"] - GRID["Z0"]) / GRID["NZ"]
    lon[:6] = GRID["LON0"] - 0.5 * dlon
    lat[6:12] = GRID["LAT0"] - 0.5 * dlat
    p[12:18] = 1013.25 * np.exp((0.5 * dz - GRID["Z0"]) / 7.0)
    q = dict(t=u(200.0, 300.0), m=u(0.5, 2.0),
             stat=(rng.random(NPMAX) < 0.1) * 1.0,
             ens=rng.integers(0, 4, NPMAX) * 1.0, aoa=u(0.0, 1e6))
    time = T0 + rng.choice([0.0, 0.0, 0.0, 45.0, -90.0, 300.0], NPMAX)
    jatm = JAtm(time=jnp.asarray(time), p=jnp.asarray(p),
                lon=jnp.asarray(lon), lat=jnp.asarray(lat),
                q={k: jnp.asarray(v) for k, v in q.items()},
                np=jnp.asarray(NP, jnp.int32))
    tatm, _, tmet, _ = to_torch(atm=jatm, met01=met01)

    obsfile = tmp / "obs.tab"
    np.savetxt(obsfile, np.stack(_obs_rows(rng), axis=-1), fmt="%.10g")
    kernfile = tmp / "kernel.tab"
    np.savetxt(kernfile, np.array([[0.0, 0.2], [5.0, 1.0], [10.0, 3.0],
                                   [10.0, 2.0], [30.0, 0.5]]), fmt="%g")
    return dict(tmp=tmp, jatm=jatm, tatm=tatm,
                jmet=types.SimpleNamespace(pair=met01),
                tmet=types.SimpleNamespace(pair=tmet),
                obs=str(obsfile), kernel=str(kernfile))


def _fresh(case):
    """A copy of the two states (the station writers set flags: the
    JAX one replaces the array in its state's dict, the port's writes
    into the tensor)."""
    ja, ta = case["jatm"], case["tatm"]
    return (ja.replace(q=dict(ja.q)),
            ta.replace(q={k: v.clone() for k, v in ta.q.items()}))


def _num(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


def assert_files_agree(ours, ref, rtol=RTOL, col_rtol=None):
    """Same text outside the numbers, numbers at ``rtol`` (per column
    from ``col_rtol``), NaN where the reference has NaN."""
    with open(ours) as a, open(ref) as b:
        la, lb = a.read().split("\n"), b.read().split("\n")
    assert len(la) == len(lb), f"{ref}: {len(la)} lines vs {len(lb)}"
    worst = 0.0
    for i, (x, y) in enumerate(zip(la, lb)):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), f"{ref} line {i}: {x!r} vs {y!r}"
        for c, (s, r) in enumerate(zip(tx, ty)):
            if not (_num(s) and _num(r)):
                assert s == r, f"{ref} line {i}: {x!r} vs {y!r}"
                continue
            fs, fr = float(s), float(r)
            tol = (col_rtol or {}).get(c, rtol)
            if np.isnan(fr) or fs == fr:
                assert np.isnan(fs) == np.isnan(fr), f"{ref} line {i}"
                continue
            rel = abs(fs - fr) / abs(fr) if fr else abs(fs)
            worst = max(worst, rel)
            assert rel <= tol, (f"{ref} line {i} column {c}: {s} vs {r} "
                                f"(rel {rel:.2e} > {tol:.0e})")
    print(f"{os.path.basename(ref)}: {len(lb)} lines, max rel diff "
          f"{worst:.2e}")
    return la


# ------------------------------------------------------------ readers

def test_read_obs_ascii_and_netcdf(case, tmp_path):
    jctl, tctl = _ctls()
    ja = jobs.read_obs(case["obs"], jctl)
    ta = tobs.read_obs(case["obs"], tctl)
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(x, y)
    assert ta[0].size == 120 and np.isnan(ta[4]).any()
    from scipy.io import netcdf_file
    ncf = str(tmp_path / "obs.nc")
    nc = netcdf_file(ncf, "w")
    nc.createDimension("nobs", ja[0].size)
    for name, v in zip(("time", "alt", "lon", "lat", "obs"), ja):
        nc.createVariable(name, "d", ("nobs",))[:] = v
    nc.close()
    jctl, tctl = _ctls("OBS_TYPE", "1")
    for x, y in zip(tobs.read_obs(ncf, tctl), jobs.read_obs(ncf, jctl)):
        np.testing.assert_array_equal(x, y)
    bad = tmp_path / "bad.tab"
    bad.write_text("10 1 2 3 4\n5 1 2 3 4\n")
    jctl, tctl = _ctls()
    for reader, ctl in ((jobs.read_obs, jctl), (tobs.read_obs, tctl)):
        with pytest.raises(ValueError, match="ascending"):
            reader(str(bad), ctl)
    with pytest.raises(ValueError, match="OBS_TYPE"):
        tobs.read_obs(case["obs"], tctl.replace(obs_type=2))


def test_read_kernel_and_weight(case, tmp_path):
    """The kernel file (normalized by its maximum, a repeated height)
    and its weight at pressures below, on and above the table's
    heights, as a tensor, against the JAX reader and its ``np.interp``
    weight."""
    jz, jwt = jkernel.read_kernel(case["kernel"])
    tz, twt = tkernel.read_kernel(case["kernel"])
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(twt, jwt)
    z = np.concatenate([np.linspace(-3.0, 40.0, 301), jz])
    p = 1013.25 * np.exp(-z / 7.0)
    want = jkernel.kernel_weight(jz, jwt, p)
    got = tkernel.kernel_weight_t(tz, twt, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got[0] == jwt[0] and got[300] == jwt[-1]
    np.testing.assert_array_equal(
        tkernel.kernel_weight_t(None, None, torch.from_numpy(p)).numpy(),
        np.ones_like(p))
    bad = tmp_path / "bad.tab"
    bad.write_text("0 1\n5 2\n4 3\n")
    with pytest.raises(ValueError, match="ascending"):
        tkernel.read_kernel(str(bad))


# ------------------------------------------------------------ writers

@pytest.mark.parametrize("extra", [
    (), ("GRID_TYPE", "1"), ("GRID_SPARSE", "1", "GRID_STDDEV", "1"),
    ("KERNEL",), ("GRID_TYPE", "1", "GRID_STDDEV", "1")],
    ids=["asc", "nc", "sparse_stddev", "kernel", "nc_stddev"])
def test_grid_writer(case, tmp_path, extra):
    if extra == ("KERNEL",):
        extra = ("GRID_KERNEL", case["kernel"])
    jctl, tctl = _ctls(*extra)
    ja, ta = _fresh(case)
    ext = "nc" if jctl.grid_type == 1 else "tab"
    fj, ft = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    jw.GridWriter(jctl).write(str(fj), case["jmet"], ja, T0)
    tw.GridWriter(tctl).write(str(ft), case["tmet"], ta, T0)
    if ext == "tab":
        lines = assert_files_agree(ft, fj)
        assert sum(1 for x in lines if x and not x.startswith("#")) > 0
        return
    from scipy.io import netcdf_file
    a, b = netcdf_file(str(ft), mmap=False), netcdf_file(str(fj), mmap=False)
    assert set(a.variables) == set(b.variables)
    assert a.dimensions == b.dimensions
    for name, v in b.variables.items():
        x, y = a.variables[name][:], v[:]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert a.variables[name].units == v.units, name
        if name == "np":
            np.testing.assert_array_equal(x, y)
            assert y.sum() > 0
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=name)
    a.close()
    b.close()


def test_grid_writer_gnuplot_pipe(case, tmp_path, monkeypatch):
    """``GRID_GPFILE``: the table goes into the gnuplot pipe (here a
    stand-in that keeps what it is sent), the same text in both
    packages."""
    import mptrac_tpu.io.atm_io as jatm_io
    import mptrac_tpu_torch.io.atm_io as tatm_io
    sent = {}

    def fake_pipe(tag):
        def pipe(gpfile, filename, t):
            proc = types.SimpleNamespace(stdin=open(tmp_path / tag, "w"))
            proc.wait = lambda: 0
            sent[tag] = (gpfile, filename, t)
            return proc
        return pipe

    monkeypatch.setattr(jatm_io, "_gnuplot_pipe", fake_pipe("jax"))
    monkeypatch.setattr(tatm_io, "_gnuplot_pipe", fake_pipe("torch"))
    jctl, tctl = _ctls("GRID_GPFILE", "plot.gp")
    ja, ta = _fresh(case)
    jw.GridWriter(jctl).write("grid_j", case["jmet"], ja, T0)
    tw.GridWriter(tctl).write("grid_t", case["tmet"], ta, T0)
    assert sent["torch"] == ("plot.gp", "grid_t", T0)
    assert not os.path.exists("grid_t")
    assert_files_agree(tmp_path / "torch", tmp_path / "jax")


def test_grid_empty_window(case, tmp_path):
    """No parcel in the window: every cell empty, the same file."""
    jctl, tctl = _ctls()
    ja, ta = _fresh(case)
    t = T0 + 100 * DT_MOD
    jw.GridWriter(jctl).write(str(tmp_path / "j.tab"), case["jmet"], ja, t)
    tw.GridWriter(tctl).write(str(tmp_path / "t.tab"), case["tmet"], ta, t)
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab")
    assert all(x.split()[8] == "0" for x in lines
               if x and not x.startswith("#"))


def test_cell_edges_floor_and_truncation(case):
    """Half a cell below the first edge: the grid writer floors the
    parcel out of the grid, the CSI and profile writers truncate it
    into cell 0, on each axis (the parcels the fixture puts there)."""
    tctl = _ctls()[1]
    ta = case["tatm"]
    ok = torch.ones(NPMAX, dtype=torch.bool)
    dims = (tctl.csi_lon0, (tctl.csi_lon1 - tctl.csi_lon0) / tctl.csi_nx,
            tctl.csi_nx, tctl.csi_lat0,
            (tctl.csi_lat1 - tctl.csi_lat0) / tctl.csi_ny, tctl.csi_ny,
            tctl.csi_z0, (tctl.csi_z1 - tctl.csi_z0) / tctl.csi_nz,
            tctl.csi_nz)
    for sl, x, (x0, dx, n) in ((slice(0, 6), ta.lon, dims[0:3]),
                               (slice(6, 12), ta.lat, dims[3:6]),
                               (slice(12, 18), tw._z(ta.p), dims[6:9])):
        i_f, ok_f = tw._axis_cells(x[sl], x0, dx, n, ok[sl], torch.floor)
        i_t, ok_t = tw._axis_cells(x[sl], x0, dx, n, ok[sl], torch.trunc)
        assert not ok_f.any() and ok_t.all() and (i_t == 0).all()
        # numpy's astype(int), as the JAX writers index
        host = ((x[sl].numpy() - x0) / dx).astype(int)
        assert (host == 0).all()


def test_ens_writer(case, tmp_path):
    jctl, tctl = _ctls()
    ja, ta = _fresh(case)
    jw.EnsWriter(jctl).write(str(tmp_path / "j.tab"), ja, T0)
    tw.EnsWriter(tctl).write(str(tmp_path / "t.tab"), ta, T0)
    sigma = {4 + len(QNT) + i: RTOL_SIGMA for i in range(len(QNT))}
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab",
                               col_rtol=sigma)
    assert sum(1 for x in lines if x and not x.startswith("#")) == 4


def test_ens_writer_raises_on_negative_ids(case, tmp_path):
    tctl = _ctls()[1]
    _, ta = _fresh(case)
    ta.q["ens"][3] = -1.0
    with pytest.raises(ValueError, match="Ensemble ID is out of range"):
        tw.EnsWriter(tctl).write(str(tmp_path / "t.tab"), ta, T0)
    # outside the time window a negative ID is no matter
    ta.q["ens"][3] = 0.0
    ta.q["ens"][int(np.argmax(np.asarray(case["jatm"].time) > T0 + 200))] \
        = -1.0
    tw.EnsWriter(tctl).write(str(tmp_path / "t.tab"), ta, T0)
    with pytest.raises(ValueError, match="Missing ensemble IDs"):
        tw.EnsWriter(tctl.replace(qnt_name=("t", "m")))


def test_station_writer_sets_the_flag_on_the_device_state(case, tmp_path):
    """Two writes, the second 300 s later: rows and flags as in the JAX
    writer.  The flag is set in place on the port's state tensor; a
    parcel flagged by the first write is not printed again."""
    jctl, tctl = _ctls()
    ja, ta = _fresh(case)
    stat_before = ta.q["stat"].clone()
    stat_tensor = ta.q["stat"]
    js = jw.StationWriter(jctl, str(tmp_path / "j.tab"))
    ts = tw.StationWriter(tctl, str(tmp_path / "t.tab"))
    for t in (T0, T0 + 300.0):
        js.write(ja, t)
        ts.write(ta, t)
    js.close()
    ts.close()
    assert ta.q["stat"] is stat_tensor
    flagged = (ta.q["stat"] == 1) & (stat_before == 0)
    assert flagged.any()
    np.testing.assert_array_equal(ta.q["stat"][:NP].numpy(),
                                  np.asarray(ja.q["stat"])[:NP])
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab")
    rows = [x.split() for x in lines if x and not x.startswith("#")]
    assert len(rows) == int(flagged.sum())
    assert all(r[4 + QNT.index("stat")] == "1" for r in rows)
    # a third write finds nobody left to flag at the first time
    n = len(rows)
    ts2 = tw.StationWriter(tctl, str(tmp_path / "t2.tab"))
    ts2.write(ta, T0)
    ts2.close()
    assert sum(1 for x in open(tmp_path / "t2.tab")
               if x.strip() and not x.startswith("#")) == 0 < n


@pytest.mark.parametrize("extra", [(), ("VTK_SPHERE", "1", "VTK_STRIDE",
                                        "3", "VTK_SCALE", "2",
                                        "VTK_OFFSET", "1.5")],
                         ids=["plain", "sphere_stride"])
def test_vtk_writer(case, tmp_path, extra):
    jctl, tctl = _ctls(*extra)
    ja, ta = _fresh(case)
    jw.VtkWriter(jctl).write(str(tmp_path / "j.vtk"), ja, T0)
    tw.VtkWriter(tctl).write(str(tmp_path / "t.vtk"), ta, T0)
    lines = assert_files_agree(tmp_path / "t.vtk", tmp_path / "j.vtk")
    assert lines[4].startswith("POINTS") and int(lines[4].split()[1]) > 0


@pytest.mark.parametrize("extra", [(), ("NENS", "4"), ("KERNEL",)],
                         ids=["single", "ensemble", "kernel"])
def test_csi_writer_flushes_across_outputs(case, tmp_path, extra):
    """Five steps from T0 with ``CSI_DT_OUT`` two steps: counts
    accumulate over two steps and are written and reset at each output
    time (T0 + DT_MOD and T0 + 3 DT_MOD)."""
    if extra == ("KERNEL",):
        extra = ("CSI_KERNEL", case["kernel"])
    jctl, tctl = _ctls("CSI_OBSFILE", case["obs"], *extra)
    ja, ta = _fresh(case)
    js = jw.CsiWriter(jctl, str(tmp_path / "j.tab"))
    ts = tw.CsiWriter(tctl, str(tmp_path / "t.tab"))
    assert math.fmod(T0 + DT_MOD, 2 * DT_MOD) == 0
    for k in range(5):
        js.write(ja, T0 + k * DT_MOD)
        ts.write(ta, T0 + k * DT_MOD)
    js.close()
    ts.close()
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab")
    rows = [x.split() for x in lines if x and not x.startswith("#")]
    assert len(rows) == 2 * (4 if jctl.nens else 1)
    assert any(int(r[2]) > 0 for r in rows)


def test_prof_writer(case, tmp_path):
    jctl, tctl = _ctls("PROF_OBSFILE", case["obs"])
    ja, ta = _fresh(case)
    js = jw.ProfWriter(jctl, str(tmp_path / "j.tab"))
    ts = tw.ProfWriter(tctl, str(tmp_path / "t.tab"))
    for t in (T0, T0 + DT_MOD, T0 + 50 * DT_MOD):
        js.write(case["jmet"], ja, t)
        ts.write(case["tmet"], ta, t)
    js.close()
    ts.close()
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab")
    rows = [x.split() for x in lines if x and not x.startswith("#")]
    assert len(rows) >= GRID["NZ"] and rows[0][7] != "0"


@pytest.mark.parametrize("extra", [(), ("KERNEL",), ("SAMPLE_DZ", "-1")],
                         ids=["layer", "kernel", "no_layer"])
def test_sample_writer(case, tmp_path, extra):
    if extra == ("KERNEL",):
        extra = ("SAMPLE_KERNEL", case["kernel"])
    jctl, tctl = _ctls("SAMPLE_OBSFILE", case["obs"], *extra)
    ja, ta = _fresh(case)
    js = jw.SampleWriter(jctl, str(tmp_path / "j.tab"))
    ts = tw.SampleWriter(tctl, str(tmp_path / "t.tab"))
    for t in (T0, T0 + DT_MOD, T0 + 50 * DT_MOD):
        js.write(case["jmet"], ja, t)
        ts.write(case["tmet"], ta, t)
    js.close()
    ts.close()
    lines = assert_files_agree(tmp_path / "t.tab", tmp_path / "j.tab")
    rows = [x.split() for x in lines if x and not x.startswith("#")]
    assert rows and any(int(r[6]) > 0 for r in rows)


def test_sample_writer_finds_every_parcel_near_a_point(tmp_path):
    """The hash of the sample writer against a brute-force search: parcels
    placed just inside and just outside the search radius around points
    near a pole, on the date line and on the equator, at a radius that
    makes the cubes small (the table's size limit)."""
    rng = np.random.default_rng(3)
    pts = np.array([[179.9, 0.0], [-180.0, 89.95], [10.0, -45.0]])
    obsfile = tmp_path / "obs.tab"
    rows = [[T0, 5.0, lo, la, 1.0] for lo, la in pts]
    np.savetxt(obsfile, np.array(rows), fmt="%.10g")
    dx = 3.0
    tctl = tread_ctl(None, _ctl_args(("SAMPLE_OBSFILE", str(obsfile),
                                      "SAMPLE_DX", str(dx),
                                      "SAMPLE_DZ", "-1")))
    n = 3000
    k = rng.integers(0, 3, n)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    r = dx * rng.uniform(0.9, 1.1, n) / 6367.421 * 180.0 / np.pi
    lat = np.clip(pts[k, 1] + r * np.sin(ang), -90.0, 90.0)
    lon = pts[k, 0] + r * np.cos(ang) / np.maximum(
        np.cos(np.deg2rad(lat)), 1e-3)
    from mptrac_tpu_torch.types import Atm
    atm = Atm(time=torch.full((n,), T0, dtype=torch.float64),
              p=torch.full((n,), 500.0, dtype=torch.float64),
              lon=torch.from_numpy(lon), lat=torch.from_numpy(lat),
              q={q: torch.ones(n, dtype=torch.float64) for q in QNT}, np=n)
    w = tw.SampleWriter(tctl, str(tmp_path / "t.tab"))
    assert w.GRID_MAX - 3 <= w.ncube <= w.GRID_MAX
    npts, _ = w._near(atm, atm.mask, tw._geo2cart(pts[:, 0], pts[:, 1]),
                      pts[:, 1], np.zeros(3), np.zeros(3))
    w.close()
    x1 = tw._geo2cart(lon, lat)
    for i in range(3):
        d2 = np.sum((x1 - tw._geo2cart(pts[i, 0], pts[i, 1])) ** 2, -1)
        want = ((np.abs(pts[i, 1] - lat) <= w.dlat) & (d2 <= dx ** 2)).sum()
        assert npts[i] == want and 0 < want < n


def test_output_manager(case, tmp_path):
    """Every writer through the dispatcher over five steps, with the
    particle output: the same files with the same names and contents in
    both packages (the particle files show the station flags of the
    previous write).  The state holds its live parcels only: the JAX
    station writer replaces ``stat`` by an array of ``np`` entries, which
    its grid writer then cannot bin with the ``npmax`` entries of the
    other columns."""
    args = ("ATM_BASENAME", "atm", "ATM_DT_OUT", str(2 * DT_MOD),
            "GRID_BASENAME", "grid", "GRID_DT_OUT", str(2 * DT_MOD),
            "ENS_BASENAME", "ens", "ENS_DT_OUT", str(2 * DT_MOD),
            "CSI_BASENAME", "csi", "CSI_OBSFILE", case["obs"],
            "PROF_BASENAME", "prof", "PROF_OBSFILE", case["obs"],
            "SAMPLE_BASENAME", "sample", "SAMPLE_OBSFILE", case["obs"],
            "STAT_BASENAME", "station", "VTK_BASENAME", "vtk",
            "VTK_DT_OUT", str(2 * DT_MOD))
    jctl, tctl = _ctls(*args)
    ja, ta = _fresh(case)

    def live(a):
        return a.replace(time=a.time[:NP], p=a.p[:NP], lon=a.lon[:NP],
                         lat=a.lat[:NP], q={k: v[:NP] for k, v in a.q.items()})

    ja, ta = live(ja), live(ta)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jm = joutput.OutputManager(str(jdir), jctl)
    tm = toutput.OutputManager(str(tdir), tctl)
    for k in range(5):
        t = T0 + k * DT_MOD
        jm.write(case["jmet"], ja, t)
        ja = ja.replace(time=ja.time + DT_MOD)
        tm.write(case["tmet"], ta, t)
        ta = ta.replace(time=ta.time + DT_MOD)
    jm.close()
    tm.close()
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert {"csi.tab", "prof.tab", "sample.tab", "station.tab",
            "vtk_00001.vtk"} <= set(names)
    assert sum(n.startswith("grid_") for n in names) == 2
    for name in names:
        sigma = ({4 + len(QNT) + i: RTOL_SIGMA for i in range(len(QNT))}
                 if name.startswith("ens_") else None)
        assert_files_agree(tdir / name, jdir / name, col_rtol=sigma)
