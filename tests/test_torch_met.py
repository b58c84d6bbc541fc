"""Met ingest of the port against the JAX package: ``read_met`` on the
golden netCDF files, the netCDF writer, ``MetBuffer`` over a forward and a
backward run, and the two reader faults that the port does not copy."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu.met import build as jbuild
from mptrac_tpu.met import read_nc as jread_nc
from mptrac_tpu.met import write_nc as jwrite_nc
from mptrac_tpu.sim import MetBuffer as JMetBuffer
from mptrac_tpu_torch.met import build as tbuild
from mptrac_tpu_torch.met import read_nc as tread_nc
from mptrac_tpu_torch.met import write_nc as twrite_nc
from mptrac_tpu_torch.sim import MetBuffer as TMetBuffer
from mptrac_tpu_torch.timeutil import time2jsec

from helpers.torch_bridge import met_to_numpy, to_torch

os.environ.setdefault("LOGLEV", "0")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {name: os.path.join(ROOT, "parity", name, "data")
          for name in ("golden_long", "golden_chem")}
#: the first three snapshots of each set (golden_long: two hours apart,
#: golden_chem: one hour apart)
FILES = [(name, os.path.basename(f)) for name, d in GOLDEN.items()
         for f in sorted(glob.glob(os.path.join(d, "met_*.nc")))[:3]]
T0 = time2jsec(2011, 6, 5, 0, 0, 0, 0)


def _ctls(*args):
    args = ["MET_TROPO", "3", *args]
    return mt.read_ctl(None, args), mtt.read_ctl(None, args)


def _assert_met_equal(tmet, jmet):
    """Every axis, field, flag and the time: equal to the bit (NaN equal
    to NaN)."""
    a = met_to_numpy(jmet)
    b = dict(time=np.asarray(tmet.time), lon=tmet.lon.numpy(),
             lat=tmet.lat.numpy(), p=tmet.p.numpy(),
             hybrid=tmet.hybrid.numpy(),
             fields2d={k: v.numpy() for k, v in tmet.fields2d.items()},
             fields3d={k: v.numpy() for k, v in tmet.fields3d.items()},
             coord_type=tmet.coord_type, npl_ml=tmet.npl_ml,
             reg_lon=tmet.reg_lon, reg_lat=tmet.reg_lat,
             lon_periodic=tmet.lon_periodic)
    for k in ("coord_type", "npl_ml", "reg_lon", "reg_lat", "lon_periodic"):
        assert a[k] == b[k], k
    for k in ("time", "lon", "lat", "p", "hybrid"):
        assert a[k].dtype == b[k].dtype == np.float64, k
        np.testing.assert_array_equal(b[k], a[k], k)
    for group in ("fields2d", "fields3d"):
        assert sorted(a[group]) == sorted(b[group])
        for k in a[group]:
            assert b[group][k].dtype == a[group][k].dtype == np.float32, k
            np.testing.assert_array_equal(b[group][k], a[group][k], k)


def test_golden_files_present():
    assert len(FILES) == 6


@pytest.mark.parametrize("name,fname", FILES)
def test_read_met_equals_jax(name, fname):
    """The host chain (reader, preprocessing) is the same numpy code in
    both packages: every field, axis and flag is equal to the bit."""
    jctl, tctl = _ctls()
    fn = os.path.join(GOLDEN[name], fname)
    jmet = jbuild.read_met(fn, jctl)
    timings = {}
    tmet = tbuild.read_met(fn, tctl, device="cpu", timings=timings)
    _assert_met_equal(tmet, jmet)
    assert isinstance(tmet.time, float)
    assert sorted(timings) == ["preprocess", "read", "upload"]
    # the chain left its marks: the wraparound column, descending
    # pressure, geopotential heights, potential vorticity, the lifted
    # condensation level, the ozone column (the golden met is a
    # synthetic wind field without a tropopause)
    assert tmet.lon_periodic and float(tmet.lon[-1] - tmet.lon[0]) == 360.0
    assert float(tmet.p[0]) > float(tmet.p[-1])
    assert bool(torch.isfinite(tmet.fields3d["z"]).all())
    assert float(tmet.fields3d["pv"].abs().max()) > 0.0
    assert 100.0 < float(tmet.fields2d["plcl"].mean()) < 1100.0
    assert float(tmet.fields2d["o3c"].min()) > 0.0
    # the bridge carries a Met from read_met across whole
    again = to_torch(met01=jmet)[2]
    _assert_met_equal(again, jmet)
    assert again.time == tmet.time


def test_write_met_nc_round_trip(tmp_path):
    """A Met from read_met written by both writers gives one file, byte
    for byte; read back raw by both readers it gives equal arrays, and
    the fields that the file holds come back as written (float32 through
    a scale and its inverse: 1 ulp)."""
    jctl, tctl = _ctls()
    fn = os.path.join(GOLDEN["golden_long"], "met_2011_06_05_00.nc")
    jmet = jbuild.read_met(fn, jctl)
    tmet = tbuild.read_met(fn, tctl, device="cpu")
    fj = str(tmp_path / "j_2011_06_05_00.nc")
    ft = str(tmp_path / "t_2011_06_05_00.nc")
    jwrite_nc.write_met_nc(fj, jmet, drop_wrap_column=True)
    twrite_nc.write_met_nc(ft, tmet, drop_wrap_column=True)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    jraw = jread_nc.read_met_nc(ft, jctl)
    traw = tread_nc.read_met_nc(ft, tctl)
    assert traw["time"] == jraw["time"] == tmet.time
    for group in ("fields2d", "fields3d"):
        assert sorted(traw[group]) == sorted(jraw[group])
        for k in traw[group]:
            np.testing.assert_array_equal(traw[group][k], jraw[group][k], k)
    nx = tmet.nx - 1
    for k in ("t", "u", "v", "w", "h2o", "o3"):
        np.testing.assert_allclose(traw["fields3d"][k],
                                   tmet.fields3d[k].numpy()[:nx],
                                   rtol=3e-7, atol=0, err_msg=k)
    np.testing.assert_allclose(traw["fields2d"]["ps"],
                               tmet.fields2d["ps"].numpy()[:nx], rtol=3e-7)


def _pairs_equal(tpair, jpair):
    _assert_met_equal(tpair, jpair)
    assert tpair.time == tuple(float(x) for x in np.asarray(jpair.time))
    assert tpair.lon.shape[0] == 2 and tpair.fields3d["u"].shape[0] == 2


@pytest.mark.parametrize("direction", [1, -1])
def test_met_buffer_pairs(direction):
    """``MetBuffer.get`` over a run that crosses the middle snapshot, in
    both directions: the same pairs at the same times as the JAX buffer,
    a new pair object exactly when a file was read."""
    d = GOLDEN["golden_long"]
    jctl, tctl = _ctls("METBASE", os.path.join(d, "met"), "DT_MET", "7200",
                       "DIRECTION", str(direction))
    from mptrac_tpu.climatology import read_clim as jread_clim
    from mptrac_tpu_torch.climatology import read_clim as tread_clim
    jbuf = JMetBuffer(jctl, jread_clim(jctl))
    tbuf = TMetBuffer(tctl, tread_clim(tctl, device="cpu"), device="cpu")
    ts = [T0 + 6000.0, T0 + 7200.0, T0 + 7320.0, T0 + 9000.0]
    if direction == -1:
        ts = ts[::-1]
    seen, reads = [], []
    for t in ts:
        due = tbuf.swap_due(t)
        n_before = len(tbuf.reads)
        tpair = tbuf.get(t)
        _pairs_equal(tpair, jbuf.get(t))
        assert due == (len(tbuf.reads) > n_before)
        assert tpair.time[0] <= t <= tpair.time[1]
        seen.append(tpair)
        reads.append(len(tbuf.reads))
    # two files at the start, one at the crossing
    assert reads == ([2, 2, 3, 3] if direction == 1 else [2, 2, 2, 3])
    changed = [a is not b for a, b in zip(seen, seen[1:])]
    assert changed == ([False, True, False] if direction == 1
                       else [False, False, True])
    names = [r["file"] for r in tbuf.reads]
    assert names == (["met_2011_06_05_00.nc", "met_2011_06_05_02.nc",
                      "met_2011_06_05_04.nc"] if direction == 1 else
                     ["met_2011_06_05_02.nc", "met_2011_06_05_04.nc",
                      "met_2011_06_05_00.nc"])


def test_met_buffer_compute_mode_and_grid_check(tmp_path):
    """float32 mode casts the axes of every pair (fields are float32
    already, the time stays a host float); a file whose grid differs
    from the pair's raises as in the JAX buffer."""
    from mptrac_tpu_torch.climatology import read_clim as tread_clim
    d = GOLDEN["golden_long"]
    _, tctl = _ctls("METBASE", os.path.join(d, "met"), "DT_MET", "7200")
    clim = tread_clim(tctl, device="cpu")
    buf = TMetBuffer(tctl, clim, device="cpu", dtype=torch.float32)
    pair = buf.get(T0 + 60.0)
    assert pair.lon.dtype == pair.p.dtype == torch.float32
    assert pair.fields3d["u"].dtype == torch.float32
    assert pair.time == (T0, T0 + 7200.0)
    pair = buf.get(T0 + 7260.0)
    assert pair.lon.dtype == torch.float32
    assert pair.time == (T0 + 7200.0, T0 + 14400.0)

    # a second snapshot on half the longitudes
    for name in ("met_2011_06_05_00.nc",):
        shutil.copy(os.path.join(d, name), tmp_path / name)
    _copy_nc(os.path.join(d, "met_2011_06_05_02.nc"),
             str(tmp_path / "met_2011_06_05_02.nc"), every_other_lon=True)
    _, tctl = _ctls("METBASE", str(tmp_path / "met"), "DT_MET", "7200")
    with pytest.raises(ValueError, match="grid dimensions do not match"):
        TMetBuffer(tctl, clim, device="cpu").get(T0 + 60.0)


@pytest.mark.parametrize("met_type,reader", [
    (1, "bin_io"), (2, "bin_io"), (3, "lossy"), (4, "bin_io"),
    (5, "lossy"), (6, "read_grib"), (7, "lossy"), (8, "lz4")])
def test_unported_met_types_raise_by_name(met_type, reader, monkeypatch,
                                          tmp_path):
    """Every MET_TYPE but 0 raised naming its JAX reader while that was
    not ported.  Now each reaches the port's reader of that name:
    ``read_met`` of a file of the type goes through it (a stand-in that
    raises by the reader's name shows the route), and ``MetBuffer``
    accepts the type.  (tests/test_torch_met_bin.py and
    test_torch_grib.py hold what the readers return.)"""
    from mptrac_tpu_torch.met import bin_io, lossy, lz4, read_grib

    def stand_in(*args, **kw):
        raise NotImplementedError(f"reached {reader}")

    target = {"bin_io": (bin_io, "read_met_bin"),
              "read_grib": (read_grib, "read_met_grib"),
              "lz4": (lz4, "decompress"),
              "lossy": (lossy, {3: "zfp", 5: "cms", 7: "sqz"}.get(met_type, "")
                        + "_decompress")}[reader]
    monkeypatch.setattr(*target, stand_in)
    _, tctl = _ctls("MET_TYPE", str(met_type), "METBASE", "-")
    met = mtt.types.Met(
        time=0.0, lon=torch.linspace(0, 350, 36, dtype=torch.float64),
        lat=torch.linspace(-90, 90, 19, dtype=torch.float64),
        p=torch.linspace(1000, 100, 4, dtype=torch.float64),
        hybrid=torch.zeros(4, dtype=torch.float64),
        fields2d={k: torch.ones(36, 19) for k in mtt.types.MET_2D_FIELDS},
        fields3d={k: torch.ones(36, 19, 4)
                  for k in mtt.types.MET_3D_FIELDS})
    fn = "met_2011_06_05_00_XX.grb"
    if met_type != 6:
        fn = str(tmp_path / "m.bin")
        bin_io.write_met_bin(fn, met, met_type, ctl=tctl)
    with pytest.raises(NotImplementedError, match=reader):
        tbuild.read_met(fn, tctl, device="cpu")
    TMetBuffer(tctl, None, device="cpu").close()


def test_interp_columns_at_equals_jax():
    """The host column interpolation that the preprocessing uses."""
    rng = np.random.default_rng(5)
    lon, lat = np.arange(6.0), np.arange(5.0)
    p = np.sort(rng.uniform(5, 1000, 12))[::-1].copy()
    f = rng.uniform(-10, 10, (6, 5, 12)).astype(np.float32)
    pt = rng.uniform(1, 1050, (6, 5))
    pt[2, 3] = np.nan
    got = tbuild.interp_columns_at(f, lon, lat, p, pt)
    assert got.shape == (6, 5) and np.isnan(got[2, 3])
    np.testing.assert_array_equal(
        got, jbuild.interp_columns_at(f, lon, lat, p, pt))


# ------------------------------- the reader faults that are not copied

def _copy_nc(src, dst, drop=(), every_other_lon=False):
    """Copy a netCDF-3 file without the variables in ``drop``."""
    a = netcdf_file(src, mmap=False)
    b = netcdf_file(dst, "w")
    try:
        for name, size in a.dimensions.items():
            if name == "lon" and every_other_lon:
                size = (size + 1) // 2
            b.createDimension(name, size)
        for name, var in a.variables.items():
            if name in drop:
                continue
            data = np.array(var[:])
            if every_other_lon and "lon" in var.dimensions:
                data = data[..., ::2]
            out = b.createVariable(name, var.data.dtype.char, var.dimensions)
            out[:] = data
            for att in ("units", "scale_factor", "add_offset"):
                if hasattr(var, att):
                    setattr(out, att, getattr(var, att))
    finally:
        a.close()
        b.close()


def test_missing_surface_pressure_is_filled_from_the_lowest_level(tmp_path):
    """A deliberate difference (read_nc.py:242 of the JAX package): a
    file without surface pressure gets ps [nx, ny] filled with the lowest
    level's pressure, built in the final layout.  On model levels the
    fill is MET_P[0] and its absence an error, where the JAX reader fills
    from the level index."""
    src = os.path.join(GOLDEN["golden_long"], "met_2011_06_05_00.nc")
    fn = str(tmp_path / "met_2011_06_05_00.nc")
    nc = netcdf_file(src, mmap=False)
    ps_names = [n for n in ("lnsp", "LNSP", "ps", "PS", "sp", "SP")
                if n in nc.variables]
    nc.close()
    assert ps_names
    _copy_nc(src, fn, drop=ps_names)
    jctl, tctl = _ctls()
    raw = tread_nc.read_met_nc(fn, tctl)
    nx, ny = raw["lon"].size, raw["lat"].size
    ps = raw["fields2d"]["ps"]
    assert ps.shape == (nx, ny) == raw["fields2d"]["zs"].shape
    assert ps.dtype == np.float32
    assert float(ps.min()) == float(ps.max()) == np.float32(raw["p"][0])
    # the whole chain runs on it
    met = tbuild.read_met(fn, tctl, device="cpu")
    assert met.fields2d["ps"].shape == (nx + 1, ny)
    # on pressure levels in the default layout the JAX reader's
    # [1, ny, nx] array comes out the same
    np.testing.assert_array_equal(
        jread_nc.read_met_nc(fn, jctl)["fields2d"]["ps"], ps)
    # model levels: the level axis is an index, not a pressure.  The
    # JAX reader takes its first value for ps all the same; the port
    # wants MET_P and says so
    jctl_ml, tctl_ml = _ctls("MET_VERT_COORD", "1")
    with pytest.raises(ValueError, match="MET_P"):
        tread_nc.read_met_nc(fn, tctl_ml)
    with pytest.raises(ValueError, match="model-level pressure"):
        jread_nc.read_met_nc(fn, jctl_ml)     # (gets past ps, fails later)


def test_clams_file_without_time_raises(tmp_path):
    """A deliberate difference (read_nc.py:201 of the JAX package): the
    century of a CLaMS file name comes from the sign of the file's time
    variable; without it the port raises, the JAX reader dates the file
    in century 20."""
    src = os.path.join(GOLDEN["golden_long"], "met_2011_06_05_00.nc")
    fn = str(tmp_path / "met_11060500.nc")
    _copy_nc(src, fn, drop=("time",))
    _, tctl = _ctls("MET_CLAMS", "1")
    with pytest.raises(ValueError, match="time variable"):
        tread_nc.read_met_nc(fn, tctl)
    # with the variable the century follows its sign
    fn2 = str(tmp_path / "x" / "met_11060500.nc")
    os.makedirs(os.path.dirname(fn2))
    _copy_nc(src, fn2)
    try:
        t = tread_nc.read_met_nc(fn2, tctl)["time"]
    except ValueError as err:            # (no CLaMS geopotential in it)
        assert "geopotential" in str(err)
    else:
        assert t == T0
