"""Particle file input and output of the port against the JAX package:
ATM_TYPE 0 (ASCII), 1 (binary) and 2 (netCDF)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu.io import atm_io as jio
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu_torch.io import atm_io as tio

from helpers.torch_bridge import atm_to_numpy, to_torch

os.environ.setdefault("LOGLEV", "0")

QNT = ("t", "m", "zg", "ps")
T_OUT = 3600.0


def _args(atm_type, *more):
    args = ["NQ", str(len(QNT))]
    for i, name in enumerate(QNT):
        args += [f"QNT_NAME[{i}]", name]
    return args + ["ATM_TYPE", str(atm_type), "ATM_TYPE_OUT", str(atm_type),
                   "DT_MOD", "180", *more]


def _ctls(atm_type, *more):
    return (mt.read_ctl(None, _args(atm_type, *more)),
            mtt.read_ctl(None, _args(atm_type, *more)))


@pytest.fixture(scope="module")
def state():
    """257 parcels in float64 from one numpy seed, in both packages; the
    times scatter around the output time so that the ASCII filters pick
    some and drop some."""
    rng = np.random.default_rng(11)
    n = 257
    atm = JAtm(
        time=jnp.asarray(T_OUT + rng.uniform(-200, 200, n).round(2)),
        p=jnp.asarray(rng.uniform(5, 1000, n)),
        lon=jnp.asarray(rng.uniform(-180, 180, n)),
        lat=jnp.asarray(rng.uniform(-90, 90, n)),
        q={"t": jnp.asarray(rng.uniform(180, 310, n)),
           "m": jnp.asarray(rng.uniform(0, 1e9, n)),
           "zg": jnp.asarray(rng.uniform(-0.1, 60, n)),
           "ps": jnp.asarray(rng.uniform(500, 1040, n))}, np=n)
    tatm = to_torch(atm)[0]
    return atm, tatm


def _assert_atm_equal(tatm, jatm, exact=True):
    a, b = atm_to_numpy(tatm), atm_to_numpy(jatm)
    assert a["np"] == b["np"]
    assert sorted(a["q"]) == sorted(b["q"])
    cols = [(k, a[k], b[k]) for k in ("time", "p", "lon", "lat")] + [
        ("q." + k, a["q"][k], b["q"][k]) for k in a["q"]]
    for name, x, y in cols:
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, name)


@pytest.mark.parametrize("atm_type,more", [
    (0, ()), (0, ("ATM_FILTER", "1")), (0, ("ATM_FILTER", "2")),
    (0, ("ATM_STRIDE", "3")), (0, ("QNT_FORMAT[1]", "%.3e")), (1, ())])
def test_written_file_is_byte_identical(tmp_path, state, atm_type, more):
    """ASCII (with its filters, stride and formats) and binary: the file
    that the port writes is the JAX writer's, byte for byte."""
    jatm, tatm = state
    jctl, tctl = _ctls(atm_type, *more)
    fj, ft = str(tmp_path / "j.out"), str(tmp_path / "t.out")
    jio.write_atm(fj, jctl, jatm, T_OUT)
    tio.write_atm(ft, tctl, tatm, T_OUT)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        da, db = a.read(), b.read()
    assert len(da) > 1000
    assert da == db


@pytest.mark.parametrize("atm_type", [0, 1, 2])
def test_read_equals_jax_reader(tmp_path, state, atm_type):
    """A file of the JAX writer read by both readers: the same columns
    (the same numpy code on the host: equal to the bit), with and without
    padding to a capacity."""
    jatm, _ = state
    jctl, tctl = _ctls(atm_type)
    fn = str(tmp_path / "atm.dat")
    jio.write_atm(fn, jctl, jatm, T_OUT)
    _assert_atm_equal(tio.read_atm(fn, tctl, device="cpu"),
                      jio.read_atm(fn, jctl))
    padded = tio.read_atm(fn, tctl, npmax=300, device="cpu")
    assert padded.np == 257 and padded.npmax == 300
    _assert_atm_equal(padded, jio.read_atm(fn, jctl, npmax=300))
    assert float(padded.p[257:].abs().max()) == 0.0


@pytest.mark.parametrize("atm_type", [1, 2])
def test_round_trip_is_exact(tmp_path, state, atm_type):
    """Binary and netCDF hold float64: what the port writes, both
    packages read back equal to what was written."""
    jatm, tatm = state
    jctl, tctl = _ctls(atm_type)
    fn = str(tmp_path / "atm.dat")
    tio.write_atm(fn, tctl, tatm, T_OUT)
    _assert_atm_equal(tio.read_atm(fn, tctl, device="cpu"), jatm)
    _assert_atm_equal(tatm, jio.read_atm(fn, jctl))


def test_ascii_round_trip(tmp_path, state):
    """ASCII holds %g: six significant digits of z, lon, lat and the
    quantities' own formats; the time keeps two decimals."""
    _, tatm = state
    _, tctl = _ctls(0)
    fn = str(tmp_path / "atm.tab")
    tio.write_atm(fn, tctl, tatm, T_OUT)
    back = tio.read_atm(fn, tctl, device="cpu")
    assert back.np == 257
    np.testing.assert_array_equal(back.time.numpy(), tatm.time.numpy())
    np.testing.assert_allclose(back.lon.numpy(), tatm.lon.numpy(), rtol=1e-5)
    # p = P0 exp(-z / H0) with z to six digits: 1e-5 of z up to 37 km
    np.testing.assert_allclose(back.p.numpy(), tatm.p.numpy(), rtol=1e-4)


def test_read_atm_compute_mode(tmp_path, state):
    """``dtype`` is the compute mode of positions and quantities; the
    time keeps float64.  The cast is the JAX package's astype_state."""
    from mptrac_tpu.types import astype_state
    jatm, tatm = state
    jctl, tctl = _ctls(1)
    fn = str(tmp_path / "atm.bin")
    tio.write_atm(fn, tctl, tatm, T_OUT)
    got = tio.read_atm(fn, tctl, dtype=torch.float32, device="cpu")
    assert got.time.dtype == torch.float64 and got.p.dtype == torch.float32
    _assert_atm_equal(got, astype_state(atm=jio.read_atm(fn, jctl)))


def test_missing_quantity_columns_are_zero(tmp_path, state):
    """An ASCII file with fewer columns than NQ: the quantities it lacks
    are zero, as in the JAX reader."""
    jctl, tctl = _ctls(0)
    fn = str(tmp_path / "short.tab")
    with open(fn, "w") as f:
        f.write("# header\n\n0.00 10 20 30 250.5\n60.00 11 -20 -30 251.5\n")
    _assert_atm_equal(tio.read_atm(fn, tctl, device="cpu"),
                      jio.read_atm(fn, jctl))
    got = tio.read_atm(fn, tctl, device="cpu")
    assert got.np == 2 and float(got.q["t"][1]) == 251.5
    assert float(got.q["m"].abs().max()) == 0.0


@pytest.mark.parametrize("atm_type", [3, 4])
def test_clams_types_raise_by_name(tmp_path, state, atm_type):
    """The CLaMS types raised naming their JAX functions while those were
    not ported.  Now they read and write (below); what still raises by
    name is a CLaMS file without the variables the reader needs, as in
    the JAX reader: ``PRESS`` (or ``PRESS_INIT``), and with
    ``ADVECT_VERT_COORD 1`` ``ZETA``."""
    from scipy.io import netcdf_file
    jctl, tctl = _ctls(atm_type)
    fn = str(tmp_path / "x.nc")
    nc = netcdf_file(fn, "w")
    nc.createDimension("NPARTS", 3)
    for name in ("LON", "LAT"):
        nc.createVariable(name, "d", ("NPARTS",))[:] = [1.0, 2.0, 3.0]
    nc.createDimension("time", 1)
    nc.createVariable("time", "d", ("time",))[:] = [T_OUT]
    nc.close()
    for read in (lambda: tio.read_atm(fn, tctl, device="cpu"),
                 lambda: jio.read_atm(fn, jctl)):
        with pytest.raises(KeyError, match="PRESS"):
            read()
    jctl, tctl = _ctls(atm_type, "ADVECT_VERT_COORD", "1")
    for read in (lambda: tio.read_atm(fn, tctl, device="cpu"),
                 lambda: jio.read_atm(fn, jctl)):
        with pytest.raises(KeyError, match="ZETA"):
            read()


def test_read_atm_defaults_to_the_card(tmp_path, state):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tctl = _ctls(1)
    with pytest.raises(RuntimeError, match="cuda"):
        tio.read_atm(str(tmp_path / "none.bin"), tctl)


# ------------------------------------------------ CLaMS particle files

def _clams_state(state, zeta):
    """The state with a ``zeta`` quantity (or without), both packages."""
    jatm, tatm = state
    if not zeta:
        return jatm, tatm
    z = np.linspace(300.0, 900.0, 257)
    return (jatm.replace(q=dict(jatm.q, zeta=jnp.asarray(z))),
            tatm.replace(q=dict(tatm.q, zeta=torch.from_numpy(z))))


def _clams_ctls(atm_type, zeta, *more):
    names = QNT + (("zeta",) if zeta else ())
    args = ["NQ", str(len(names))]
    for i, name in enumerate(names):
        args += [f"QNT_NAME[{i}]", name]
    args += ["ATM_TYPE", str(atm_type), "ATM_TYPE_OUT", str(atm_type),
             "DT_MOD", "180", *more]
    return mt.read_ctl(None, args), mtt.read_ctl(None, args)


@pytest.mark.parametrize("zeta", [False, True], ids=["no_zeta", "zeta"])
@pytest.mark.parametrize("atm_type", [3, 4])
def test_clams_written_file_is_byte_identical(tmp_path, state, atm_type,
                                              zeta):
    """Where the classic format holds the file, the port's CLaMS file is
    the JAX writer's, byte for byte (``ZETA`` from the quantity, or
    zeros)."""
    jatm, tatm = _clams_state(state, zeta)
    jctl, tctl = _clams_ctls(atm_type, zeta)
    fj, ft = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jio.write_atm(fj, jctl, jatm, T_OUT)
    tio.write_atm(ft, tctl, tatm, T_OUT)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        da, db = a.read(), b.read()
    assert da[:4] == b"CDF\x01" and len(da) > 8 * 257 * 6
    assert da == db


def _write_clams_by_hand(fn, jatm, init, version=1):
    """A CLaMS file as another program writes it: with ``TIME_INIT``
    and ``PRESS_INIT`` (``init``) or without, ``ZETA`` always."""
    from scipy.io import netcdf_file
    n = int(jatm.np)
    nc = netcdf_file(fn, "w", version=version)
    nc.createDimension("time", 1)
    nc.createDimension("NPARTS", n)
    nc.createVariable("time", "d", ("time",))[:] = [T_OUT]
    cols = {"LON": jatm.lon, "LAT": jatm.lat, "PRESS": jatm.p,
            "ZETA": np.asarray(jatm.p) * 0.5 + 250.0, "t": jatm.q["t"],
            "m": jatm.q["m"]}
    if init:
        cols.update(TIME_INIT=jatm.time, PRESS_INIT=np.asarray(jatm.p) + 1.0)
    for name, col in cols.items():
        nc.createVariable(name, "d", ("NPARTS",))[:] = np.asarray(col)
    nc.close()


@pytest.mark.parametrize("vert", ["0", "1"], ids=["pressure", "zeta"])
@pytest.mark.parametrize("init", [False, True], ids=["plain", "init"])
@pytest.mark.parametrize("atm_type", [3, 4])
def test_clams_read_equals_jax_reader(tmp_path, state, atm_type, init,
                                      vert):
    """Both readers on the same CLaMS file, with and without
    ``TIME_INIT`` / ``PRESS_INIT``, on pressure (``PRESS_INIT`` over
    ``PRESS``) and with ``ADVECT_VERT_COORD 1`` (``ZETA`` into the
    quantity ``zeta``, ``PRESS``): equal to the bit; quantities the file
    lacks are zero."""
    jatm, _ = state
    fn = str(tmp_path / "c.nc")
    _write_clams_by_hand(fn, jatm, init)
    jctl, tctl = _clams_ctls(atm_type, vert == "1", "ADVECT_VERT_COORD",
                             vert)
    got = tio.read_atm(fn, tctl, device="cpu")
    _assert_atm_equal(got, jio.read_atm(fn, jctl))
    assert float(got.q["zg"].abs().max()) == 0.0
    want_p = np.asarray(jatm.p) + (1.0 if init and vert == "0" else 0.0)
    np.testing.assert_array_equal(got.p.numpy(), want_p)
    want_t = np.asarray(jatm.time) if init else np.full(257, T_OUT)
    np.testing.assert_array_equal(got.time.numpy(), want_t)


def test_clams_offsets_exceed_cdf1_at_full_size(tmp_path, state):
    """The JAX writer's classic (CDF-1) file cannot hold 100,663,296
    parcels: scipy packs each variable's begin offset as a signed 32-bit
    integer, and ``ZETA``, the fourth per-parcel variable, begins at
    2.4e9 B.  Shown by the offset arithmetic and by scipy's own
    packing of that offset, without writing 3 GB; the port chooses
    CDF-2 there."""
    import io

    from scipy.io import netcdf_file
    _, tctl = _clams_ctls(3, False)
    n = 100_663_296
    begins = tio.clams_begins(n, tctl)
    assert begins["LAT"] < begins["LON"] < begins["PRESS"] <= tio.CDF1_MAX_BEGIN
    assert begins["ZETA"] == begins["LAT"] + 3 * 8 * n > tio.CDF1_MAX_BEGIN
    classic = netcdf_file(io.BytesIO(), "w")
    with pytest.raises(OverflowError):
        classic._pack_begin(begins["ZETA"])
    classic._pack_begin(begins["PRESS"])
    assert tio.clams_version(n, tctl) == 2
    assert tio.clams_version(257, tctl) == 1
    # the header that the arithmetic assumes is the one scipy writes
    fn = str(tmp_path / "small.nc")
    tio.write_atm(fn, tctl, state[1], T_OUT)
    nvar = len(tio.clams_begins(257, tctl)) - 1
    assert (os.path.getsize(fn) - 8 - nvar * 8 * 257
            == tio.clams_begins(257, tctl)["LAT"] == begins["LAT"])


def test_clams_cdf2_branch_read_by_both(tmp_path, state, monkeypatch):
    """The CDF-2 branch, chosen by offset (the limit lowered so that 257
    parcels cross it): the port writes a 64-bit-offset file, and both
    readers read it back equal to the state."""
    jatm, tatm = state
    jctl, tctl = _clams_ctls(3, False)
    monkeypatch.setattr(tio, "CDF1_MAX_BEGIN", 4000)
    assert tio.clams_version(257, tctl) == 2
    fn = str(tmp_path / "big.nc")
    tio.write_atm(fn, tctl, tatm, T_OUT)
    with open(fn, "rb") as f:
        assert f.read(4) == b"CDF\x02"
    for got in (tio.read_atm(fn, tctl, device="cpu"), jio.read_atm(fn, jctl)):
        a = atm_to_numpy(got)
        for k in ("p", "lon", "lat"):
            np.testing.assert_array_equal(a[k], np.asarray(getattr(jatm, k)))
        for k in QNT:
            np.testing.assert_array_equal(a["q"][k], np.asarray(jatm.q[k]))
        np.testing.assert_array_equal(a["time"], np.asarray(jatm.time)[0])
