"""GRIB ingest (MET_TYPE 6) of the port against the JAX package: the
GRIB2 encoder and decoder (``io/grib2``), the GRIB1 decoder
(``io/grib1``) on messages of a small simple-packing encoder below,
``met/read_grib`` and ``read_met`` through the host chain, following
tests/test_met.py's GRIB tests."""

import os

import numpy as np
import pytest
import torch

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu.io import grib1 as jgrib1
from mptrac_tpu.io import grib2 as jgrib2
from mptrac_tpu.met import build as jbuild
from mptrac_tpu.met.read_grib import read_met_grib as jread_met_grib
from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.io import grib1 as tgrib1
from mptrac_tpu_torch.io import grib2 as tgrib2
from mptrac_tpu_torch.met import build as tbuild
from mptrac_tpu_torch.met.read_grib import read_met_grib as tread_met_grib
from mptrac_tpu_torch.met.synthetic import make_wind_met
from mptrac_tpu_torch.sim import run_trac

from helpers.torch_bridge import met_to_numpy

os.environ.setdefault("LOGLEV", "0")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NY, NX = 19, 36
LEVELS = (1000, 850, 700, 500, 300, 200, 100, 50)
WHEN = (2011, 6, 5, 0, 0)


def _records_equal(trecs, jrecs):
    assert len(trecs) == len(jrecs) > 0
    for a, b in zip(trecs, jrecs):
        for k in ("param", "table", "level_type", "level", "year", "mon",
                  "day", "hour", "minute", "nx", "ny", "lon0", "lon1",
                  "dlon", "lat0", "lat1"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.values.dtype == b.values.dtype == np.float64
        np.testing.assert_array_equal(a.values, b.values)


def test_grib2_encode_decode_equals_jax(tmp_path):
    """The port's encoder writes the JAX encoder's bytes; the port's
    decoder (edition 2 through the edition-agnostic entry point too)
    gives the JAX records, values bit for bit."""
    rng = np.random.default_rng(3)
    lon = np.linspace(0, 350, NX)
    lat = np.linspace(-90, 90, NY)
    msgs = []
    for code, lev, ltype, vals in (
            (130, 500, 100, 250.0 + 30.0 * rng.random((NY, NX))),
            (134, 0, 1, 90000.0 + 5000.0 * rng.random((NY, NX))),
            (131, 850, 100, np.full((NY, NX), 3.5))):
        t = tgrib2.encode_message(code, lev, vals, lon, lat, when=WHEN,
                                  level_type=ltype)
        assert t == jgrib2.encode_message(code, lev, vals, lon, lat,
                                          when=WHEN, level_type=ltype)
        msgs.append(t)
    f = tmp_path / "t.grb2"
    f.write_bytes(b"".join(msgs))
    _records_equal(tgrib2.decode_file(str(f)), jgrib2.decode_file(str(f)))
    _records_equal(tgrib1.decode_file(str(f)), jgrib1.decode_file(str(f)))
    r = tgrib2.decode_file(str(f))[0]
    assert (r.param, r.level_type, r.level) == (130, 100, 500)
    np.testing.assert_allclose(r.values, tgrib2.decode_file(str(f))[0].values)


def _ibm(x):
    """IBM 370 single-precision float bytes (GRIB1 reference values)."""
    if x == 0:
        return b"\x00\x00\x00\x00"
    sign = 0x80 if x < 0 else 0
    x = abs(x)
    exp = 64
    while x >= 1.0:
        x /= 16.0
        exp += 1
    while x < 1.0 / 16.0:
        x *= 16.0
        exp -= 1
    mant = int(x * 2 ** 24)
    return bytes([sign | exp]) + mant.to_bytes(3, "big")


def _s(v, n):
    """GRIB1 sign-magnitude integer."""
    return ((1 << (8 * n - 1)) | -v if v < 0 else v).to_bytes(n, "big")


def grib1_message(param, level, values, lat0, lon0, lat1, lon1, dlon,
                  when=WHEN, nbits=12, d_scale=1, bitmap=None):
    """A GRIB1 message with simple packing: PDS (with century and decimal
    scale), a regular lat/lon GDS, an optional bitmap (BMS), the BDS."""
    ny, nx = values.shape
    vals = np.asarray(values, np.float64).reshape(-1)
    if bitmap is not None:
        vals = vals[bitmap.reshape(-1)]
    scaled = vals * 10.0 ** d_scale
    ref = float(np.floor(scaled.min()))
    e = int(np.ceil(np.log2(max(scaled.max() - ref, 1e-9)
                            / (2 ** nbits - 1))))
    x = np.round((scaled - ref) / 2.0 ** e).astype(np.int64)
    year, mon, day, hour, minute = when
    pds = bytearray(28)
    pds[0:3] = (28).to_bytes(3, "big")
    pds[3], pds[7] = 128, 0x80 | (0x40 if bitmap is not None else 0)
    pds[8], pds[9] = param, 100
    pds[10:12] = level.to_bytes(2, "big")
    pds[12:17] = bytes([year % 100, mon, day, hour, minute])
    pds[24] = year // 100 + 1
    pds[26:28] = _s(d_scale, 2)
    gds = bytearray(32)
    gds[0:3] = (32).to_bytes(3, "big")
    gds[5] = 0
    gds[6:8], gds[8:10] = nx.to_bytes(2, "big"), ny.to_bytes(2, "big")
    gds[10:13], gds[13:16] = _s(lat0, 3), _s(lon0, 3)
    gds[17:20], gds[20:23] = _s(lat1, 3), _s(lon1, 3)
    gds[23:25] = _s(dlon, 2)
    bms = b""
    if bitmap is not None:
        bits = np.packbits(bitmap.reshape(-1).astype(np.uint8)).tobytes()
        bms = (6 + len(bits)).to_bytes(3, "big") + b"\x00\x00\x00" + bits
    packed = np.packbits(((x[:, None] >> np.arange(nbits - 1, -1, -1)) & 1)
                         .astype(np.uint8).reshape(-1)).tobytes()
    unused = (8 - (len(x) * nbits) % 8) % 8
    bds = bytearray(11)
    bds[3] = unused
    bds[4:6] = _s(e, 2)
    bds[6:10] = _ibm(ref)
    bds[10] = nbits
    bds = bytes(bds) + packed
    bds = (len(bds)).to_bytes(3, "big") + bds[3:]
    body = bytes(pds) + bytes(gds) + bms + bds
    total = 8 + len(body) + 4
    return b"GRIB" + total.to_bytes(3, "big") + b"\x01" + body + b"7777"


def test_grib1_decode_equals_jax(tmp_path):
    """GRIB1 (no fixture without a reference checkout): the port's
    decoder against the JAX ``grib1.decode_file`` on messages of the
    encoder above, with and without a bitmap, north-to-south rows."""
    rng = np.random.default_rng(7)
    t = 250.0 + 30.0 * rng.random((NY, NX))
    mask = rng.random((NY, NX)) > 0.2
    data = (grib1_message(130, 500, t, 90000, 0, -90000, 350000, 10000)
            + grib1_message(133, 850, 1e-3 * rng.random((NY, NX)), 90000, 0,
                            -90000, 350000, 10000, d_scale=5)
            + grib1_message(131, 300, t - 250.0, 90000, 0, -90000, 350000,
                            10000, bitmap=mask))
    f = tmp_path / "g1.grb"
    f.write_bytes(data)
    trecs = tgrib1.decode_file(str(f))
    _records_equal(trecs, jgrib1.decode_file(str(f)))
    assert [r.param for r in trecs] == [130, 133, 131]
    assert trecs[0].year == 2011 and trecs[0].lat0 == 90.0
    np.testing.assert_allclose(trecs[0].values, t, atol=0.1)
    assert np.isnan(trecs[2].values[~mask]).all()


@pytest.fixture(scope="module")
def grib_set(tmp_path_factory):
    """The solid-body wind on 8 isobaric levels as a GRIB2 set, two
    snapshots an hour apart (``flagship.write_grib_met``)."""
    d = tmp_path_factory.mktemp("grib")
    for h in (0, 1):
        met = make_wind_met(t0=h * 3600.0, nx=NX, ny=NY, nz=len(LEVELS),
                            alpha=30.0, q=5e-6, o3=2e-6, device="cpu")
        flagship.write_grib_met(
            str(d / f"gb_XX_2000_01_01_0{h}.grb"), met, LEVELS,
            when=(2000, 1, 1, h, 0))
    return str(d)


def _ctls(grib_dir, *more):
    args = ["MET_TYPE", "6", "METBASE", os.path.join(grib_dir, "gb_XX"),
            "MET_TROPO", "3", *more]
    return mt.read_ctl(None, args), mtt.read_ctl(None, args)


def test_read_met_grib_equals_jax(grib_set):
    """``read_met_grib`` (the raw fields) and ``read_met`` (the host
    chain on them) of both packages on the same set: equal to the bit."""
    jctl, tctl = _ctls(grib_set)
    fn = os.path.join(grib_set, "gb_XX_2000_01_01_00.grb")
    traw, jraw = tread_met_grib(fn, tctl), jread_met_grib(fn, jctl)
    assert list(traw["p"]) == [float(x) for x in LEVELS]
    for kind in ("fields2d", "fields3d"):
        assert sorted(traw[kind]) == sorted(jraw[kind])
        for k in traw[kind]:
            np.testing.assert_array_equal(traw[kind][k], jraw[kind][k], k)
    timings = {}
    tmet = tbuild.read_met(fn, tctl, device="cpu", timings=timings)
    jmet = met_to_numpy(jbuild.read_met(fn, jctl))
    assert sorted(timings) == ["preprocess", "read", "upload"]
    assert tmet.lon_periodic and tmet.time == float(jmet["time"]) == 0.0
    for k in ("lon", "lat", "p"):
        np.testing.assert_array_equal(getattr(tmet, k).numpy(), jmet[k])
    for kind in ("fields2d", "fields3d"):
        for k, v in getattr(tmet, kind).items():
            np.testing.assert_array_equal(v.numpy(), jmet[kind][k], k)
    # the 16-bit packing keeps the wind to 1e-3 m/s (away from the poles,
    # where the chain's polar_winds replaces it)
    np.testing.assert_allclose(
        tmet.fields3d["u"][:NX, 1:-1].numpy(),
        make_wind_met(t0=0.0, nx=NX, ny=NY, nz=len(LEVELS), alpha=30.0,
                      device="cpu").fields3d["u"][:NX, 1:-1].numpy(),
        atol=1e-3)


def test_run_trac_from_grib(grib_set, tmp_path):
    """``run_trac`` from the GRIB set: four steps across the file
    boundary on the exact path; the parcels move with the wind."""
    rng = np.random.default_rng(2)
    with open(tmp_path / "atm_in.tab", "w") as f:
        for _ in range(64):
            f.write("%.2f %g %g %g\n" % (1800.0, rng.uniform(2, 15),
                                         rng.uniform(-170, 170),
                                         rng.uniform(-60, 60)))
    with open(tmp_path / "trac.ctl", "w") as f:
        f.write(f"MET_TYPE = 6\nMETBASE = {grib_set}/gb_XX\nDT_MET = 3600\n"
                "DT_MOD = 600\nT_STOP = 3600\nATM_BASENAME = -\n"
                "DIFFUSION = 0\nNQ = 0\n")
    sim = run_trac(str(tmp_path), "trac.ctl", "atm_in.tab", device="cpu")
    start = np.loadtxt(tmp_path / "atm_in.tab")
    moved = np.abs(sim.atm.lon.numpy() - start[:, 2])
    assert sim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 4
    assert len(sim.met.reads) == 2 and sim.met.reads[0]["route"] == "python"
    assert float(moved.max()) > 0.1 and bool(torch.isfinite(sim.atm.p).all())
