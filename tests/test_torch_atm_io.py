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
    _, tatm = state
    _, tctl = _ctls(atm_type)
    with pytest.raises(NotImplementedError, match="read_atm_clams"):
        tio.read_atm(str(tmp_path / "x.nc"), tctl, device="cpu")
    with pytest.raises(NotImplementedError, match="write_atm_clams"):
        tio.write_atm(str(tmp_path / "x.nc"), tctl, tatm, T_OUT)


def test_read_atm_defaults_to_the_card(tmp_path, state):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tctl = _ctls(1)
    with pytest.raises(RuntimeError, match="cuda"):
        tio.read_atm(str(tmp_path / "none.bin"), tctl)
