"""Exact interpolation core of the port against the JAX package:
indices equal (also on grid nodes, at both ends of each axis and on the
descending pressure axis), weights and interpolants allclose in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import to_torch
from mptrac_tpu import stack_met
from mptrac_tpu.met.synthetic import make_wind_met
from mptrac_tpu.ops import interp as jinterp
from mptrac_tpu.types import astype_state
from mptrac_tpu_torch.ops import interp as tinterp


@pytest.fixture(scope="module")
def mets():
    met01 = stack_met(
        make_wind_met(t0=0.0, alpha=30.0, nx=36, ny=19, nz=8),
        make_wind_met(t0=3600.0, alpha=30.0, nx=36, ny=19, nz=8))
    # a NaN corner and a NaN snapshot for the 2-D fallbacks
    zs = np.array(met01.fields2d["zs"])
    zs[0, 5, 7] = np.nan
    pt = np.array(met01.fields2d["pt"])
    pt[1] = np.nan
    f2 = dict(met01.fields2d, zs=jnp.asarray(zs), pt=jnp.asarray(pt))
    met01 = met01.replace(fields2d=f2)
    return met01, to_torch(met01=met01)[2]


def _points(met01, seed=4, n=3000):
    """Random points plus points exactly on grid nodes and on and
    beyond both ends of each axis."""
    rng = np.random.default_rng(seed)
    lons = np.asarray(met01.lon[0])
    lats = np.asarray(met01.lat[0])
    ps = np.asarray(met01.p[0])
    lon = rng.uniform(-360, 720, n)
    lat = rng.uniform(-95, 95, n)
    p = rng.uniform(ps[-1] * 0.5, ps[0] * 1.1, n)
    k = 0
    for ax, arr in ((lons, lon), (lats, lat), (ps, p)):
        m = ax.size
        arr[k:k + m] = ax                       # exactly on the nodes
        k += m
    lon[k:k + 4] = [0.0, 360.0, -180.0, 180.0]
    lat[k:k + 4] = [-90.0, 90.0, -91.0, 91.0]
    p[k:k + 4] = [ps[0], ps[-1], ps[0] + 10, ps[-1] - 0.01]
    return lon, lat, p


@pytest.mark.parametrize("fp32", [False, True])
def test_locate_3d_indices_equal(mets, fp32):
    jm, tm = mets
    lon, lat, p = _points(jm)
    if fp32:
        jm = astype_state(met=jm)
        from mptrac_tpu_torch.types import astype_state as tast
        tm = tast(met=tm)
        lon, lat, p = (a.astype(np.float32) for a in (lon, lat, p))
    lj = jinterp.locate_3d(jm, jnp.asarray(lon), jnp.asarray(lat),
                           jnp.asarray(p))
    lt = tinterp.locate_3d(tm, torch.from_numpy(lon),
                           torch.from_numpy(lat), torch.from_numpy(p))
    for name in ("ix", "iy", "iz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(lj, name)).astype(np.int64),
            getattr(lt, name).numpy().astype(np.int64), name)
    # same operations on the same values: the weights differ at most
    # by the contraction of a multiply-add
    rtol = 1e-5 if fp32 else 1e-13
    for name in ("wx", "wy", "wz"):
        np.testing.assert_allclose(getattr(lt, name).numpy(),
                                   np.asarray(getattr(lj, name)),
                                   rtol=rtol, atol=rtol, err_msg=name)


@pytest.mark.parametrize("axis", ["asc", "desc"])
def test_locate_irr_ties_and_ends(axis):
    xx = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    if axis == "desc":
        xx = xx[::-1].copy()
    x = np.concatenate([xx, [0.5, 20.0, 3.0, 2.0 + 1e-12, 2.0 - 1e-12]])
    exp = np.asarray(jinterp.locate_irr(jnp.asarray(xx), jnp.asarray(x)))
    got = tinterp.locate_irr(torch.from_numpy(xx), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  exp.astype(np.int64))


def test_interp_time_f64(mets):
    """f64: same gathers, same operation order; rtol 1e-12 on O(1..1e3)
    values (atol covers the zero fields)."""
    jm, tm = mets
    lon, lat, p = _points(jm, seed=5)
    n = lon.size
    ts = np.random.default_rng(6).uniform(0.0, 3600.0, n)
    lj = jinterp.locate_3d(jm, jnp.asarray(lon), jnp.asarray(lat),
                           jnp.asarray(p))
    lt = tinterp.locate_3d(tm, torch.from_numpy(lon),
                           torch.from_numpy(lat), torch.from_numpy(p))
    wt_j = jinterp.time_weight(jm, jnp.asarray(ts))
    wt_t = tinterp.time_weight(tm, torch.from_numpy(ts))
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=1e-14)
    for name in ("u", "v", "t", "z"):
        exp = jinterp.interp_time_3d(jm, name, jnp.asarray(ts), lj)
        got = tinterp.interp_time_3d(tm, name, torch.from_numpy(ts), lt)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    for name in ("ps", "pbl", "us", "zs", "pt"):
        exp = np.asarray(jinterp.interp_time_2d(jm, name, jnp.asarray(ts),
                                                lj))
        got = tinterp.interp_time_2d(tm, name, torch.from_numpy(ts),
                                     lt).numpy()
        # (a NaN snapshot nearer in time is returned as NaN by both)
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-12,
                                   equal_nan=True, err_msg=name)
        assert np.isfinite(exp).any(), name


@pytest.mark.parametrize("axis", ["ascending", "descending"])
def test_locate_irr_nan_lands_in_the_first_cell(axis):
    """A NaN coordinate compares false with every node: the JAX
    compare-count gives cell 0, and so does the port (a binary search
    alone would sort NaN past the last node)."""
    rng = np.random.default_rng(9)
    xx = np.sort(rng.uniform(1, 1000, 23))
    if axis == "descending":
        xx = xx[::-1].copy()
    x = rng.uniform(0, 1100, 200)
    x[::7] = np.nan
    x[:3] = xx[[0, 11, 22]]
    for dtype in (np.float64, np.float32):
        exp = np.asarray(jinterp.locate_irr(jnp.asarray(xx.astype(dtype)),
                                            jnp.asarray(x.astype(dtype))))
        got = tinterp.locate_irr(torch.from_numpy(xx.astype(dtype)),
                                 torch.from_numpy(x.astype(dtype))).numpy()
        np.testing.assert_array_equal(got, exp)
        assert (got[::7] == 0).all() and got.max() == 21


def test_locate_3d_with_nan_positions(mets):
    """NaN longitudes, latitudes and pressures through locate_3d: the
    same cells as the JAX package, and NaN weights in the same places."""
    jm, tm = mets
    lon, lat, p = _points(jm, seed=6, n=600)
    lon[5::11] = np.nan
    lat[6::13] = np.nan
    p[7::17] = np.nan
    jl = jinterp.locate_3d(jm, jnp.asarray(lon), jnp.asarray(lat),
                           jnp.asarray(p))
    tl = tinterp.locate_3d(tm, torch.from_numpy(lon), torch.from_numpy(lat),
                           torch.from_numpy(p))
    for name in ("ix", "iy", "iz"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)
    assert int(tl.iy[6]) == 0 and int(tl.iz[7]) == 0
    for name in ("wx", "wy", "wz"):
        got, exp = getattr(tl, name).numpy(), np.asarray(getattr(jl, name))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(exp), name)
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-15,
                                   err_msg=name)
    assert np.isnan(tl.wy.numpy()[6]) and np.isnan(tl.wz.numpy()[7])
