"""K6 and K7, the plain PyTorch versions of the kernels on the 64-wide
corner-block table (ops.lane_interp) and on the 8-wide per-node table
(ops.pallas_interp), against the JAX package's Pallas kernels in
interpret mode, modelled on tests/test_pallas_interp.py with its
tolerances; and against K4 and K5 (ops.slab_interp), which compute the
same functions from the per-cell table.

``test_slab_kernel_flags_out_of_slab`` of tests/test_pallas_interp.py
has no counterpart: the port's kernels serve every parcel in any order,
so nothing is flagged (``test_every_parcel_is_served`` holds that
instead)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import to_torch
from mptrac_tpu import stack_met
from mptrac_tpu.met.synthetic import make_wind_met
from mptrac_tpu.ops import fast_interp as jfast
from mptrac_tpu.ops import interp as jinterp
from mptrac_tpu.ops import lane_interp as jlane
from mptrac_tpu.ops import pallas_interp as jrows
from mptrac_tpu_torch.ops import fast_interp as tfast
from mptrac_tpu_torch.ops import interp as tinterp
from mptrac_tpu_torch.ops import lane_interp as tlane
from mptrac_tpu_torch.ops import pallas_interp as trows
from mptrac_tpu_torch.ops import rk_fused as trk
from mptrac_tpu_torch.ops import slab_interp as tsl


def _grid(noise: bool):
    """The 60x31x10 solid-body met pair of tests/test_pallas_interp.py,
    with noise on u, v, w and T if asked, and 24576 parcels sorted by
    cell."""
    met01 = stack_met(
        make_wind_met(t0=0.0, alpha=30.0, nx=60, ny=31, nz=10),
        make_wind_met(t0=86400.0, alpha=30.0, nx=60, ny=31, nz=10))
    rng = np.random.default_rng(3)
    if noise:
        f3 = dict(met01.fields3d)
        for name, amp in (("u", 5.0), ("v", 5.0), ("w", 0.05),
                          ("t", 20.0)):
            f3[name] = jnp.asarray(np.array(f3[name]) + rng.normal(
                0.0, amp, f3[name].shape).astype(np.float32))
        met01 = met01.replace(fields3d=f3)
    n = 24576
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-85, 85, n)
    p = rng.uniform(120, 950, n)
    ts = np.full(n, 43200.0)
    met0 = jax.tree.map(lambda x: x[0], met01)
    loc = jinterp.locate_3d(met0, jnp.asarray(lon), jnp.asarray(lat),
                            jnp.asarray(p))
    ny, npl = met01.lat.shape[-1], met01.p.shape[-1]
    base = np.asarray((loc.ix * ny + loc.iy) * npl + loc.iz, np.int32)
    order = np.argsort(base, kind="stable")
    wt = (np.asarray(met01.time[1]) - ts) / float(met01.time[1]
                                                  - met01.time[0])
    w4 = np.stack([np.asarray(loc.wx), np.asarray(loc.wy),
                   np.asarray(loc.wz), wt]).astype(np.float32)[:, order]
    _, _, tmet, _ = to_torch(met01=met01)
    return dict(met01=met01, tmet=tmet, base=base[order], w4=w4,
                ix=np.asarray(loc.ix)[order], iy=np.asarray(loc.iy)[order],
                iz=np.asarray(loc.iz)[order], ny=ny, npl=npl,
                nx=met01.lon.shape[-1])


@pytest.fixture(scope="module")
def grid():
    return _grid(noise=True)


@pytest.fixture(scope="module")
def smooth():
    return _grid(noise=False)


def test_tables_equal_reference(grid):
    """build_advect_pack64 and build_advect_pack: the JAX tables, bit
    for bit."""
    np.testing.assert_array_equal(
        tfast.build_advect_pack64(grid["tmet"]).numpy(),
        np.asarray(jfast.build_advect_pack64(grid["met01"])))
    np.testing.assert_array_equal(
        tfast.build_advect_pack(grid["tmet"]).numpy(),
        np.asarray(jfast.build_advect_pack(grid["met01"])))
    t = tlane.build_lane_tables(grid["tmet"])
    assert tuple(t.pack64.shape) == (61 * 31 * 10, 64)
    assert t.pack64.dtype == torch.float32


def test_rows_kernel_matches_pallas(smooth):
    """K7 against ``interp_uvw_sorted`` (interpret mode) where its slab
    covered the parcel, and against ``interp_uvw_packed`` on every
    parcel, on the solid-body wind as tests/test_pallas_interp.py:15-57
    has it: the same float32 operations, the jitted graph may contract
    multiply-adds and the packed path takes the time weight in float64
    (:56): rtol 2e-6, atol 5e-7."""
    grid = smooth
    met01, ny, npl = grid["met01"], grid["ny"], grid["npl"]
    pack_j = jfast.build_advect_pack(met01)
    wts_j = jnp.asarray(grid["w4"].T)
    uvw_j, ok = jrows.interp_uvw_sorted(
        pack_j, jnp.asarray(grid["base"]), wts_j, strides=(ny * npl, npl),
        slab_rows=4096, interpret=True)
    ok = np.asarray(ok)
    assert ok.mean() > 0.95

    pack_t = tfast.build_advect_pack(grid["tmet"])
    uvw_t, ok_t = trows.interp_uvw_sorted(
        pack_t, torch.from_numpy(grid["base"]),
        torch.from_numpy(np.ascontiguousarray(grid["w4"].T)),
        (ny * npl, npl))
    assert tuple(uvw_t.shape) == (grid["base"].shape[0], 3)
    assert uvw_t.dtype == torch.float32 and bool(ok_t.all())
    np.testing.assert_allclose(uvw_t.numpy()[ok], np.asarray(uvw_j)[ok],
                               rtol=2e-6, atol=5e-7)
    loc = jinterp.Locator(
        ix=jnp.asarray(grid["ix"]), iy=jnp.asarray(grid["iy"]),
        iz=jnp.asarray(grid["iz"]), wx=wts_j[:, 0], wy=wts_j[:, 1],
        wz=wts_j[:, 2])
    ref = jfast.interp_uvw_packed(met01, pack_j, jnp.full(
        grid["base"].shape[0], 43200.0), loc)
    np.testing.assert_allclose(uvw_t.numpy().astype(np.float64),
                               np.stack([np.asarray(r) for r in ref], -1),
                               rtol=2e-6, atol=5e-7)


def test_lane_kernel_matches_pallas():
    """K6 against ``interp_uvwt_sorted`` and ``meso_sigma_sorted``
    (interpret mode) on the random table of
    tests/test_pallas_interp.py:75-118, sorted and unsorted, with its
    tolerances (float32 multiply-add contraction in the jitted graph):
    interpolation atol 2e-6, rtol 1e-5; sigma atol 2e-6, rtol 1e-4."""
    ncell, n = 40_000, 20_000
    rng = np.random.default_rng(0)
    pack64 = rng.standard_normal((ncell, 64)).astype(np.float32)
    ncellp = -(-ncell // 128) * 128
    jt = jlane.LaneTables(
        packT=jnp.pad(jnp.asarray(pack64).T, ((0, 0), (0, ncellp - ncell))),
        pack64=jnp.asarray(pack64))
    tt = tlane.LaneTables(pack64=torch.from_numpy(pack64))
    base = np.sort(rng.integers(0, ncell - 1, n)).astype(np.int32)
    w = rng.random((4, n)).astype(np.float32)

    uvw_j, t_j, frac = jlane.interp_uvwt_sorted(
        jt, jnp.asarray(base), jnp.asarray(w), nwin=4, interpret=True)
    uvw_t, t_t, served = tlane.interp_uvwt_sorted(
        tt, torch.from_numpy(base), torch.from_numpy(w))
    assert float(frac) > 0.99 and served == 1.0
    assert tuple(uvw_t.shape) == (3, n) and tuple(t_t.shape) == (n,)
    np.testing.assert_allclose(uvw_t.numpy(), np.asarray(uvw_j),
                               atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j),
                               atol=2e-6, rtol=1e-5)

    sig_j, _ = jlane.meso_sigma_sorted(jt, jnp.asarray(base), nwin=4,
                                       interpret=True)
    sig_t, served = tlane.meso_sigma_sorted(tt, torch.from_numpy(base))
    assert served == 1.0 and tuple(sig_t.shape) == (3, n)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j),
                               atol=2e-6, rtol=1e-4)

    # unsorted: the JAX side repairs every parcel through its fallback
    basep = rng.permutation(base)[:2000]
    wp = np.ascontiguousarray(w[:, :2000])
    uvw_ju, t_ju, _ = jlane.interp_uvwt_sorted(
        jt, jnp.asarray(basep), jnp.asarray(wp), nwin=4, cap_frac=1,
        interpret=True)
    uvw_tu, t_tu, _ = tlane.interp_uvwt_sorted(
        tt, torch.from_numpy(basep), torch.from_numpy(wp))
    np.testing.assert_allclose(uvw_tu.numpy(), np.asarray(uvw_ju),
                               atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(t_tu.numpy(), np.asarray(t_ju),
                               atol=2e-6, rtol=1e-5)


def test_same_function_on_three_tables(grid):
    """K6 and K7 compute what K4 and K5 compute, from other table
    layouts: on the same parcels the plain versions share their
    arithmetic, so the values are equal bit for bit."""
    tmet, nx, ny, npl = grid["tmet"], grid["nx"], grid["ny"], grid["npl"]
    ix, iy, iz = grid["ix"], grid["iy"], grid["iz"]
    table = trk.build_cell_table(tmet)
    cell = torch.from_numpy(((iz * nx + ix) * ny + iy).astype(np.int32))
    base = torch.from_numpy(grid["base"])
    w4 = torch.from_numpy(grid["w4"])
    k4 = tsl.interp_uvwt(table, cell, tuple(w4))
    k5 = tsl.meso_sigma(table, cell)
    lanes = tlane.build_lane_tables(tmet)
    uvw6, t6, _ = tlane.interp_uvwt_sorted(lanes, base, w4)
    sig6, _ = tlane.meso_sigma_sorted(lanes, base)
    uvw7, _ = trows.interp_uvw_sorted(
        tfast.build_advect_pack(tmet), base, w4.T.contiguous(),
        (ny * npl, npl))
    np.testing.assert_array_equal(uvw6.numpy(), k4[:3].numpy())
    np.testing.assert_array_equal(t6.numpy(), k4[3].numpy())
    np.testing.assert_array_equal(sig6.numpy(), k5.numpy())
    np.testing.assert_array_equal(uvw7.numpy().T, k4[:3].numpy())
    # and K4 agrees with the exact path there (tests/test_slab_interp.py
    # :58: rtol 3e-6, atol 2e-5)
    loc = tinterp.Locator(*(torch.from_numpy(a) for a in (ix, iy, iz)),
                          w4[0], w4[1], w4[2])
    ts = torch.full((ix.shape[0],), 43200.0, dtype=torch.float64)
    tm32 = tmet.replace(lon=tmet.lon.float(), lat=tmet.lat.float(),
                        p=tmet.p.float())
    for k, name in enumerate("uvwt"):
        exp = tinterp.interp_time_3d(tm32, name, ts, loc)
        np.testing.assert_allclose(k4[k].numpy(), exp.numpy(), rtol=3e-6,
                                   atol=2e-5, err_msg=name)


def test_lane_and_cell_tables_clamp_alike(grid):
    """At cells on the last node of an axis the 64-wide table's edge
    padding and K4/K5's clamped strides give the same corners."""
    tmet, nx, ny, npl = grid["tmet"], grid["nx"], grid["ny"], grid["npl"]
    rng = np.random.default_rng(5)
    m = 512
    ix = rng.integers(nx - 2, nx, m)
    iy = rng.integers(ny - 2, ny, m)
    iz = rng.integers(npl - 2, npl, m)
    assert ((ix == nx - 1) & (iy == ny - 1) & (iz == npl - 1)).any()
    w4 = torch.from_numpy(rng.random((4, m)).astype(np.float32))
    cell = torch.from_numpy(((iz * nx + ix) * ny + iy).astype(np.int32))
    base = torch.from_numpy(((ix * ny + iy) * npl + iz).astype(np.int32))
    table = trk.build_cell_table(tmet)
    lanes = tlane.build_lane_tables(tmet)
    uvw6, t6, _ = tlane.interp_uvwt_sorted(lanes, base, w4)
    k4 = tsl.interp_uvwt(table, cell, tuple(w4))
    np.testing.assert_array_equal(uvw6.numpy(), k4[:3].numpy())
    np.testing.assert_array_equal(t6.numpy(), k4[3].numpy())
    np.testing.assert_array_equal(
        tlane.meso_sigma_sorted(lanes, base)[0].numpy(),
        tsl.meso_sigma(table, cell).numpy())


def test_rows_table_clamps_at_its_last_row(grid):
    """A base on the last node of every axis: the 8-wide table's corners
    past its last row read the last row, which is the corner that K4's
    clamped strides give there."""
    tmet, nx, ny, npl = grid["tmet"], grid["nx"], grid["ny"], grid["npl"]
    rng = np.random.default_rng(6)
    m = 16
    ix, iy, iz = nx - 1, ny - 1, npl - 1
    w4 = torch.from_numpy(rng.random((4, m)).astype(np.float32))
    base = torch.full((m,), (ix * ny + iy) * npl + iz, dtype=torch.int32)
    cell = torch.full((m,), (iz * nx + ix) * ny + iy, dtype=torch.int32)
    pack8 = tfast.build_advect_pack(tmet)
    assert int(base[0]) == pack8.shape[0] - 1
    uvw7, ok = trows.interp_uvw_sorted(pack8, base, w4.T.contiguous(),
                                       (ny * npl, npl))
    k4 = tsl.interp_uvwt(trk.build_cell_table(tmet), cell, tuple(w4))
    assert bool(ok.all())
    np.testing.assert_array_equal(uvw7.T.numpy(), k4[:3].numpy())


def test_every_parcel_is_served():
    """Random bases over the whole table, in no order: all served, all
    finite (where the TPU kernels flag most of them)."""
    rng = np.random.default_rng(7)
    ncell = 50000
    pack = torch.from_numpy(rng.normal(size=(ncell, 8)).astype(np.float32))
    base = torch.from_numpy(rng.integers(0, ncell - 2000, 600)
                            .astype(np.int32))
    wts = torch.from_numpy(rng.uniform(0, 1, (600, 4)).astype(np.float32))
    uvw, ok = trows.interp_uvw_sorted(pack, base, wts, (1200, 40))
    assert bool(ok.all()) and bool(torch.isfinite(uvw).all())
    # against a direct evaluation of one parcel
    b, (wx, wy, wz, wt) = int(base[17]), (float(x) for x in wts[17])
    c = {(dx, dy, dz): pack[b + dx * 1200 + dy * 40 + dz].double()
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}

    def lerp(w, a, b_):
        return w * (a - b_) + b_
    a0 = lerp(wy, lerp(wz, c[0, 0, 0], c[0, 0, 1]),
              lerp(wz, c[0, 1, 0], c[0, 1, 1]))
    a1 = lerp(wy, lerp(wz, c[1, 0, 0], c[1, 0, 1]),
              lerp(wz, c[1, 1, 0], c[1, 1, 1]))
    v = lerp(wx, a0, a1)
    np.testing.assert_allclose(uvw[17].numpy(),
                               lerp(wt, v[0:3], v[3:6]).numpy(), atol=5e-6)


def test_table_shapes_checked():
    z = torch.zeros(4, dtype=torch.int32)
    w = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="64"):
        tlane.interp_uvwt_sorted(tlane.LaneTables(torch.zeros((10, 8))),
                                 z, w)
    with pytest.raises(ValueError, match="8"):
        trows.interp_uvw_sorted(torch.zeros((10, 64)), z, w, (2, 1))
