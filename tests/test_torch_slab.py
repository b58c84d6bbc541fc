"""K2, K3, K4 and K5, the plain PyTorch versions of the
surface-interpolation, column-permute, wind-interpolation and
subgrid-sigma kernels, against the JAX package; and the port's
module_sort against the JAX module_sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import small_flagship_fp32, to_torch
from mptrac_tpu.ops import interp as jinterp
from mptrac_tpu.ops import slab_interp as jsl
from mptrac_tpu.ops import sort as jsort
from mptrac_tpu_torch.ops import interp as tinterp
from mptrac_tpu_torch.ops import slab_interp as tsl
from mptrac_tpu_torch.ops import sort as tsort


@pytest.fixture(scope="module")
def setup():
    ctl, clim, met01, atm, cache = small_flagship_fp32()
    # give the surface fields structure, then plant a NaN in one corner
    # of one field and in one whole snapshot of another
    rng = np.random.default_rng(8)
    f2 = dict(met01.fields2d)
    shape = f2["ps"].shape
    for k, name in enumerate(jsl.SFC_FIELDS):
        f = rng.uniform(1.0, 2.0, shape).astype(np.float32) * (k + 1)
        f[:, -1] = f[:, 0]      # the wraparound column repeats the first
        f2[name] = jnp.asarray(f)
    pbl = np.array(f2["pbl"])
    pbl[0, 7, 9] = np.nan
    f2["pbl"] = jnp.asarray(pbl)
    zs = np.array(f2["zs"])
    zs[1] = np.nan
    f2["zs"] = jnp.asarray(zs)
    met01 = met01.replace(fields2d=f2)
    atm, cache = jax.jit(jsort.module_sort)(met01, atm, cache)
    n = atm.npmax
    ts = jnp.asarray(rng.uniform(0.0, 3600.0, n))
    atm = atm.replace(time=ts)
    tatm, tcache, tmet, _ = to_torch(atm, cache, met01)
    return met01, atm, cache, tmet, tatm, tcache


NAMES = ("pbl", "ps", "zs", "h2ot")


def test_sfc_plain_matches_pallas_and_exact(setup):
    """Against the Pallas surface kernel (interpret mode) and against
    the exact ``interp_time_2d``: the same float32 operations in the
    same order; the jitted kernel may contract a*b+c, so 4 ulp of the
    values (up to 32): atol 1.6e-5.  The NaN corner falls back to the
    nearest corner, the NaN snapshot to the other snapshot (or is
    returned as NaN where it is the nearer one), in all three.

    The exact path is the yardstick for every parcel.  The Pallas
    kernel has to agree on more than 95 % of them: on fields that vary
    from column to column it serves a few percent of the parcels near
    the longitude seam wrong values at this size (its cyclic unwrap, a
    fault of the reference side that uniform surface fields hide)."""
    met01, atm, cache, tmet, tatm, tcache = setup
    loc_j = jinterp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    loc_t = tinterp.locate_3d(tmet, tatm.lon, tatm.lat, tatm.p)
    sfcT = jsl.build_sfcT(met01)
    exp_k = jsl.sfc_from_loc(jsl.SlabTables(sfcT=sfcT), met01, NAMES,
                             atm.time, loc_j, interpret=True)
    table = tsl.build_sfc_table(tmet)
    assert tuple(table.shape) == (tmet.nx, tmet.ny, 2, 16)
    got = tsl.sfc_from_loc(table, tmet, NAMES, tatm.time, loc_t)
    for name in NAMES:
        exp_x = np.asarray(jinterp.interp_time_2d(met01, name, atm.time,
                                                  loc_j))
        g = got[name].numpy()
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, exp_x, rtol=0, atol=1.6e-5,
                                   equal_nan=True, err_msg=name)
        same = np.isclose(g, np.asarray(exp_k[name]), rtol=0,
                          atol=1.6e-5, equal_nan=True)
        assert same.mean() > 0.95, (name, same.mean())
    # the planted corner is really used by some parcel
    ix, iy = loc_t.ix.numpy(), loc_t.iy.numpy()
    touch = ((ix == 7) | (ix == 6)) & ((iy == 9) | (iy == 8))
    assert touch.any()
    # (where the NaN corner is also the nearest one, the value comes
    # from the other snapshot, or stays NaN when snapshot 0 is nearer)
    assert np.isfinite(got["pbl"].numpy()[touch]).any()
    assert np.isfinite(got["pbl"].numpy()[~touch]).all()
    assert np.isnan(got["zs"].numpy()).any()
    assert np.isfinite(got["zs"].numpy()).any()


def test_sfc_field_list_checked(setup):
    _, _, _, tmet, tatm, _ = setup
    table = tsl.build_sfc_table(tmet)
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="field list"):
        tsl.interp_sfc(table, torch.zeros(4, dtype=torch.int32),
                       (z, z, z), (16,))


@pytest.mark.parametrize("ncols,with64", [(0, True), (1, False), (9, True)])
def test_permute_cols_plain_bit_exact(ncols, with64):
    rng = np.random.default_rng(9)
    n = 5000
    cols = [rng.standard_normal(n).astype(np.float32)
            for _ in range(ncols)]
    c64 = rng.uniform(0, 1e9, n) if with64 else None
    perm = rng.permutation(n)
    out32, out64 = tsl.permute_cols(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(perm),
        torch.from_numpy(c64) if with64 else None)
    assert tuple(out32.shape) == (ncols, n)
    for k, c in enumerate(cols):
        np.testing.assert_array_equal(out32[k].numpy(), c[perm])
    if with64:
        np.testing.assert_array_equal(out64.numpy(), c64[perm])
    else:
        assert out64 is None


def _perm_of_kind(kind, n, rng):
    if kind == "identity":
        return np.arange(n)
    if kind == "random":
        return rng.permutation(n)
    if kind == "drifted":
        # a re-sort: cells of 25 parcels in the sorted order, 60 % of the
        # parcels drift into the cell 181 further on (the next longitude
        # column of a level-major key), argsorted stably
        key = np.arange(n) // 25 + 181 * (rng.uniform(0.0, 1.0, n) < 0.6)
        return np.argsort(key, kind="stable")
    # blocks of 4096 shuffled within themselves
    return np.argsort(np.arange(n) // 4096 + rng.uniform(0.0, 1.0, n),
                      kind="stable")


@pytest.mark.parametrize("kind,plan", [("random", "rows"),
                                       ("banded", "rows"),
                                       ("identity", "gather"),
                                       ("drifted", "gather")])
def test_permute_plan_picks_the_path(kind, plan):
    """The K3 path from the count pass: where nearly every output starts a
    sector of its own (a random order, blocks of 4096 shuffled) the row
    path; where outputs come in runs of neighbouring sources (the
    identity, a stable re-sort of drifted parcels) the gather path."""
    rng = np.random.default_rng(11)
    n = 1_000_000
    perm = torch.from_numpy(_perm_of_kind(kind, n, rng))
    assert tsl.permute_plan(perm) == plan


def test_permute_sectors_by_definition():
    """The count pass's plain version against the definition, output by
    output, on a permutation whose last block read is partial: of every
    8th block of 256 outputs, the first of every 32 outputs and each
    whose source lies in another 8-value sector than the previous
    output's."""
    rng = np.random.default_rng(12)
    every = tsl.PERMUTE_COUNT_BLOCK * tsl.PERMUTE_COUNT_EVERY
    n = 5 * every + 100
    assert tsl.permute_sampled(n) == 5 * tsl.PERMUTE_COUNT_BLOCK + 100
    perm = _perm_of_kind("drifted", n, rng)
    perm[::97] = perm[::97][::-1]          # far movers
    want = sum(i % every < tsl.PERMUTE_COUNT_BLOCK
               and (i % 32 == 0 or j // 8 != perm[i - 1] // 8)
               for i, j in enumerate(perm.tolist()))
    assert tsl.permute_sectors(torch.from_numpy(perm)) == want
    # the identity: one sector every 8 outputs read
    assert tsl.permute_sectors(torch.arange(n)) == (
        tsl.permute_sampled(n) + 7) // 8


def test_permute_matches_jax_permute_f32_cols():
    """The JAX banded permute kernel (interpret mode) on a banded
    permutation: same columns out, bit for bit."""
    rng = np.random.default_rng(10)
    n = 4096
    perm = np.arange(n).reshape(-1, 64)
    perm = np.concatenate([rng.permutation(r) for r in perm])
    cols = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    exp = jsl.permute_f32_cols([jnp.asarray(c) for c in cols],
                               jnp.asarray(perm, jnp.int32),
                               interpret=True)
    out32, _ = tsl.permute_cols([torch.from_numpy(c) for c in cols],
                                torch.from_numpy(perm))
    for k in range(3):
        np.testing.assert_array_equal(out32[k].numpy(), np.asarray(exp[k]))


def test_module_sort_bit_exact(setup):
    """A shuffled ensemble through both module_sort: same key, same
    stable order, same permuted state in every column, bit for bit."""
    met01, atm, cache, tmet, _, _ = setup
    rng = np.random.default_rng(11)
    n = atm.npmax
    perm0 = rng.permutation(n)
    uvwp = rng.standard_normal((3, n)).astype(np.float32)
    atm_r = atm.replace(
        time=atm.time[perm0], lon=atm.lon[perm0], lat=atm.lat[perm0],
        p=atm.p[perm0],
        q={"t": jnp.asarray(rng.uniform(200, 300, n), jnp.float32),
           "m": jnp.asarray(rng.uniform(0, 1, n), jnp.float32)})
    cache_r = cache.replace(
        uvwp=jnp.asarray(uvwp),
        dt=jnp.asarray(rng.uniform(0, 180, n), jnp.float32))
    tatm, tcache, _, _ = to_torch(atm_r, cache_r)
    tcache = tcache.replace(served_min=0.5)

    key_j = np.asarray(jsort.sort_key(met01, atm_r))
    key_t = tsort.sort_key(tmet, tatm).numpy()
    np.testing.assert_array_equal(key_t, key_j)

    a_j, c_j = jax.jit(jsort.module_sort)(met01, atm_r, cache_r)
    a_t, c_t = tsort.module_sort(tmet, tatm, tcache)
    for name in ("time", "lon", "lat", "p"):
        np.testing.assert_array_equal(getattr(a_t, name).numpy(),
                                      np.asarray(getattr(a_j, name)), name)
    for k in ("t", "m"):
        np.testing.assert_array_equal(a_t.q[k].numpy(),
                                      np.asarray(a_j.q[k]), k)
    np.testing.assert_array_equal(c_t.uvwp.numpy(), np.asarray(c_j.uvwp))
    np.testing.assert_array_equal(c_t.dt.numpy(), np.asarray(c_j.dt))
    assert c_t.uvwp.is_contiguous() and tuple(c_t.uvwp.shape) == (3, n)
    assert c_t.served_min == 1.0 and a_t.np == int(a_j.np)
    assert a_t.time.dtype == torch.float64
    # and against numpy's stable argsort of the key
    order = np.argsort(key_j, kind="stable")
    np.testing.assert_array_equal(a_t.lon.numpy(),
                                  np.asarray(atm_r.lon)[order])


def test_module_sort_keeps_padding_last(setup):
    """Parcels beyond np carry the largest key and stay at the end."""
    _, _, _, tmet, tatm, tcache = setup
    n = tatm.npmax
    a = tatm.replace(np=n - 100)
    a2, _ = tsort.module_sort(tmet, a, tcache)
    np.testing.assert_array_equal(a2.lon[n - 100:].numpy(),
                                  a.lon[n - 100:].numpy())


# ------------------------------------------------------------ K4, K5

@pytest.fixture(scope="module")
def wind():
    """The small flagship with 3-D fields that vary from node to node
    (the solid-body wind plus noise; the wraparound column repeats the
    first), sorted parcels with random times."""
    ctl, clim, met01, atm, cache = small_flagship_fp32()
    rng = np.random.default_rng(21)
    f3 = dict(met01.fields3d)
    for name, amp in (("u", 5.0), ("v", 5.0), ("w", 0.05), ("t", 20.0)):
        f = np.array(f3[name]) + rng.normal(
            0.0, amp, f3[name].shape).astype(np.float32)
        f[:, -1] = f[:, 0]
        f3[name] = jnp.asarray(f)
    met01 = met01.replace(fields3d=f3)
    atm, cache = jax.jit(jsort.module_sort)(met01, atm, cache)
    n = atm.npmax
    atm = atm.replace(time=jnp.asarray(rng.uniform(0.0, 3600.0, n)))
    tatm, _, tmet, _ = to_torch(atm, cache, met01)
    return met01, atm, tmet, tatm, rng.permutation(n)


def _exact_sigma(met01, ix, iy, iz):
    """The 16-point stencil of the exact module_diff_meso
    (physics/diffusion.py:222-243 of the JAX package) in numpy float32,
    in the reference's order."""
    out = []
    for name in ("u", "v", "w"):
        f = np.asarray(met01.fields3d[name])
        mean = np.zeros(ix.shape[0], np.float32)
        msq = np.zeros(ix.shape[0], np.float32)
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    for t in (0, 1):
                        val = f[t, ix + di, iy + dj, iz + dk]
                        mean = mean + val
                        msq = msq + val * val
        var = msq / np.float32(16.0) - (mean / np.float32(16.0)) ** 2
        out.append(np.where(var > 0, np.sqrt(np.maximum(var, 0)), 0.0))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_uvwt_plain_matches_exact_and_pallas(wind, order):
    """K4 against the exact ``interp_time_3d`` of both packages on every
    parcel, and against the Pallas kernel (mode "uvwt", interpret mode)
    on the share that agrees.  The exact path interpolates each
    snapshot in space and then in time in the same ``w*(a-b)+b`` form;
    the jitted graph may contract multiply-adds: the JAX tests'
    tolerance for this pair (tests/test_slab_interp.py:58), rtol 3e-6,
    atol 2e-5.

    The Pallas kernel has to agree on more than 95 % of the parcels:
    its cyclic unwrap, shared by all modes, serves a few percent near
    the longitude seam wrong values on fields that vary from column to
    column (seen first in the surface mode)."""
    met01, atm, tmet, tatm, perm = wind
    if order == "unsorted":
        atm = atm.replace(time=atm.time[perm], lon=atm.lon[perm],
                          lat=atm.lat[perm], p=atm.p[perm])
        tatm = tatm.replace(**{k: getattr(tatm, k)[torch.from_numpy(perm)]
                               for k in ("time", "lon", "lat", "p")})
    loc_j = jinterp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    loc_t = tinterp.locate_3d(tmet, tatm.lon, tatm.lat, tatm.p)
    table = tsl.rk_fused.build_cell_table(tmet)
    assert tuple(table.shape) == (tmet.npl, tmet.nx, tmet.ny, 8)
    got = tsl.uvwt_from_loc(table, tmet, tatm.time, loc_t)

    tables = jsl.build_slab_tables(met01, sfc=False)
    ny, npl, nx = tmet.ny, tmet.npl, tmet.nx
    base = ((loc_j.ix * ny + loc_j.iy) * npl + loc_j.iz).astype(jnp.int32)
    wt = jinterp.time_weight(met01, atm.time)
    w4 = tuple(x.astype(jnp.float32)
               for x in (loc_j.wx, loc_j.wy, loc_j.wz, wt))
    exp_k, served = jsl.interp_uvwt(tables, base, w4, npl, ny * npl,
                                    (nx - 1) * ny * npl, cap_frac=1,
                                    interpret=True)
    for k, name in enumerate(("u", "v", "w", "t")):
        g = got[k].numpy()
        assert g.dtype == np.float32
        exp_j = np.asarray(jinterp.interp_time_3d(met01, name, atm.time,
                                                  loc_j))
        exp_t = tinterp.interp_time_3d(tmet, name, tatm.time,
                                       loc_t).numpy()
        np.testing.assert_allclose(g, exp_j, rtol=3e-6, atol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(g, exp_t, rtol=3e-6, atol=2e-5,
                                   err_msg=name)
        same = np.isclose(g, np.asarray(exp_k[k]), rtol=3e-6, atol=2e-5)
        print(f"uvwt {order} {name}: Pallas agrees on {same.mean():.4f}")
        assert same.mean() > 0.95, (name, same.mean())
    # the noise is really sampled: the fields differ from parcel to parcel
    assert float(got[3].std()) > 1.0 and float(got[2].std()) > 1e-3


@pytest.mark.parametrize("order,use_sigT", [
    ("sorted", False), ("unsorted", False), ("sorted", True),
    ("unsorted", True)],
    ids=["sorted", "unsorted", "sorted-sigT", "unsorted-sigT"])
def test_meso_sigma_plain_matches_exact_and_pallas(wind, order, use_sigT):
    """K5 against the exact 16-point stencil on every parcel, and
    against the Pallas kernel (mode "meso", interpret mode) on the share
    that agrees (> 95 %, see the uvwt test).  The sums run in the same
    order in float32; the variance cancels several digits, so the JAX
    tests' tolerance for this pair (tests/test_slab_interp.py:122):
    rtol 1e-2, atol 2e-3.  ``-sigT``: gathered from the table of every
    cell's sigma (``sigma_table``), as the unfused step does."""
    met01, atm, tmet, tatm, perm = wind
    loc_t = tinterp.locate_3d(tmet, tatm.lon, tatm.lat, tatm.p)
    ix, iy, iz = (loc_t.ix.numpy(), loc_t.iy.numpy(), loc_t.iz.numpy())
    if order == "unsorted":
        ix, iy, iz = ix[perm], iy[perm], iz[perm]
    ny, npl, nx = tmet.ny, tmet.npl, tmet.nx
    table = tsl.rk_fused.build_cell_table(tmet)
    cell = torch.from_numpy(((iz * nx + ix) * ny + iy).astype(np.int32))
    sigT = tsl.sigma_table(table) if use_sigT else None
    got = tsl.meso_sigma(table, cell, sigT).numpy()
    assert got.shape == (3, ix.shape[0]) and got.dtype == np.float32
    exp = _exact_sigma(met01, ix, iy, iz)
    np.testing.assert_allclose(got, exp, rtol=1e-2, atol=2e-3)
    assert float(got[:2].min()) > 0.1      # noise of sigma 5 in u and v

    tables = jsl.build_slab_tables(met01, sfc=False)
    base = jnp.asarray((ix * ny + iy) * npl + iz, jnp.int32)
    exp_k, served = jsl.meso_sigma(tables, base, npl, ny * npl,
                                   (nx - 1) * ny * npl, cap_frac=1,
                                   interpret=True)
    same = np.isclose(got, np.stack([np.asarray(x) for x in exp_k]),
                      rtol=1e-2, atol=2e-3).all(axis=0)
    print(f"meso {order}: Pallas agrees on {same.mean():.4f}")
    assert same.mean() > 0.95, same.mean()


def test_uvwt_and_sigma_clamp_at_the_last_node(wind):
    """A cell on the last node of an axis repeats that node for its
    upper corner, as the edge padding of the JAX tables does: the value
    there does not depend on the weight of that axis."""
    _, _, tmet, _, _ = wind
    table = tsl.rk_fused.build_cell_table(tmet)
    npl, nx, ny = table.shape[:3]
    iz, ix, iy = npl - 1, nx - 1, ny - 1
    cell = torch.tensor([(iz * nx + ix) * ny + iy], dtype=torch.int32)
    one, half = torch.ones(1), torch.full((1,), 0.5)
    a = tsl.interp_uvwt(table, cell, (one, one, one, one))
    b = tsl.interp_uvwt(table, cell, (half, half, half, one))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a[:3, 0].numpy(),
                                  table[iz, ix, iy, 0:3].numpy())
    assert float(a[3, 0]) == float(table[iz, ix, iy, 6])
    # 16 values that are 8 copies of two: sigma of the two snapshots
    s = tsl.meso_sigma(table, cell)
    u0, u1 = float(table[iz, ix, iy, 0]), float(table[iz, ix, iy, 3])
    assert abs(float(s[0, 0]) - abs(u0 - u1) / 2) < 2e-3
    with pytest.raises(ValueError, match="table"):
        tsl.interp_uvwt(table[..., :4], cell, (one, one, one, one))


def _edge_cells(table):
    """Flat cells on the last node of each axis and of each pair of axes
    and of all three (their upper corners are clamped), and cells one
    node short of it."""
    npl, nx, ny = table.shape[:3]
    cells = []
    for iz in (0, npl - 2, npl - 1):
        for ix in (0, nx - 2, nx - 1):
            for iy in (0, ny - 2, ny - 1):
                cells.append((iz * nx + ix) * ny + iy)
    return torch.tensor(cells, dtype=torch.int32)


def test_sigma_table_gathers_to_the_stencil(wind):
    """K5's table holds each cell's stencil, bit for bit: the table of
    every cell's sigma, gathered at the parcels' cells (sorted and in a
    random order) and at cells on the last node of each axis (clamped
    corners), equals the stencil of each parcel's cell
    (``meso_sigma_plain``), through ``meso_sigma`` and through the plain
    gather."""
    _, _, tmet, tatm, perm = wind
    table = tsl.rk_fused.build_cell_table(tmet)
    loc = tinterp.locate_3d(tmet, tatm.lon, tatm.lat, tatm.p)
    cell = torch.cat([tsl.cell_from_loc(table, loc), _edge_cells(table)])
    cell = torch.cat([cell, cell[torch.from_numpy(perm)]])
    exp = tsl.meso_sigma_plain(table, cell)
    sigT = tsl.sigma_table(table)
    npl, nx, ny = table.shape[:3]
    assert tuple(sigT.shape) == (npl * nx * ny, 4)
    assert torch.equal(sigT[cell.long(), :3].T, exp)
    assert float(sigT[:, 3].abs().max()) == 0.0
    assert torch.equal(tsl.meso_gather_plain(sigT, cell), exp)
    assert torch.equal(tsl.meso_sigma(table, cell, sigT), exp)
    # the plain table in chunks of 1000 cells is the same table
    old = tsl.SIGMA_PLAIN_CHUNK
    try:
        tsl.SIGMA_PLAIN_CHUNK = 1000
        assert torch.equal(tsl.sigma_table_plain(table), sigT)
    finally:
        tsl.SIGMA_PLAIN_CHUNK = old


def test_meso_sigma_checks_the_table_shape(wind):
    """A sigma table of another shape than the cell table's raises."""
    _, _, tmet, _, _ = wind
    table = tsl.rk_fused.build_cell_table(tmet)
    cell = torch.zeros(4, dtype=torch.int32)
    sigT = tsl.sigma_table(table)
    for bad in (sigT[1:], sigT[:, :3], sigT.T.contiguous()):
        with pytest.raises(ValueError, match="sigma table of shape"):
            tsl.meso_sigma(table, cell, bad)
