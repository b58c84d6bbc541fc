"""The CUDA kernels of mptrac_tpu_torch against their plain PyTorch
versions, on the card.  These tests need an NVIDIA GPU and nvcc and
skip elsewhere; run them with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(``python3 chip_smoke.py`` makes the same comparisons at full size.)"""

import math

import numpy as np
import pytest
import torch

from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.ops import (interp, lane_interp, pallas_interp,
                                  rk_fused, slab_interp)
from mptrac_tpu_torch.ops.fast_interp import (build_advect_pack,
                                              build_met_pack)
from mptrac_tpu_torch.ops.sort import module_sort
from mptrac_tpu_torch.physics.timesteps import module_timesteps

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    ctl, clim, met01, atm, cache = flagship.make_setup(
        50_000, nx=36, ny=19, nz=8, device="cuda")
    pack = build_met_pack(met01, cell=True)
    atm, cache = module_sort(met01, atm, cache)
    cache = module_timesteps(ctl, cache, met01, atm, 180.0)
    return ctl, met01, atm, cache, pack


@pytest.mark.parametrize("nstage", [1, 2, 4])
def test_rk_kernel_matches_plain(card, nstage):
    """Same float32 operations, no contraction (-fmad=false), same
    cosf: 2 ulp of a position, 1 ulp of T, 1e-5 on sigma."""
    ctl, met01, atm, cache, pack = card
    wt0 = interp.time_weight(met01, atm.time).to(torch.float32)
    args = (atm.lon, atm.lat, atm.p, cache.dt, wt0)
    got, served = rk_fused.advect_all(pack.cell, nstage, *args)
    exp = rk_fused.rk_plain(pack.cell, nstage, *args)
    assert served == 1.0
    for g, e, tol in zip(got, exp, [3.1e-5, 3.1e-5, 1.3e-4, 1e-5, 1e-5,
                                    1e-5, 3.1e-5]):
        assert float((g - e).abs().max()) <= tol


def test_sfc_kernel_matches_plain(card):
    ctl, met01, atm, cache, pack = card
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    table = torch.rand(pack.sfcT.shape, device="cuda") * 1000.0 + 1.0
    table[5, 7, 1, 1] = float("nan")
    table[:, :, 0, 0] = float("nan")
    ny = table.shape[1]
    basexy = (loc.ix * ny + loc.iy).to(torch.int32)
    wt = torch.rand(atm.npmax, device="cuda")
    w3 = (loc.wx.contiguous(), loc.wy.contiguous(), wt)
    got = slab_interp.interp_sfc(table, basexy, w3, (1, 0, 9))
    exp = slab_interp.sfc_interp_plain(table, basexy, *w3, (1, 0, 9))
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=0, atol=1.3e-4, equal_nan=True)


def test_permute_kernel_bit_exact(card):
    ctl, met01, atm, cache, pack = card
    n = atm.npmax
    perm = torch.randperm(n, device="cuda")
    cols = [cache.uvwp[0], atm.lon, atm.p]
    got32, got64 = slab_interp.permute_cols(cols, perm, atm.time)
    exp32, exp64 = slab_interp.permute_cols_plain(cols, perm, atm.time)
    assert torch.equal(got32, exp32) and torch.equal(got64, exp64)


@pytest.fixture(scope="module")
def located(card):
    """The card fixture's parcels located in a random per-cell table,
    with one parcel on the last node of every axis (the clamp)."""
    ctl, met01, atm, cache, pack = card
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = torch.rand(pack.cell.table.shape, device="cuda",
                       generator=gen) * 100.0 - 50.0
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    cell = slab_interp.cell_from_loc(table, loc)
    npl, nx, ny = table.shape[:3]
    cell[0] = npl * nx * ny - 1
    w4 = tuple(x.contiguous() for x in (
        loc.wx, loc.wy, loc.wz, torch.rand(atm.npmax, device="cuda",
                                           generator=gen)))
    return table, cell, w4


def test_uvwt_kernel_matches_plain(located):
    """Same float32 operations, no contraction: 2 ulp of values under
    64 (7.7e-6)."""
    table, cell, w4 = located
    got = slab_interp.interp_uvwt(table, cell, w4)
    exp = slab_interp.uvwt_interp_plain(table, cell, *w4)
    assert float((got - exp).abs().max()) <= 7.7e-6


def test_meso_kernel_matches_plain(located, card):
    """On a random table and on the flagship's wind, where the variance
    cancels from ~1e3 down to ~1: the same sums in the same order, so
    bit for bit."""
    table, cell, _ = located
    for tab in (table, card[4].cell.table):
        got = slab_interp.meso_sigma(tab, cell)
        exp = slab_interp.meso_sigma_plain(tab, cell)
        assert torch.equal(got, exp)


def test_meso_sigma_table_kernel_bit_exact(located, card):
    """K5's table kernel against ``sigma_table_plain``, bit for bit, on
    a random table and on the flagship's wind (the cancelling case), on
    a grid of 8 x 37 x 19 = 5624 cells, no multiple of the 256-thread
    block; one launch a table."""
    from mptrac_tpu_torch.ops import _cuda
    table, _, _ = located
    for tab in (table, card[4].cell.table):
        ncell = tab.shape[0] * tab.shape[1] * tab.shape[2]
        assert ncell % 256 != 0
        before = _cuda.launch_counts["meso_sigma_table"]
        got = slab_interp.sigma_table(tab)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["meso_sigma_table"] == before + 1
        assert torch.equal(got, slab_interp.sigma_table_plain(tab))


def test_meso_sigma_gather_kernel_bit_exact(located, card):
    """K5's gather against the stencil of each parcel's cell
    (``meso_sigma_plain``), bit for bit: the located parcels in sorted
    and in random order, every cell on the last node of an axis (the
    clamp), a count no multiple of 4 and a cell stream that starts off a
    16-byte boundary (both parcel by parcel), on both tables.  One
    gather launch a call, no table launch."""
    from mptrac_tpu_torch.ops import _cuda
    table, cell, _ = located
    n = cell.shape[0]
    assert n % 4 == 0
    gen = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.randperm(n, device="cuda", generator=gen)
    npl, nx, ny = table.shape[:3]
    edge = torch.tensor(
        [(iz * nx + ix) * ny + iy for iz in (0, npl - 2, npl - 1)
         for ix in (0, nx - 2, nx - 1) for iy in (0, ny - 2, ny - 1)],
        dtype=torch.int32, device="cuda")
    for tab in (table, card[4].cell.table):
        sigT = slab_interp.sigma_table(tab)
        for c in (cell, cell[perm], edge, cell[:n - 1], cell[1:]):
            before = dict(_cuda.launch_counts)
            got = slab_interp.meso_sigma(tab, c, sigT)
            torch.cuda.synchronize()
            assert (_cuda.launch_counts["meso_sigma"],
                    _cuda.launch_counts["meso_sigma_table"]) == (
                before["meso_sigma"] + 1, before["meso_sigma_table"])
            assert torch.equal(got, slab_interp.meso_sigma_plain(tab, c))


def test_lane_and_rows_kernels_match_plain(card):
    """K6 (both modes) and K7 against their plain versions and against
    K4 and K5 on the same parcels: equal values from three tables."""
    ctl, met01, atm, cache, pack = card
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    ny, npl = met01.ny, met01.npl
    base = ((loc.ix * ny + loc.iy) * npl + loc.iz).to(torch.int32)
    w4 = torch.stack([loc.wx, loc.wy, loc.wz,
                      torch.rand(atm.npmax, device="cuda")])
    lanes = lane_interp.build_lane_tables(met01)
    uvw, t, served = lane_interp.interp_uvwt_sorted(lanes, base, w4)
    exp = lane_interp.interp_uvwt_plain(lanes.pack64, base, w4)
    assert served == 1.0
    assert float((torch.cat([uvw, t[None]]) - exp).abs().max()) <= 6.2e-5
    sig, _ = lane_interp.meso_sigma_sorted(lanes, base)
    assert float((sig - lane_interp.meso_sigma_plain(
        lanes.pack64, base)).abs().max()) <= 7.7e-6
    pack8 = build_advect_pack(met01)
    w4t = w4.T.contiguous()
    uvw7, ok = pallas_interp.interp_uvw_sorted(pack8, base, w4t,
                                               (ny * npl, npl))
    exp7 = pallas_interp.interp_uvw_plain(pack8, base, w4t, (ny * npl, npl))
    assert bool(ok.all()) and float((uvw7 - exp7).abs().max()) <= 7.7e-6
    # bases on the table's last rows: corners past it read the last row
    edge = torch.arange(pack8.shape[0] - 64, pack8.shape[0],
                        dtype=torch.int32, device="cuda")
    e7, _ = pallas_interp.interp_uvw_sorted(pack8, edge, w4t[:64],
                                            (ny * npl, npl))
    x7 = pallas_interp.interp_uvw_plain(pack8, edge, w4t[:64],
                                        (ny * npl, npl))
    assert float((e7 - x7).abs().max()) <= 7.7e-6
    table = pack.cell.table
    cell = slab_interp.cell_from_loc(table, loc)
    k4 = slab_interp.interp_uvwt(table, cell, tuple(w4))
    assert torch.equal(k4[:3], uvw) and torch.equal(k4[3], t)
    assert torch.equal(k4[:3], uvw7.T)
    assert torch.equal(slab_interp.meso_sigma(table, cell), sig)


@pytest.mark.parametrize("order", ["sorted", "drifted", "random", "single",
                                   "runs"])
def test_lane_meso_sigma_bit_exact(card, order):
    """K6's sigma mode (one sigma16 per run of equal cells in a warp's
    tile of 256 parcels) against ``meso_sigma_plain`` bit for bit, on
    the flagship's 64-wide table (the cancelling case) and on a random
    one: the card's
    sorted parcels; the same with 30 % of them moved to the cell of the
    parcel 300 places before (runs A B A B, as parcels that drift out of
    their cell after a sort); the same parcels in a random order; a
    single parcel; and runs of lengths that cross the warp's rows of 32
    and its tiles of 256, with a parcel count that is a multiple of
    neither.  One launch a call."""
    from mptrac_tpu_torch.ops import _cuda
    ctl, met01, atm, cache, pack = card
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    ny, npl = met01.ny, met01.npl
    base = ((loc.ix * ny + loc.iy) * npl + loc.iz).to(torch.int32)
    lanes = lane_interp.build_lane_tables(met01)
    gen = torch.Generator(device="cuda").manual_seed(6)
    rand64 = lane_interp.LaneTables(pack64=torch.rand(
        lanes.pack64.shape, device="cuda", generator=gen) * 100.0 - 50.0)
    if order == "sorted":
        # sorted parcels: runs of one cell, as on the unfused path
        assert int(torch.unique_consecutive(base).numel()) < base.numel() / 4
    elif order == "drifted":
        moved = torch.rand(base.numel(), device="cuda", generator=gen) < 0.3
        base = torch.where(moved, torch.roll(base, 300), base)
    elif order == "random":
        base = base[torch.randperm(base.numel(), device="cuda",
                                   generator=gen)]
    elif order == "single":
        base = base[:1]
    else:
        lengths = torch.tensor([1, 31, 33, 255, 257, 2, 512, 7, 1000, 3],
                               device="cuda")
        cells = torch.randint(0, lanes.pack64.shape[0], (lengths.numel(),),
                              device="cuda", generator=gen)
        base = torch.repeat_interleave(cells, lengths).to(torch.int32)
        assert base.numel() % 32 != 0
    for tables in (lanes, rand64):
        before = _cuda.launch_counts["lane_meso_sigma"]
        got, served = lane_interp.meso_sigma_sorted(tables, base)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["lane_meso_sigma"] == before + 1
        assert served == 1.0
        assert torch.equal(got, lane_interp.meso_sigma_plain(tables.pack64,
                                                             base))


def test_cuda_tensor_never_takes_the_plain_version(located):
    """A CUDA tensor that the kernel does not take raises; it does not
    fall back."""
    table, cell, w4 = located
    with pytest.raises(ValueError, match="int32"):
        slab_interp.interp_uvwt(table, cell.to(torch.int64), w4)
    with pytest.raises(ValueError, match="float32"):
        slab_interp.meso_sigma(table.double(), cell)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


def test_probe_kernels_match_plain(gpu):
    """P1-P3 on every element: the lane probe does the lane kernel's
    operations in its order (0.0), the two others move or double values
    (bit-exact).  n is no multiple of a block or a tile."""
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.perf import probe
    n, ncell = 300_007, 50_000
    packT, base, w = probe.make_data(n, ncell, device="cuda")
    before = dict(_cuda.launch_counts)
    got = probe.probe_lane(packT, base, w)
    assert torch.equal(got, probe.probe_lane_plain(packT, base, w))
    assert float(got[4].min()) == 1.0 and float(got[5:].abs().max()) == 0.0
    for G in probe.GRID_GROUPS:
        for nchunk in (1, 7):
            x = torch.rand((8, nchunk * G * 128), device="cuda")
            assert torch.equal(probe.probe_grid(x, G),
                               probe.probe_grid_plain(x, G))
    tab, idx = probe.make_small_data(n, device="cuda")
    idx[:3] = torch.tensor([0, 72, 127], dtype=torch.int32)
    assert torch.equal(probe.probe_small(tab, idx),
                       probe.probe_small_plain(tab, idx))
    counts = {k: _cuda.launch_counts[k] - before[k] for k in before}
    assert (counts["probe_lane"], counts["probe_grid"],
            counts["probe_small"]) == (1, 6, 1)
    with pytest.raises(ValueError, match="int32"):
        probe.probe_small(tab, idx.to(torch.int64))
    # a tile row that does not start on a 16-byte boundary
    odd = torch.rand(8 * 1024 + 1, device="cuda")[1:].view(8, 1024)
    with pytest.raises(RuntimeError, match="refused"):
        probe.probe_grid(odd, 8)


@pytest.mark.parametrize("mode,fast", [("float32", "2"), ("float32", "1"),
                                       ("float64", "0")])
def test_run_trac_card_against_cpu(gpu, tmp_path, mode, fast):
    """``run_trac`` from files on the card and on the CPU: three met files
    of the synthetic wind, 10 steps across the met swap, the tolerances of
    ten steps of the step tests (two math libraries' cos, log and exp: a
    few ulp of a float32 position a step; in float64 the single-precision
    Box-Muller)."""
    from mptrac_tpu_torch.sim import run_trac
    tols = {"float32": (6.2e-4, 6.2e-4), "float64": (1e-7, 5e-6)}[mode]
    t_start, t_stop = 3600.0 - 900.0, 3600.0 + 900.0
    flagship.write_case(str(tmp_path), 2048, (36, 19, 8), t_start, t_stop,
                        900, extra_ctl=("TPU_FAST", fast))
    sims = {dev: run_trac(str(tmp_path), "trac.ctl", "atm_in.bin",
                          ("ATM_BASENAME", "atm_" + dev), device=dev,
                          dtype=getattr(torch, mode))
            for dev in ("cuda", "cpu")}
    a, b = sims["cuda"].atm, sims["cpu"].atm
    assert a.lon.is_cuda and len(sims["cuda"].met.reads) == 3
    assert sims["cuda"].nsorts == sims["cpu"].nsorts == 3
    assert float((a.lon.cpu() - b.lon).abs().max()) <= tols[0]
    assert float((a.lat.cpu() - b.lat).abs().max()) <= tols[0]
    assert float((a.p.cpu() - b.p).abs().max()) <= tols[1]
    assert sims["cuda"].cache.rng_ctr == sims["cpu"].cache.rng_ctr


# ------------------------------------------------- K1 on other grids

#: K1 against rk_plain (see test_rk_kernel_matches_plain): lon, lat, p,
#: the three sigmas, T
TOL_RK = [3.1e-5, 3.1e-5, 1.3e-4, 1e-5, 1e-5, 1e-5, 3.1e-5]
#: beyond this |start latitude| the longitude is held to TOL_RK[0] as a
#: distance along the parallel (degrees times the cosine of the start
#: latitude, which the zonal step divides by in the Euler and RK4 schemes
#: and the midpoint's lies a half step from): a zonal step grows as
#: 1 / cos(lat), and a rounding of the wind or of the latitude is
#: magnified with it in longitude but not in distance.  The parent's
#: kernel shows the same differences (perf/rk_errors.py by latitude band)
POLAR_LAT = 80.0


def _rk_met(kind):
    """A stacked pair of the synthetic wind (tilted axis, a vertical
    wind, T rising with height) on a small grid, with its axes turned or
    made irregular: "p_desc" (the synthetic levels), "p_asc",
    "lat_desc" (descending and irregular), "lat_irregular", "cartesian"."""
    import dataclasses

    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.types import stack_met
    snaps = [make_wind_met(t, nx=36, ny=19, nz=8, alpha=30.0, w0=0.1,
                           temp0=200.0, temp1=290.0 + t / 3600.0,
                           device="cuda") for t in (0.0, 3600.0)]
    met = stack_met(*snaps)
    f3 = met.fields3d
    if kind == "p_asc":
        met = dataclasses.replace(
            met, p=met.p.flip(-1), fields3d={k: v.flip(-1)
                                             for k, v in f3.items()})
    elif kind in ("lat_desc", "lat_irregular"):
        lat = met.lat.clone()
        lat[:, 1:-1] += 0.37 * torch.sin(torch.arange(
            lat.shape[1] - 2, device="cuda", dtype=lat.dtype))
        if kind == "lat_desc":
            lat, f3 = lat.flip(-1), {k: v.flip(2) for k, v in f3.items()}
        met = dataclasses.replace(met, lat=lat, reg_lat=False, fields3d=f3)
    elif kind == "cartesian":
        met = dataclasses.replace(met, coord_type=1)
    return met


def _rk_parcels(pack, n, gen):
    """n random parcels in and around the grid with dt 180 s, then parcels
    with dt 0 (all stages locate at the start): on every node of each
    axis, past both ends of each axis, and NaN in lon, lat or p."""
    lon_ax = pack.lon0 + pack.dlon * torch.arange(
        pack.nx, device="cuda", dtype=torch.float32)
    lat_ax, p_ax = pack.lat_axis, pack.p_axis
    lo_p, hi_p = float(p_ax.min()), float(p_ax.max())

    def u(lo, hi, k):
        return lo + (hi - lo) * torch.rand(k, device="cuda", generator=gen)

    lon = [u(-20.0, 380.0, n)]
    lat = [u(pack.lat_lo, pack.lat_hi, n)]
    p = [u(lo_p, hi_p, n)]
    dt = [torch.full((n,), 180.0, device="cuda")]
    mid_lon = float(lon_ax[pack.nx // 2])
    mid_lat, mid_p = float(lat_ax[pack.ny // 2]), float(p_ax[pack.npl // 2])
    edge = ([(x, mid_lat, mid_p) for x in lon_ax.tolist()]
            + [(mid_lon, y, mid_p) for y in lat_ax.tolist()]
            + [(mid_lon, mid_lat, z) for z in p_ax.tolist()]
            + [(x, mid_lat, mid_p) for x in (-400.0, 725.0, pack.lon0 - 1.0,
                                             pack.lon_last + 1.0)]
            + [(mid_lon, y, mid_p) for y in (pack.lat_lo - 5.0,
                                             pack.lat_hi + 5.0)]
            + [(mid_lon, mid_lat, z) for z in (0.5 * lo_p, 1.5 * hi_p)]
            + [(float("nan"), mid_lat, mid_p), (mid_lon, float("nan"), mid_p),
               (mid_lon, mid_lat, float("nan"))])
    e = torch.tensor(edge, device="cuda", dtype=torch.float32)
    lon.append(e[:, 0])
    lat.append(e[:, 1])
    p.append(e[:, 2])
    dt.append(torch.zeros(len(edge), device="cuda"))
    k = n + len(edge)
    wt0 = torch.rand(k, device="cuda", generator=gen)
    return tuple(torch.cat(x).contiguous() for x in (lon, lat, p, dt)) + (
        wt0,)


def _assert_rk_matches_plain(pack, nstage, args):
    """Positions and T within TOL_RK (NaN where the plain version has
    NaN), the longitude of parcels that start past POLAR_LAT as a
    distance; sigma within its tolerance where both sides end in the same
    cell, and at most one parcel a thousand in another cell."""
    got = torch.stack(rk_fused.advect_all(pack, nstage, *args)[0])
    exp = torch.stack(rk_fused.rk_plain(pack, nstage, *args))
    same = (rk_fused.locate_plain(pack, got[0], got[1], got[2])[0]
            == rk_fused.locate_plain(pack, exp[0], exp[1], exp[2])[0])
    assert int((~same).sum()) <= got.shape[1] // 1000
    for r, tol in enumerate(TOL_RK):
        g, e = (got[r], exp[r]) if r not in (3, 4, 5) else (got[r][same],
                                                            exp[r][same])
        assert torch.equal(torch.isnan(g), torch.isnan(e)), r
        d = (g - e).abs()
        if r == 0 and not pack.cartesian:
            d = d * torch.where(args[1].abs() > POLAR_LAT, torch.cos(
                args[1] * (math.pi / 180.0)).abs(), torch.ones_like(d))
        ok = ~torch.isnan(e)
        assert float(d[ok].max()) <= tol, r


@pytest.mark.parametrize("kind", ["p_desc", "p_asc", "lat_desc",
                                  "lat_irregular", "cartesian"])
def test_rk_kernel_matches_plain_on_other_axes(gpu, kind):
    """K1's binary-search locate against the plain compare-count on
    ascending and descending pressure and latitude axes, an irregular
    latitude axis and a Cartesian grid, for parcels inside, on every node,
    past both ends and NaN, with all three schemes."""
    pack = rk_fused.build_cell_pack(_rk_met(kind))
    assert pack.p_asc == (kind == "p_asc")
    assert pack.lat_asc == (kind != "lat_desc")
    assert pack.lat_reg == (kind not in ("lat_desc", "lat_irregular"))
    assert pack.cartesian == (kind == "cartesian")
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _rk_parcels(pack, 20_000, gen)
    if kind == "cartesian":
        # metres added to the axis unit: keep the parcels on the grid
        args = args[:3] + (args[3] * (1.0 / 360.0),) + args[4:]
    for nstage in (1, 2, 4):
        _assert_rk_matches_plain(pack, nstage, args)


def test_rk_kernel_matches_plain_unsorted(card):
    """The flagship's parcels in a random order: each thread reads its
    own corners, so the order changes no value."""
    ctl, met01, atm, cache, pack = card
    wt0 = interp.time_weight(met01, atm.time).to(torch.float32)
    perm = torch.randperm(atm.npmax, device="cuda")
    args = tuple(x[perm].contiguous()
                 for x in (atm.lon, atm.lat, atm.p, cache.dt, wt0))
    _assert_rk_matches_plain(pack.cell, 2, args)
    got = rk_fused.advect_all(pack.cell, 2, *args)[0]
    ref = rk_fused.advect_all(pack.cell, 2, atm.lon, atm.lat, atm.p,
                              cache.dt, wt0)[0]
    for g, r in zip(got, ref):
        assert torch.equal(g, r[perm])


def test_rk_kernel_attributes(card):
    """Registers, local memory and resident blocks of every scheme's
    kernel are readable on the card."""
    for nstage in (1, 2, 4):
        a = rk_fused.kernel_attributes(card[4].cell, nstage)
        assert 0 < a["registers"] <= 255 and a["blocks_per_sm"] >= 1


# ------------------------------------------------- K3 on each path

#: the two paths forced, and the plan's own choice
K3_PLANS = ["rows", "gather", None]
#: outputs of a block of the permute kernel's launches
K3_BLOCK = 256


def _k3_perm(kind, n, gen):
    if kind == "identity":
        return torch.arange(n, device="cuda")
    if kind == "random":
        return torch.randperm(n, device="cuda", generator=gen)
    if kind == "banded":
        key = torch.div(torch.arange(n, device="cuda"), 4096,
                        rounding_mode="floor").double()
        return torch.sort(key + torch.rand(
            n, device="cuda", dtype=torch.float64, generator=gen)).indices
    if kind == "drifted":
        # a stable re-sort after 60 % of the parcels moved 181 cells of
        # 25 parcels on (see test_torch_slab._perm_of_kind)
        key = torch.div(torch.arange(n, device="cuda"), 25,
                        rounding_mode="floor") + 181 * (torch.rand(
                            n, device="cuda", generator=gen) < 0.6)
        return torch.sort(key, stable=True).indices
    # far movers at block edges: the first and last output of every block
    # take their sources from half the state away
    at = torch.arange(0, n, K3_BLOCK, device="cuda")
    at = torch.unique(torch.cat([at, torch.clamp(at + K3_BLOCK - 1,
                                                 max=n - 1)]))
    perm = torch.arange(n, device="cuda")
    perm[at] = at.roll(len(at) // 2)
    return perm


def _k3_columns(n, ncols, with64, gen):
    """float32 columns that start off 16-byte alignment (views at an
    offset of one element) and a float64 column."""
    base = torch.rand((ncols, n + 1), device="cuda", generator=gen)
    cols = [base[c, 1:] for c in range(ncols)]
    col64 = (torch.rand(n, device="cuda", dtype=torch.float64,
                        generator=gen) * 1e5 if with64 else None)
    return cols, col64


def _assert_k3_exact(cols, perm, col64, plan):
    got32, got64 = slab_interp.permute_cols(cols, perm, col64, plan=plan)
    exp32, exp64 = slab_interp.permute_cols_plain(cols, perm, col64)
    assert torch.equal(got32, exp32)
    assert (got64 is None and exp64 is None) or torch.equal(got64, exp64)


@pytest.mark.parametrize("kind", ["identity", "random", "banded",
                                  "drifted", "edge_movers"])
@pytest.mark.parametrize("plan", K3_PLANS)
def test_permute_kernel_bit_exact_on_each_path(gpu, kind, plan):
    """Both paths of K3, forced and as planned, equal the plain gather bit
    for bit on every permutation, with n no multiple of a block."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 137 * K3_BLOCK + 77
    cols, col64 = _k3_columns(n, 9, True, gen)
    _assert_k3_exact(cols, _k3_perm(kind, n, gen), col64, plan)


@pytest.mark.parametrize("ncols", [0, 1, 9, 32])
@pytest.mark.parametrize("with64", [False, True])
def test_permute_kernel_bit_exact_column_counts(gpu, ncols, with64):
    """0, 1, 9 and 32 float32 columns, with and without the float64
    column, on each path, at n = 1 and at n no multiple of a block."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for n in (1, 3 * K3_BLOCK + 5):
        cols, col64 = _k3_columns(n, ncols, with64, gen)
        for kind in ("random", "banded"):
            perm = _k3_perm(kind, n, gen)
            for plan in K3_PLANS:
                _assert_k3_exact(cols, perm, col64, plan)


@pytest.mark.parametrize("ncols", [0, 9])
def test_permute_kernel_selection_on_gather_path(gpu, ncols):
    """The gather path takes indices that select (fewer than the columns,
    in runs or at random, none at all) and equals the plain gather bit
    for bit; the row path refuses a selection."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    m = 5 * K3_BLOCK + 3
    cols, col64 = _k3_columns(m, ncols, True, gen)
    runs = torch.nonzero(torch.rand(m, device="cuda", generator=gen)
                         < 0.3).flatten()
    rand = torch.randint(0, m, (777,), device="cuda", generator=gen)
    for idx in (runs, rand, runs[:0]):
        _assert_k3_exact(cols, idx, col64, "gather")
    with pytest.raises(ValueError, match="selection"):
        slab_interp.permute_cols(cols, runs, col64, plan="rows")


def test_permute_count_matches_plain(gpu):
    """The count pass on the card equals its plain version; a random or
    banded permutation plans the row path, the identity and a drifted
    re-sort the gather path; each launch is counted for its kernel."""
    from mptrac_tpu_torch.ops import _cuda
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = 1_000_003
    want = {"random": "rows", "banded": "rows", "identity": "gather",
            "drifted": "gather", "edge_movers": "gather"}
    keys = ("permute_count", "permute_gather", "permute_pack",
            "permute_rows")
    for kind, path in want.items():
        perm = _k3_perm(kind, n, gen)
        before = [_cuda.launch_counts[k] for k in keys]
        assert (slab_interp.permute_sectors(perm)
                == slab_interp.permute_sectors_plain(perm.cpu()))
        assert slab_interp.permute_plan(perm) == path, kind
        slab_interp.permute_cols([perm.float()], perm)
        counts = [_cuda.launch_counts[k] - b for k, b in zip(keys, before)]
        assert counts == ([3, 0, 1, 1] if path == "rows"
                          else [3, 1, 0, 0]), kind


# ----------------------------------------- the writers and the zeta search

def _writer_state(device, dtype, n=20_000):
    """A state for the writers: the flagship's positions, times in and
    out of the window, t, m, stat and ens (the parcel's index mod 32)."""
    from mptrac_tpu_torch.types import Atm
    rng = np.random.default_rng(4)
    t0 = 1800.0
    q = {"t": rng.uniform(200.0, 300.0, n), "m": rng.uniform(0.5, 2.0, n),
         "stat": (rng.random(n) < 0.1) * 1.0, "ens": np.arange(n) % 32.0}

    def put(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return Atm(time=put(t0 + rng.choice([0.0, 0.0, 45.0, -300.0], n),
                        torch.float64),
               p=put(np.exp(rng.uniform(np.log(150.0), np.log(950.0), n))),
               lon=put(rng.uniform(-180.0, 180.0, n)),
               lat=put(rng.uniform(-60.0, 60.0, n)),
               q={k: put(v) for k, v in q.items()}, np=n - 37)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_writers_card_against_cpu_on_one_state(gpu, tmp_path, dtype):
    """Every writer through ``OutputManager`` on the card and on the CPU
    from the same state (float64, and float32 as the kernels' paths
    leave it), two outputs: the same files, the same counts, sums at
    1e-12 (float64) or 1e-6 (float32) relative (``index_add_`` on the
    card adds in no fixed order), the same station flags."""
    import os
    import types

    from test_full_parity import load_tab
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io.output import OutputManager
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.types import astype_state, stack_met
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(6)
    obs = tmp_path / "obs.tab"
    rows = np.stack([np.sort(rng.uniform(1700.0, 2100.0, 500)),
                     rng.uniform(1.0, 12.0, 500),
                     rng.uniform(-180.0, 180.0, 500),
                     rng.uniform(-60.0, 60.0, 500),
                     10.0 ** rng.uniform(-9.0, -3.0, 500)], -1)
    np.savetxt(obs, rows, fmt="%.10g")
    args = ["NQ", "4", "QNT_NAME[0]", "t", "QNT_NAME[1]", "m",
            "QNT_NAME[2]", "stat", "QNT_NAME[3]", "ens", "DT_MOD", "180",
            "METBASE", "-", "MOLMASS", "64.066", "ATM_BASENAME", "-",
            "GRID_BASENAME", "grid", "GRID_DT_OUT", "180", "GRID_NZ", "10",
            "GRID_Z0", "0", "GRID_Z1", "20", "GRID_TYPE", "1",
            "ENS_BASENAME", "ens", "ENS_DT_OUT", "180",
            "CSI_BASENAME", "csi", "CSI_OBSFILE", str(obs),
            "CSI_DT_OUT", "360", "PROF_BASENAME", "prof",
            "PROF_OBSFILE", str(obs), "SAMPLE_BASENAME", "sample",
            "SAMPLE_OBSFILE", str(obs), "SAMPLE_DZ", "1", "SAMPLE_DX", "300",
            "STAT_BASENAME", "station", "STAT_LON", "10", "STAT_LAT", "20",
            "STAT_R", "1500", "VTK_BASENAME", "vtk", "VTK_DT_OUT", "180",
            "VTK_STRIDE", "7"]
    ctl = read_ctl(None, args)
    dirs, states = {}, {}
    for dev, sub in (("cuda", "card"), ("cpu", "host")):
        met = stack_met(*(make_wind_met(t0=t, nx=36, ny=19, nz=8,
                                        alpha=30.0, temp0=290.0,
                                        temp1=210.0, q=1e-3, o3=3e-7,
                                        device=dev) for t in (0.0, 3600.0)))
        atm = _writer_state(dev, dt)
        if dtype == "float32":
            met = astype_state(met=met)
        d = tmp_path / sub
        d.mkdir()
        om = OutputManager(str(d), ctl)
        for t in (1800.0, 1980.0, 2160.0):
            om.write(types.SimpleNamespace(pair=met), atm, t)
            atm = atm.replace(time=atm.time + 180.0)
        om.close()
        dirs[sub], states[sub] = d, atm
    names = sorted(os.listdir(dirs["host"]))
    assert names == sorted(os.listdir(dirs["card"])) and len(names) >= 13
    rtol = 1e-12 if dtype == "float64" else 1e-6
    for name in names:
        a, b = dirs["card"] / name, dirs["host"] / name
        if name.endswith(".nc"):
            from scipy.io import netcdf_file
            na, nb = netcdf_file(str(a), mmap=False), netcdf_file(
                str(b), mmap=False)
            for var, v in nb.variables.items():
                x, y = na.variables[var][:], v[:]
                if var == "np":
                    np.testing.assert_array_equal(x, y)
                else:
                    np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-30,
                                               equal_nan=True, err_msg=var)
            na.close()
            nb.close()
        elif name.endswith(".vtk"):
            assert a.read_text() == b.read_text(), name
        else:
            x, y = load_tab(a), load_tab(b)
            assert x.shape == y.shape, name
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-30,
                                       equal_nan=True, err_msg=name)
    assert torch.equal(states["card"].q["stat"].cpu(),
                       states["host"].q["stat"])


def test_interp_4d_zeta_card_against_cpu(gpu):
    """The column search and the interpolation on the card give the CPU's
    numbers (float64 gathers and arithmetic, op by op) on an ascending and
    a descending column field of the CLaMS-convention met."""
    import pathlib

    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.types import stack_met
    gold = (pathlib.Path(__file__).resolve().parents[1] / "parity"
            / "golden_zeta" / "data")
    ctl = read_ctl(str(gold / "trac.ctl"))
    clim = read_clim(ctl, device="cpu")
    met = {dev: stack_met(*(read_met(str(gold / f), ctl, clim, device=dev)
                            for f in ("clams_16070100.nc",
                                      "clams_16070106.nc")))
           for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(2)
    n = 100_000
    t = torch.from_numpy(520646400.0 + rng.uniform(0, 21600.0, n))
    lon = torch.from_numpy(rng.uniform(-180.0, 180.0, n))
    lat = torch.from_numpy(rng.uniform(-89.0, 89.0, n))
    for heights, array, lo, hi in (("zetal", "pl", 250.0, 2500.0),
                                   ("pl", "ul", 0.5, 1100.0)):
        h = torch.from_numpy(rng.uniform(lo, hi, n))
        h[:10] = float("nan")
        got = interp.interp_4d_zeta(met["cuda"], heights, array, t.cuda(),
                                    h.cuda(), lon.cuda(), lat.cuda()).cpu()
        want = interp.interp_4d_zeta(met["cpu"], heights, array, t, h, lon,
                                     lat)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=0, equal_nan=True)


# ------------------------------------------------------ the parallel layer

def _dd_case(device, dtype=torch.float64, n=600):
    """tests/test_dd.py's kind of case: the tilted wind at 90x46x8, DD
    4 x 2, halo 4, ``n`` parcels from a numpy seed, on ``device``."""
    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.types import Atm, astype_state, stack_met
    ctl = read_ctl(None, [
        "NQ", "1", "QNT_NAME[0]", "idx", "METBASE", "-", "DIFFUSION", "0",
        "ADVECT", "4", "DD", "1", "DD_SUBDOMAINS_ZONAL", "4",
        "DD_SUBDOMAINS_MERIDIONAL", "2", "DD_HALOS_SIZE", "4",
        "MET_DT_OUT", "0", "T_STOP", "86400", "DT_MOD", "1200"])
    clim = read_clim(ctl, device=device)
    met01 = stack_met(*(make_wind_met(t0=t0, nx=90, ny=46, nz=8, alpha=40.0,
                                      device=device)
                        for t0 in (0.0, 86400.0)))
    rng = np.random.default_rng(5)

    def col(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n)).to(device)

    atm = Atm(time=torch.zeros(n, dtype=torch.float64, device=device),
              lon=col(0, 360), lat=col(-60, 60), p=col(300, 900),
              q={"idx": torch.arange(n, dtype=torch.float64,
                                     device=device)}, np=n)
    if dtype == torch.float32:
        atm, met01, clim = astype_state(atm=atm, met=met01, clim=clim)
    return ctl, clim, met01, atm


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dd_step_card_against_cpu(gpu, dtype, monkeypatch):
    """The local group's step, 6 steps, on the card and on the CPU: the
    counts exactly, every column within a few ulps; K3 carried each
    selection on the card (three a subdomain a step, on the gather path
    without a count pass; in float64 the time, p, lon, lat and idx
    columns take one launch each, the first beside uvwp), one launch a
    call that selects anything."""
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.parallel import dd as ddm
    dt = getattr(torch, dtype)
    sizes, real = [], ddm.permute_cols

    def counted(cols32, idx, col64=None, *, plan=None):
        if idx.is_cuda:
            sizes.append(idx.shape[0])
        return real(cols32, idx, col64, plan=plan)

    monkeypatch.setattr(ddm, "permute_cols", counted)
    out = {}
    for dev in ("cuda", "cpu"):
        ctl, clim, met01, atm = _dd_case(dev, dt)
        dd = ddm.plan_decomposition(ctl, met01, ndev=8)
        tiles = ddm.make_tiles(dd, met01)
        a, c = ddm.scatter_parcels(dd, atm, 256, met01.lat[0])
        step = ddm.make_dd_step(ctl, clim, dd, ddm.local_group(8, dev), 256,
                                64, met01.lat[0])
        _cuda.reset_launch_counts()
        counts = []
        for i in range(1, 7):
            a, c, ov, lo = step(tiles, a, c, i * 1200.0)
            counts.append((a.np.tolist(), ov.tolist(), lo.tolist()))
        out[dev] = (a, c, counts, dict(_cuda.launch_counts))
    (ag, cg, ng, launches), (ac, cc, nc, _) = out["cuda"], out["cpu"]
    assert ng == nc
    per = 5 if dtype == "float64" else 1
    assert len(sizes) == 6 * 3 * 8 * per
    assert launches["permute_gather"] == sum(1 for n in sizes if n)
    assert launches["permute_gather"] >= 6 * 8 * per      # the stayers
    assert (launches["permute_count"] == launches["permute_rows"]
            == launches["permute_pack"] == 0)
    assert ag.lon.dtype == dt and ag.time.dtype == torch.float64
    tol = 1e-9 if dtype == "float64" else 1e-3
    for name in ("lon", "lat", "p"):
        np.testing.assert_allclose(getattr(ag, name).cpu().numpy(),
                                   getattr(ac, name).numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    assert torch.equal(ag.q["idx"].cpu(), ac.q["idx"])
    assert torch.equal(ag.time.cpu(), ac.time)


def test_sharded_step_on_the_card_equals_unsharded(gpu):
    """The sharded step over two shards of the card (a mesh that names
    cuda:0 twice) equals the unsharded step on the card bit for bit, the
    diffusion on."""
    from mptrac_tpu_torch.parallel import mesh as pmesh
    from mptrac_tpu_torch.physics import pipeline
    ctl, clim, met01, atm, cache = flagship.make_setup(
        4096, nx=36, ny=19, nz=8, extra_args=("TPU_FAST", "0"),
        device="cuda")
    m = pmesh.make_mesh(2, devices=["cuda:0", "cuda:0"])
    step = pmesh.make_sharded_step(ctl, clim, m)
    met_rep = pmesh.replicate_met(met01, m)
    sa, sc = pmesh.shard_atm(atm, m), pmesh.shard_cache(cache, m)
    a, c = atm, cache
    for i in range(1, 4):
        a, c = pipeline.run_timestep(ctl, clim, met01, a, c, i * 180.0)
        sa, sc = step(met_rep, sa, sc, i * 180.0)
    ua = pmesh.unshard(sa, "cuda")
    for name in ("lon", "lat", "p"):
        assert torch.equal(getattr(ua, name), getattr(a, name)), name
    assert sc.rng_ctr == c.rng_ctr
