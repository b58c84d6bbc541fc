"""The CUDA kernels of mptrac_tpu_torch against their plain PyTorch
versions, on the card.  These tests need an NVIDIA GPU and nvcc and
skip elsewhere; run them with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(``python3 chip_smoke.py`` makes the same comparisons at full size.)"""

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
    cancels from ~1e3 down to ~1: the same sums in the same order."""
    table, cell, _ = located
    for tab in (table, card[4].cell.table):
        got = slab_interp.meso_sigma(tab, cell)
        exp = slab_interp.meso_sigma_plain(tab, cell)
        assert float((got - exp).abs().max()) <= 7.7e-6


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
        x = torch.rand((8, 7 * G * 128), device="cuda")
        assert torch.equal(probe.probe_grid(x, G),
                           probe.probe_grid_plain(x, G))
    tab, idx = probe.make_small_data(n, device="cuda")
    idx[:3] = torch.tensor([0, 72, 127], dtype=torch.int32)
    assert torch.equal(probe.probe_small(tab, idx),
                       probe.probe_small_plain(tab, idx))
    counts = {k: _cuda.launch_counts[k] - before[k] for k in before}
    assert (counts["probe_lane"], counts["probe_grid"],
            counts["probe_small"]) == (1, 3, 1)
    with pytest.raises(ValueError, match="int32"):
        probe.probe_small(tab, idx.to(torch.int64))


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
