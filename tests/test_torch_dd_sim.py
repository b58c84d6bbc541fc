"""The domain-decomposed run on the normal path: ``Simulation`` and
``run_trac`` with ``DD 1`` (``parallel.dd`` in the local group), held
parcel by parcel (matched by the quantity ``idx``) to the same run
without DD and to the benchmark's plain reference of the decomposed
configuration (``benchmark/references/dd.py``), on the CPU.

The case: the solid-body wind tilted 45 degrees at 72x37x16, 4 x 2
subdomains with halos of 4, 20,000 parcels in latitude -80 to 80, steps
of 1800 s (the wind carries a parcel ~0.6 degrees a step, so parcels
leave their subdomains every step: east and west, north and south,
across the date line and across 0 degrees), a sort every 3600 s."""

import numpy as np
import pytest
import torch

from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.io import atm_io
from mptrac_tpu_torch.met.synthetic import make_wind_met
from mptrac_tpu_torch.parallel import dd as ddm
from mptrac_tpu_torch.parallel.mesh import make_mesh
from mptrac_tpu_torch.sim import FixedMet, Simulation, run_trac
from mptrac_tpu_torch.types import Atm, Cache, astype_state, stack_met
from mptrac_tpu_torch.utils import log

N = 20_000
GRID = (72, 37, 16)
STEPS = [1800.0 * k for k in range(8)]
ARGS = ["NQ", "2", "QNT_NAME[0]", "t", "QNT_NAME[1]", "idx", "METBASE", "-",
        "DT_MOD", "1800", "ADVECT", "2", "DIFFUSION", "0", "SORT_DT", "3600",
        "T_STOP", "86400", "DD_SUBDOMAINS_ZONAL", "4",
        "DD_SUBDOMAINS_MERIDIONAL", "2", "DD_HALOS_SIZE", "4"]
#: the largest gaps [deg] of a position from the undecomposed run's: in
#: float64 the tile's halo longitude (lon, where the global grid takes
#: lon + 360) rounds the weights differently at 1e-14; in float32 at
#: 1e-7 a step (one ulp of 360 is 3e-5 deg), 4e-6 over the 8 steps
TOL_PLAIN = {"float64": 1e-10, "float32": 1e-4}
#: the largest gaps [deg] of one step from the float64 reference's step
#: of the same state: in float32 the rounding of a step's displacement
#: and interpolation weights (the benchmark's cell reads at most 2.3e-5
#: deg, 0.0025 km)
TOL_REF = {"float64": 1e-10, "float32": 2e-4}


def _reference():
    from benchmark import manifest
    return manifest.reference({"reference": "dd"})


def _setup(dtype, dd):
    log.set_level(0)
    ctl = read_ctl(None, ARGS + ["DD", str(dd)])
    clim = read_clim(ctl, device="cpu")
    met01 = stack_met(*(make_wind_met(t0, *GRID, alpha=45.0, device="cpu")
                        for t0 in (0.0, 86400.0)))
    met01 = astype_state(met=met01, dtype=dtype)
    rng = np.random.default_rng(3)

    def col(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, N)).to(dtype)

    atm = Atm(time=torch.zeros(N, dtype=torch.float64), p=col(200, 900),
              lon=col(-180, 180), lat=col(-80, 80),
              q={"t": torch.zeros(N, dtype=dtype),
                 "idx": torch.arange(N, dtype=torch.float64)}, np=N)
    cache = Cache.zeros(N, dtype, iso_npmax=1, device="cpu")
    return Simulation(ctl, atm, clim, met=FixedMet(met01), cache=cache,
                      dtype=dtype), met01


def _by_idx(atm: Atm):
    """{column: float64 numpy in idx order} of a dense Atm."""
    order = torch.argsort(atm.q["idx"][:atm.np])
    out = {k: getattr(atm, k)[:atm.np][order].double().numpy()
           for k in ("time", "lon", "lat", "p")}
    out.update({k: v[:atm.np][order].double().numpy()
                for k, v in atm.q.items()})
    return out


def _dlon(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def _ref_met(met01):
    from benchmark import reference
    f2 = [{"ps": met01.fields2d["ps"][k].numpy()} for k in (0, 1)]
    f3 = [{n: met01.fields3d[n][k].numpy() for n in ("u", "v", "w", "t")}
          for k in (0, 1)]
    return reference.met_pair(met01.time, met01.lon[0].numpy(),
                              met01.lat[0].numpy(), met01.p[0].numpy(),
                              f2[0], f3[0], f2[1], f3[1], names2=("ps",),
                              names3=("u", "v", "w", "t"))


def _state(d: dict) -> dict:
    """A dense state in the reference's columns (the index as ``m``)."""
    z = torch.zeros(len(d["idx"]), dtype=torch.float64)
    return {"time": torch.from_numpy(d["time"]),
            "lon": torch.from_numpy(d["lon"]),
            "lat": torch.from_numpy(d["lat"]),
            "p": torch.from_numpy(d["p"]), "t": torch.from_numpy(d["t"]),
            "m": torch.from_numpy(d["idx"]), "u": z, "v": z, "w": z}


def _block_owners(sim: Simulation):
    """(idx, the block each live parcel sits in, the reference's owners
    of its position [5, m])."""
    atm, cap = sim.atm, sim.dd.cap
    slots = np.concatenate([np.arange(i * cap, i * cap + int(k))
                            for i, k in enumerate(atm.np)])
    lon = atm.lon[slots].double().numpy()
    lat = atm.lat[slots].double().numpy()
    met = sim.met.pair
    near = _reference().owners_near(
        lon, lat, met.lon[0].double().numpy(), met.lat[0].double().numpy(),
        4, 2)
    return atm.q["idx"][slots].numpy().astype(np.int64), slots // cap, near


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs(request):
    """The decomposed run and the plain one, step by step: after each
    step the plain state, the decomposed state gathered, the reference's
    step of the decomposed state before it, the blocks and owners, the
    counts."""
    dtype = getattr(torch, request.param)
    ref = _reference()
    plain, met01 = _setup(dtype, 0)
    dd, _ = _setup(dtype, 1)
    rmet = _ref_met(met01)
    rctl = ref.params(ARGS)
    out = []
    before = _by_idx(dd.parcels())
    for t in STEPS:
        plain.advance(t, write_output=False)
        dd.advance(t, write_output=False)
        exp = ref.step(rctl, rmet, None, _state(before), t, 0, N,
                       torch.arange(N))
        got = _by_idx(dd.parcels())
        out.append(dict(t=t, plain=_by_idx(plain.atm), dd=got,
                        ref={k: v.numpy() for k, v in exp.items()},
                        owners=_block_owners(dd), np=dd.atm.np.copy(),
                        counts=dict(dd.dd_counts), nsorts=dd.nsorts))
        before = got
    return request.param, out


def test_dd_equals_the_undecomposed_run(runs):
    dtype, steps = runs
    tol = TOL_PLAIN[dtype]
    for s in steps:
        a, b = s["dd"], s["plain"]
        np.testing.assert_array_equal(a["idx"], b["idx"])
        np.testing.assert_array_equal(a["time"], b["time"])
        assert float(_dlon(a["lon"], b["lon"]).max()) <= tol
        assert float(np.abs(a["lat"] - b["lat"]).max()) <= tol
        np.testing.assert_allclose(a["p"], b["p"], rtol=tol, atol=0)
        np.testing.assert_array_equal(a["t"], b["t"])   # isothermal 280 K
    assert steps[-1]["nsorts"] == 4


def test_dd_equals_the_reference_step_by_step(runs):
    dtype, steps = runs
    tol = TOL_REF[dtype]
    for s in steps:
        a, e = s["dd"], s["ref"]
        np.testing.assert_array_equal(a["idx"], e["m"])
        np.testing.assert_array_equal(a["time"], e["time"])
        assert float(_dlon(a["lon"], e["lon"]).max()) <= tol
        assert float(np.abs(a["lat"] - e["lat"]).max()) <= tol
        np.testing.assert_allclose(a["p"], e["p"], rtol=tol, atol=0)
        np.testing.assert_allclose(a["t"], e["t"], rtol=0, atol=0)


def test_every_parcel_in_its_owners_block_and_counted(runs):
    _, steps = runs
    for s in steps:
        idx, block, near = s["owners"]
        assert np.all(np.any(near == block[None], axis=0))
        assert int(s["np"].sum()) + s["counts"]["lost"] == N
        assert s["counts"] == {"overflow": 0, "lost": 0}
        np.testing.assert_array_equal(np.sort(idx), np.arange(N))


def test_parcels_move_every_way(runs):
    """Between steps parcels change subdomain east and west, north and
    south, across the date line (zonal subdomains 1 and 2 meet at 180
    degrees) and across 0 degrees (3 and 0)."""
    _, steps = runs
    moves = set()
    for s0, s1 in zip(steps, steps[1:]):
        b0 = np.empty(N, np.int64)
        b1 = np.empty(N, np.int64)
        b0[s0["owners"][0]] = s0["owners"][1]
        b1[s1["owners"][0]] = s1["owners"][1]
        k = b0 != b1
        moves |= set(zip(b0[k].tolist(), b1[k].tolist()))
    zonal = {(a // 2, b // 2) for a, b in moves if a // 2 != b // 2}
    merid = {(a % 2, b % 2) for a, b in moves if a % 2 != b % 2}
    assert {(1, 2), (2, 1), (3, 0), (0, 3)} <= zonal
    assert merid == {(0, 1), (1, 0)}


def test_owner_agrees_with_the_program():
    """The reference's ``owner`` (written from dd_assign_subdomains) and
    the program's ``DDGrid.owner_of`` name the same subdomain for random
    positions off the edges, on both sides of the date line."""
    ctl = read_ctl(None, ARGS + ["DD", "1"])
    met = make_wind_met(0.0, *GRID, device="cpu")
    grid = ddm.plan_decomposition(ctl, met)
    rng = np.random.default_rng(7)
    lon = rng.uniform(-540, 540, 50_000)
    lat = rng.uniform(-90, 90, 50_000)
    got = grid.owner_of(torch.from_numpy(lon), torch.from_numpy(lat),
                        met.lat).numpy()
    near = _reference().owners_near(lon, lat, met.lon.numpy(),
                                    met.lat.numpy(), 4, 2)
    assert np.all(np.any(near == got[None], axis=0))
    assert np.mean(near[0] == got) > 0.999


def test_index_stays_exact_in_float32():
    """A float32 run keeps the parcel index float64: above 2^24 a float32
    index would merge neighbours."""
    big = torch.tensor([2.0 ** 24 + 1, 2.0 ** 24 + 3, 100_663_295.0],
                       dtype=torch.float64)
    atm = Atm(time=torch.zeros(3, dtype=torch.float64),
              p=torch.ones(3, dtype=torch.float64),
              lon=torch.zeros(3, dtype=torch.float64),
              lat=torch.zeros(3, dtype=torch.float64),
              q={"idx": big.clone(), "t": torch.zeros(3, dtype=torch.float64)},
              np=3)
    f32 = astype_state(atm=atm, dtype=torch.float32)
    assert f32.q["t"].dtype == f32.lon.dtype == torch.float32
    assert f32.q["idx"].dtype == torch.float64
    assert torch.equal(f32.q["idx"], big)


def test_run_trac_from_files(tmp_path, monkeypatch):
    """``run_trac`` from three met files with ``DD 1``: the tiles are made
    for the first pair and again after the swap, and the particle file
    holds the parcels of the run without DD."""
    made = []
    real = ddm.make_tiles

    def counted(grid, met):
        made.append(tuple(met.time))
        return real(grid, met)

    monkeypatch.setattr(ddm, "make_tiles", counted)
    log.set_level(0)
    outs = {}
    for dd in ("0", "1"):
        d = tmp_path / f"dd{dd}"
        d.mkdir()
        flagship.write_case(str(d), 3000, (36, 19, 8), 0.0, 7200.0, 3600.0,
                            quantities=("t", "m", "idx"),
                            extra_ctl=("DIFFUSION", "0", "DT_MOD", "900"))
        args = ("DD", dd, "DD_SUBDOMAINS_ZONAL", "4",
                "DD_SUBDOMAINS_MERIDIONAL", "2", "DD_HALOS_SIZE", "4")
        sim = run_trac(str(d), "trac.ctl", "atm_in.bin", args, device="cpu")
        assert (sim.dd is not None) == (dd == "1")
        out = d / "atm_2000_01_01_02_00_00.bin"       # at T_STOP
        ctl = read_ctl(str(d / "trac.ctl"), args)
        outs[dd] = _by_idx(atm_io.read_atm(str(out), ctl, device="cpu"))
    assert made == [(0.0, 3600.0), (3600.0, 7200.0)]
    a, b = outs["1"], outs["0"]
    np.testing.assert_array_equal(a["idx"], np.arange(3000))
    np.testing.assert_array_equal(a["idx"], b["idx"])
    for k in ("time", "lat", "p", "t", "m"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-10,
                                   err_msg=k)
    assert float(_dlon(a["lon"], b["lon"]).max()) <= 1e-10


@pytest.mark.parametrize("extra, why", [
    (("TPU_FAST", "2"), "TPU_FAST"), (("OH_CHEM_REACTION", "3"), "chemistry")])
def test_what_dd_cannot_run_raises(extra, why):
    ctl = read_ctl(None, ARGS + ["DD", "1"] + list(extra))
    atm = Atm.zeros(8, ("t", "idx"), device="cpu").replace(np=8)
    with pytest.raises(NotImplementedError, match=why):
        Simulation(ctl, atm, read_clim(ctl, device="cpu"),
                   met=FixedMet(None))


def test_dd_with_a_mesh_raises():
    ctl = read_ctl(None, ARGS + ["DD", "1"])
    atm = Atm.zeros(8, ("t", "idx"), device="cpu").replace(np=8)
    with pytest.raises(NotImplementedError, match="mesh"):
        Simulation(ctl, atm, read_clim(ctl, device="cpu"),
                   met=FixedMet(None),
                   mesh=make_mesh(2, devices=[torch.device("cpu")] * 2))


@pytest.mark.parametrize("share", [0.0, 0.001, 0.3, 1.0])
def test_compaction_equals_nonzero(share):
    """The migration's selections without a wait for the device: the
    stable partition gives ``torch.nonzero``'s indices, in its order."""
    g = torch.Generator().manual_seed(11)
    for m in (0, 1, 7, 100_003):
        mask = torch.rand(m, generator=g) < share
        got = ddm._compact(mask, int(mask.sum()))
        assert torch.equal(got, torch.nonzero(mask).flatten())
