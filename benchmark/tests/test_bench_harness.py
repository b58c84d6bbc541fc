"""The harness on the CPU: the manifest and the files it names, the
rooflines' byte counts, the reference against steps worked by hand, and
a whole run at a tiny size."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import checks, inputs, manifest, reference as ref
from benchmark.tests.conftest import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names
    cells = {w["name"] for w in bench["workloads"]}
    e2e_cells = {m["name"]: set(m.get("workloads", cells))
                 for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        # every cell that reads it reports the metric it moves
        assert set(m.get("workloads", cells)) <= e2e_cells[m["moves"]]
    for cell in cells:
        assert "setup_s" in [m["name"] for m in manifest.cell_metrics(
            bench, cell, False)]
        assert len(manifest.cell_metrics(bench, cell, False)) >= 2
        assert manifest.cell_metrics(bench, cell, True)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
        assert w["config"] in {c["name"] for c in bench["configs"]}


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        cfg = manifest.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        wl = manifest.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        # the position, the wind memory, the time and the sort in every
        # cell; each number with a limit is one the checks compute
        assert {"pos_km", "uvw_abs", "time_abs", "sort_bad"} <= set(
            wl["limits"])
        assert set(wl["limits"]) <= (set(checks.STEP_NUMBERS)
                                     | {"sort_bad", "met_rel", "met_time"})
    for m in bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)
    for k in ("k1", "k3"):
        mod = manifest.roofline(k)
        assert mod.KERNELS and callable(mod.bound_s)


def test_cell_metrics_by_workloads(bench):
    e2e = [m["name"] for m in manifest.cell_metrics(bench, "base.mem",
                                                    False)]
    assert e2e == ["parcel_steps_per_s", "peak_mem_GB", "setup_s"]
    chem = {m["name"] for m in manifest.cell_metrics(bench, "chem.mem",
                                                     True)}
    assert "chem_ms" in chem and "met_read_s" not in chem
    nc = [m["name"] for m in manifest.cell_metrics(bench, "base.hourly_nc",
                                                   False)]
    assert nc == ["parcel_steps_per_s.nc", "peak_mem_GB", "setup_s"]


def test_roofline_counts_by_hand():
    k1 = manifest.roofline("k1")
    n, nx, ny, npl = 100_663_296, 361, 181, 61
    nbytes, ops = k1.launch_bytes_ops(n, nx, ny, npl, 2)
    # 48 B a parcel, the 8-float table and the two axes
    assert nbytes == n * 48 + 61 * 361 * 181 * 32 + (181 + 61) * 4
    # a locate is 19 + 6 (levels) + 4 (regular latitudes) operations
    assert ops == n * (2 * (29 + 126 + 35) + 29 + 42 + 3 + 159 + 25)
    ctx = type("C", (), {"n": n, "grid": (nx, ny, npl),
                         "advect_stages": 2})
    assert k1.bound_s(ctx, {"rk_kernel": 1}) == pytest.approx(1.480e-3,
                                                              rel=2e-3)
    k3 = manifest.roofline("k3")
    assert k3.permutation_bytes(n, 9, 1) == n * 96
    assert k3.sampled(2048 * 3 + 100) == 256 * 3 + 100
    ctx3 = type("C", (), {"n": n, "cols32": 9, "cols64": 1})
    b = k3.bound_s(ctx3, {"count_kernel": 1, "gather_kernel": 1,
                          "pack_kernel": 0, "rows_kernel": 0})
    assert b == pytest.approx((n * 96 + k3.sampled(n) * 8) / 3.35e12)


def _squares_python(ctr: int) -> int:
    """Squares (Widynski 2022) in Python integers, mod 2^64."""
    m = (1 << 64) - 1
    key = ref.SQUARES_KEY
    x = (ctr * key) & m
    y = x
    z = (y + key) & m

    def rot(v):
        return ((v >> 32) | (v << 32)) & m

    x = rot((x * x + y) & m)
    x = rot((x * x + z) & m)
    x = rot((x * x + y) & m)
    t = (x * x + z) & m
    x = rot(t)
    return t ^ (((x * x + y) & m) >> 32)


def test_squares_by_hand():
    ctrs = [0, 1, 12345, (1 << 63) + 7, (1 << 64) - 1]
    hi, lo = ref.squares(torch.tensor([ref._signed(c) for c in ctrs]))
    for c, h, l in zip(ctrs, hi.tolist(), lo.tolist()):
        r = _squares_python(c)
        assert (h, l) == (r >> 32, r & 0xFFFFFFFF)
    slots = torch.tensor([0, 5])
    u = ref.uniforms(100, slots, torch.float64)
    assert float(u[1]) == (_squares_python(105) >> 40) * 2.0 ** -24
    z = ref.normals3(100, 10, slots, torch.float64)
    r = _squares_python(100 + 10 + 5)
    ur, up = (r >> 40) * 2.0 ** -24, ((r & 0xFFFFFFFF) >> 8) * 2.0 ** -24
    assert float(z[1][1]) == pytest.approx(
        math.sqrt(-2 * math.log(ur)) * math.cos(2 * math.pi * up), rel=1e-14)


def _uniform_met(u0=10.0, nx=36, ny=19, nz=8):
    lon, lat, p, f2, f3 = inputs.wind_met(nx, ny, nz)
    for k in ("u", "v"):
        f3[k][:] = 0.0
    f3["u"][:] = u0
    return ref.met_pair((0.0, 3600.0), lon, lat, p, f2, f3)


def test_reference_step_by_hand():
    """A parcel in a uniform 10 m/s zonal wind with no diffusion, no
    decay: one 180 s step moves it 1.8 km east along its latitude."""
    met = _uniform_met()
    ctl = dict(checks.CTL_DEFAULTS, turb_dx_trop=0.0, turb_dx_pbl=0.0,
               turb_dz_strat=0.0, turb_mesox=0.0, turb_mesoz=0.0,
               t_stop=1e6)
    clim = ref.load_clim()
    state = {k: torch.tensor([v], dtype=torch.float64) for k, v in dict(
        time=0.0, lon=10.0, lat=30.0, p=500.0, t=0.0, m=1.0, u=0.0, v=0.0,
        w=0.0).items()}
    out = ref.step(ctl, met, clim, state, 180.0, 0, 1, torch.tensor([0]))
    dlon = 1.8 * 180.0 / (math.pi * ref.RE * math.cos(math.radians(30.0)))
    assert float(out["lon"][0]) == pytest.approx(10.0 + dlon, abs=1e-12)
    assert float(out["lat"][0]) == pytest.approx(30.0, abs=1e-12)
    assert float(out["p"][0]) == 500.0
    assert float(out["time"][0]) == 180.0
    assert float(out["t"][0]) == pytest.approx(280.0)
    assert float(out["m"][0]) == 1.0
    # a 3-day lifetime takes exp(-180/259200) of the mass
    ctl["tdec_trop"] = ctl["tdec_strat"] = 259200.0
    out = ref.step(ctl, met, clim, state, 180.0, 0, 1, torch.tensor([0]))
    assert float(out["m"][0]) == pytest.approx(math.exp(-180 / 259200),
                                               rel=1e-14)


def test_reference_mesoscale_memory_by_hand():
    """With only the mesoscale x-diffusion on, in a uniform wind (sigma
    0), the wind memory decays by r = 1 - 2 * 180 / 3600."""
    met = _uniform_met()
    ctl = dict(checks.CTL_DEFAULTS, turb_dx_trop=0.0, turb_dx_pbl=0.0,
               turb_dz_strat=0.0, turb_mesoz=0.0, t_stop=1e6)
    state = {k: torch.tensor([v], dtype=torch.float64) for k, v in dict(
        time=0.0, lon=10.0, lat=0.0, p=500.0, t=0.0, m=1.0, u=2.0, v=-1.0,
        w=0.0).items()}
    out = ref.step(ctl, met, ref.load_clim(), state, 180.0, 0, 1,
                   torch.tensor([0]))
    assert float(out["u"][0]) == pytest.approx(0.9 * 2.0, rel=1e-14)
    assert float(out["v"][0]) == pytest.approx(-0.9, rel=1e-14)


def test_reference_takes_both_sides_of_a_threshold():
    """A parcel within rounding of the top of the convective mixing (the
    boundary layer's top) gets a second version, on the other side; the
    program's parcel is held to the nearer one, and a parcel off both
    reads its gap."""
    met = _uniform_met(u0=0.0)
    ctl = dict(checks.CTL_DEFAULTS, turb_dx_trop=0.0, turb_dx_pbl=0.0,
               turb_dz_strat=0.0, turb_mesox=0.0, turb_mesoz=0.0,
               conv_mix_pbl=1, t_stop=1e6)
    pbl = float(met.f2["pbl"][0, 0, 0])
    state = {k: torch.tensor([v, v], dtype=torch.float64) for k, v in dict(
        time=0.0, lon=10.0, lat=30.0, p=500.0, t=0.0, m=1.0, u=0.0, v=0.0,
        w=0.0).items()}
    state["p"] = torch.tensor([pbl * (1 + 1e-7), 500.0], dtype=torch.float64)
    vs = ref.step_versions(ctl, met, ref.load_clim(), state, 180.0, 0, 2,
                           torch.tensor([0, 1]))
    assert len(vs) == 2
    assert float(vs[0]["p"][0]) != float(vs[1]["p"][0])
    assert float(vs[1]["p"][0]) == pytest.approx(pbl * (1 + 1e-7))
    assert float(vs[0]["p"][1]) == float(vs[1]["p"][1]) == 500.0
    for v in vs:
        assert checks.gaps(v, vs)["p_rel"] == 0.0
    off = dict(vs[0], p=vs[0]["p"] * torch.tensor([1.0, 1.001],
                                                  dtype=torch.float64))
    assert checks.gaps(off, vs)["p_rel"] == pytest.approx(1e-3)
    state["p"] = torch.tensor([pbl * 0.99, 500.0], dtype=torch.float64)
    assert len(ref.step_versions(ctl, met, ref.load_clim(), state, 180.0, 0,
                                 2, torch.tensor([0, 1]))) == 1


def test_memory_met_holds_what_the_reader_derives(tmp_path):
    """The in-memory met's derived fields (CAPE and its levels, the
    clouds) are what the program's netCDF reader derives from the same
    fields."""
    from mptrac_tpu_torch import config as p_config
    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.utils import log as p_log
    p_log.set_level(0)
    nx, ny, nz = 36, 19, 8
    lon, lat, p, f2, f3 = inputs.wind_met(nx, ny, nz)
    path = inputs.met_filename(str(tmp_path / "met"), 0.0)
    inputs.write_met_nc(path, 0.0, lon, lat, p, f2, f3)
    ctl = p_config.read_ctl(None, ["METBASE", str(tmp_path / "met"),
                                   "MET_TYPE", "0"])
    met = read_met(path, ctl, read_clim(ctl, device="cpu"), device="cpu")
    for name in ("plcl", "plfc", "pel", "cape", "cin", "pct", "pcb", "cl"):
        got = met.fields2d[name].numpy()
        assert got.shape == f2[name].shape, name
        np.testing.assert_array_equal(got, f2[name], err_msg=name)


def test_gaps_read_infinite_on_nan():
    a = {k: torch.zeros(3, dtype=torch.float64) for k in checks.STATE_KEYS}
    a["p"] = a["m"] = torch.ones(3, dtype=torch.float64)
    b = {k: v.clone() for k, v in a.items()}
    assert all(v == 0 for v in checks.gaps(b, a).values())
    b["lon"][1] = math.nan
    assert checks.gaps(b, a)["pos_km"] == math.inf


def test_state_hash_is_order_free():
    from types import SimpleNamespace
    n = 1000
    g = torch.Generator().manual_seed(1)
    cols = {k: torch.rand(n, generator=g) for k in checks.STATE_KEYS}
    cols["time"] = cols["time"].double()

    def state(perm):
        atm = SimpleNamespace(time=cols["time"][perm], lon=cols["lon"][perm],
                              lat=cols["lat"][perm], p=cols["p"][perm],
                              q={"t": cols["t"][perm], "m": cols["m"][perm]})
        cache = SimpleNamespace(uvwp=torch.stack(
            [cols[k][perm] for k in "uvw"]))
        return atm, cache

    ident = torch.arange(n)
    h = int(checks.state_hash(*state(ident)))
    assert int(checks.state_hash(*state(torch.randperm(n, generator=g)))) == h
    dup = ident.clone()
    dup[5] = 6
    assert int(checks.state_hash(*state(dup))) != h
    atm, cache = state(ident)
    atm.lat = atm.lat[torch.randperm(n, generator=g)]
    assert int(checks.state_hash(atm, cache)) != h


@pytest.mark.parametrize("cell", ["base.mem", "chem.mem", "base.hourly_nc"])
def test_tiny_run_is_correct(cell):
    from benchmark import harness
    out = harness.run(cell, 2 ** 31 + 12345, 0.2, False, device="cpu",
                      sizes=TINY)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 10
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {
        m["name"] for m in manifest.cell_metrics(manifest.load_manifest(),
                                                 cell, False)}


def test_run_loads_no_jax():
    """A whole run, in a fresh process, leaves no module of JAX or of the
    JAX package (by top-level name) loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.run('base.mem', 7, 0.1, False, device='cpu', sizes=%r)\n"
        "print(harness.forbidden_modules())\n") % (ROOT, TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "base.mem",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_draws_follow_the_seed():
    a = inputs.draw_parcels(64, 2 ** 33 + 1, manifest.config("base")[
        "parcels"], "cpu")
    b = inputs.draw_parcels(64, 2 ** 33 + 1, manifest.config("base")[
        "parcels"], "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a[1].min()) >= -60 and float(a[2].max()) <= 900
    s = inputs.draw_slots(1000, 100, 5, 11)
    assert np.array_equal(s, inputs.draw_slots(1000, 100, 5, 11))
    assert len(set(s.tolist())) == 100
