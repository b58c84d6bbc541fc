"""The domain decomposition of the port (``mptrac_tpu_torch.parallel.dd``)
held against the JAX package's ``parallel/dd.py`` on the same inputs:
the owner search, the tiles, the hyperslab read, the scatter and gather,
and the step with its parcel migration on ``tests/test_dd.py``'s case
(8 subdomains in one process: the port's local group, the JAX package's
8 virtual CPU devices) and on the 3x3 stress case of
``tests/helpers/dd_stress_worker.py``, whose JAX side runs in a
subprocess with 9 virtual devices (this file, started as a script).

Run as a script (``python test_torch_dd.py --stress-jax OUT.npz``) it is
that subprocess: it writes the JAX run of the stress case to ``OUT``."""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

#: the stress case (dd_stress_worker.py): 3 x 3 subdomains, 10,000
#: parcels, diffusion on, 24 steps, then one step at exch_cap 1, then a
#: regional latitude range over 12 steps
STRESS_CTL = [
    "NQ", "1", "QNT_NAME[0]", "idx", "METBASE", "-",
    "DIFFUSION", "1", "TURB_DX_TROP", "50", "TURB_DZ_TROP", "0.1",
    "TURB_MESOX", "0.16", "TURB_MESOZ", "0.4",
    "ADVECT", "2", "MET_DT_OUT", "0",
    "DD", "1", "DD_SUBDOMAINS_ZONAL", "3",
    "DD_SUBDOMAINS_MERIDIONAL", "3", "DD_HALOS_SIZE", "4",
    "T_STOP", "86400", "DT_MOD", "1200"]
STRESS_N = 10_000
STRESS_CAP = 4096
STRESS_STEPS = 24
STRESS_REG_STEPS = 12

#: tests/test_dd.py's case: 4 x 2 subdomains, tilted solid-body wind
DD_CTL = [
    "NQ", "1", "QNT_NAME[0]", "idx",
    "METBASE", "-", "DIFFUSION", "0", "ADVECT", "4",
    "DD", "1", "DD_SUBDOMAINS_ZONAL", "4",
    "DD_SUBDOMAINS_MERIDIONAL", "2", "DD_HALOS_SIZE", "4",
    "MET_DT_OUT", "0", "T_STOP", "86400", "DT_MOD", "1200"]


def stress_parcels():
    """(lon, lat, p, lat of the regional run) of the stress case, from
    its numpy seed in its order of draws."""
    rng = np.random.default_rng(11)
    n = STRESS_N
    lon = rng.uniform(0, 360, n)
    lat = rng.uniform(-55, 55, n)
    p = rng.uniform(300, 900, n)
    lat_reg = rng.uniform(50, 59.5, n)
    return lon, lat, p, lat_reg


def jax_case(ctl_args, n, seed, lat_range=(-60, 60), nx=90, ny=46, nz=8):
    """(ctl, clim, met01, atm) of the JAX package on the tilted wind."""
    import jax.numpy as jnp
    from mptrac_tpu import read_ctl, stack_met
    from mptrac_tpu.climatology import read_clim
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.types import Atm
    ctl = read_ctl(None, list(ctl_args))
    clim = read_clim(ctl)
    met01 = stack_met(
        make_wind_met(t0=0.0, nx=nx, ny=ny, nz=nz, alpha=40.0),
        make_wind_met(t0=86400.0, nx=nx, ny=ny, nz=nz, alpha=40.0))
    rng = np.random.default_rng(seed)
    atm = Atm.zeros(n, ctl.qnt_name).replace(
        time=jnp.zeros(n), lon=jnp.asarray(rng.uniform(0, 360, n)),
        lat=jnp.asarray(rng.uniform(*lat_range, n)),
        p=jnp.asarray(rng.uniform(300, 900, n)),
        np=jnp.asarray(n, jnp.int32))
    atm.q["idx"] = jnp.arange(n, dtype=jnp.float64)
    return ctl, clim, met01, atm


def port_case(ctl_args, jmet01, jclim, jatm, dtype=None):
    """The port's (ctl, clim, met01, atm) on the CPU from the JAX
    package's inputs (tests/helpers/torch_bridge)."""
    sys.path.insert(0, os.path.join(HERE, "helpers"))
    from torch_bridge import to_torch

    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.types import astype_state
    atm, _, met01, clim = to_torch(atm=jatm, met01=jmet01, clim=jclim)
    if dtype is not None:
        atm, met01, clim = astype_state(atm=atm, met=met01, clim=clim,
                                        dtype=dtype)
    return read_ctl(None, list(ctl_args)), clim, met01, atm


def jax_first(met01):
    import jax
    return jax.tree.map(lambda x: x[0], met01)


def state_numpy(atm, cache):
    """{column: numpy} of a DD state of either package."""
    out = {k: np.asarray(getattr(atm, k)) for k in ("time", "p", "lon",
                                                    "lat")}
    out.update({"q_" + k: np.asarray(v) for k, v in atm.q.items()})
    out["uvwp"] = np.asarray(cache.uvwp)
    out["np"] = np.asarray(atm.np)
    return out


# ------------------------------------------------------- the subprocess

def _stress_jax(out_path):
    """The JAX side of the stress case on 9 virtual devices: the state
    after the 24 steps, the per-step counts, the overflow of one step at
    exch_cap 1, and the regional run's lost parcels."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 9)
    import jax.numpy as jnp
    from mptrac_tpu import read_ctl, stack_met
    from mptrac_tpu.climatology import read_clim
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.parallel import dd as ddm
    from mptrac_tpu.parallel import mesh as pmesh
    from mptrac_tpu.types import Atm

    ctl = read_ctl(None, STRESS_CTL)
    clim = read_clim(ctl)
    met01 = stack_met(make_wind_met(t0=0.0, nx=90, ny=46, nz=8, alpha=40.0),
                      make_wind_met(t0=86400.0, nx=90, ny=46, nz=8,
                                    alpha=40.0))
    lon, lat, p, lat_reg = stress_parcels()
    n = STRESS_N
    atm = Atm.zeros(n, ctl.qnt_name).replace(
        time=jnp.zeros(n), lon=jnp.asarray(lon), lat=jnp.asarray(lat),
        p=jnp.asarray(p), np=jnp.asarray(n, jnp.int32))
    atm.q["idx"] = jnp.arange(n, dtype=jnp.float64)
    dd = ddm.plan_decomposition(ctl, jax_first(met01), ndev=9)
    mesh = pmesh.make_mesh(9, axis="sub")
    tiles = ddm.make_tiles(dd, met01)
    lat_axis = np.asarray(met01.lat[0])
    a, c = ddm.scatter_parcels(dd, atm, STRESS_CAP, lat_axis)
    step = ddm.make_dd_step(ctl, clim, dd, mesh, STRESS_CAP, exch_cap=1024,
                            lat_axis=lat_axis)
    res = {"counts": [], "lost": [], "overflow": []}
    for i in range(1, STRESS_STEPS + 1):
        a, c, ov, lo = step(tiles, a, c, jnp.asarray(i * 1200.0))
        res["counts"].append(np.asarray(a.np))
        res["lost"].append(np.asarray(lo))
        res["overflow"].append(np.asarray(ov))
    res.update({"final_" + k: v for k, v in state_numpy(a, c).items()})
    res["final_rng_ctr"] = np.asarray(c.rng_ctr)
    tiny = ddm.make_dd_step(ctl, clim, dd, mesh, STRESS_CAP, exch_cap=1,
                            lat_axis=lat_axis)
    _, _, ov1, _ = tiny(tiles, a, c,
                        jnp.asarray((STRESS_STEPS + 1) * 1200.0))
    res["overflow_tiny"] = np.asarray(ov1)
    lat_r = lat_axis[np.abs(lat_axis) <= 60.0]
    dd_reg = ddm.DDGrid(n_zonal=3, n_merid=3, halo=4, nx_glob=dd.nx_glob,
                        ny_glob=lat_r.size, lon0=dd.lon0, dlon=dd.dlon,
                        periodic=dd.periodic)
    atm2 = atm.replace(lat=jnp.asarray(lat_reg),
                       np=jnp.asarray(n, jnp.int32))
    a2, c2 = ddm.scatter_parcels(dd_reg, atm2, STRESS_CAP, lat_r)
    step_r = ddm.make_dd_step(ctl, clim, dd_reg, mesh, STRESS_CAP,
                              exch_cap=1024, lat_axis=lat_r)
    res["reg_lost"] = []
    for i in range(1, STRESS_REG_STEPS + 1):
        a2, c2, _, lo = step_r(tiles, a2, c2, jnp.asarray(i * 1200.0))
        res["reg_lost"].append(np.asarray(lo))
    res["reg_counts"] = np.asarray(a2.np)
    np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--stress-jax":
        sys.path.insert(0, os.path.dirname(HERE))
        os.environ["JAX_PLATFORMS"] = "cpu"
        _stress_jax(sys.argv[2])
        sys.exit(0)
    sys.exit("usage: test_torch_dd.py --stress-jax OUT.npz")


# ------------------------------------------------------------- the tests

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mptrac_tpu.parallel import dd as jdd  # noqa: E402
from mptrac_tpu.parallel import mesh as jmesh  # noqa: E402
from mptrac_tpu_torch.parallel import dd as tdd  # noqa: E402

os.environ.setdefault("LOGLEV", "0")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers (module-wide, so that the module fixtures
    run on one thread too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stress_jax(tmp_path_factory):
    """The JAX side of the stress case, in a process of its own with 9
    virtual devices; started only for the test that reads it."""
    out = tmp_path_factory.mktemp("stress") / "stress.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=9")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stress-jax",
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _grid(n_zonal=4, n_merid=2, halo=2, nx=91, ny=46, lon0=0.0, dlon=4.0):
    kw = dict(n_zonal=n_zonal, n_merid=n_merid, halo=halo, nx_glob=nx,
              ny_glob=ny, lon0=lon0, dlon=dlon, periodic=True)
    return jdd.DDGrid(**kw), tdd.DDGrid(**kw)


@pytest.mark.parametrize("case", ["random", "nan", "dateline",
                                  "beyond_360", "descending", "float32"])
def test_owner_of_matches_jax(case):
    """The owner index of the JAX compare-count on random positions, NaN
    latitudes and longitudes, +-180 and the grid's own nodes, longitudes
    beyond +-360, a descending latitude axis (ERA5's order) and float32
    positions against a float64 axis."""
    rng = np.random.default_rng(3)
    jg, tg = _grid()
    lat_axis = np.linspace(-90, 90, 46)
    n = 4000
    lon = rng.uniform(-180, 360, n)
    lat = rng.uniform(-95, 95, n)
    if case == "nan":
        lat[::7] = np.nan
        lon[::11] = np.nan
    elif case == "dateline":
        lon[: n // 2] = rng.choice([-180.0, 180.0, 0.0, 360.0, 176.0,
                                    -0.0], n // 2)
        lat[: n // 4] = rng.choice(lat_axis, n // 4)
    elif case == "beyond_360":
        lon = rng.uniform(-2000, 2000, n)
    elif case == "descending":
        lat_axis = lat_axis[::-1].copy()
        lat[: n // 4] = rng.choice(lat_axis, n // 4)
    dtype = np.float32 if case == "float32" else np.float64
    lon, lat = lon.astype(dtype), lat.astype(dtype)
    want = np.asarray(jg.owner_of(jnp.asarray(lon), jnp.asarray(lat),
                                  jnp.asarray(lat_axis)))
    got = tg.owner_of(torch.from_numpy(lon), torch.from_numpy(lat),
                      lat_axis).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_owner_of_raises_on_unordered_axis():
    _, tg = _grid()
    with pytest.raises(ValueError, match="monotone"):
        tg.owner_of(torch.zeros(3), torch.zeros(3),
                    np.array([0.0, 10.0, 5.0, 20.0]))


def test_tile_selection_matches_jax():
    jg, tg = _grid()
    lat = np.linspace(-90, 90, 46)
    for rank in range(8):
        for a, b in zip(jdd.tile_selection(jg, rank, lat),
                        tdd.tile_selection(tg, rank, lat)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dd_case():
    """tests/test_dd.py's case in both packages (float64)."""
    jctl, jclim, jmet01, jatm = jax_case(DD_CTL, 200, 5)
    tctl, tclim, tmet01, tatm = port_case(DD_CTL, jmet01, jclim, jatm)
    return dict(jctl=jctl, jclim=jclim, jmet01=jmet01, jatm=jatm,
                tctl=tctl, tclim=tclim, tmet01=tmet01, tatm=tatm)


def test_plan_and_make_tiles_match_jax(dd_case):
    c = dd_case
    jg = jdd.plan_decomposition(c["jctl"], jax_first(c["jmet01"]), ndev=8)
    tg = tdd.plan_decomposition(c["tctl"], c["tmet01"], ndev=8)
    assert vars(jg) == vars(tg)
    jt = jdd.make_tiles(jg, c["jmet01"])
    tt = tdd.make_tiles(tg, c["tmet01"])
    for name in ("lon", "lat", "p", "hybrid"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert set(tt.fields3d) == set(jt.fields3d)
    for k in tt.fields3d:
        np.testing.assert_array_equal(tt.fields3d[k].numpy(),
                                      np.asarray(jt.fields3d[k]))
    for k in tt.fields2d:
        np.testing.assert_array_equal(tt.fields2d[k].numpy(),
                                      np.asarray(jt.fields2d[k]))
    assert tt.time == c["tmet01"].time
    assert tuple(tt.fields3d["u"].shape[:3]) == (8, 2, tg.nx_loc)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scatter_and_gather_match_jax(dd_case, dtype):
    """Slots, counts and values equal the JAX package's; the float32 mode
    keeps its dtypes (float64 time), where JAX promotes every column to
    float64 (F9): the float32 values survive that exactly."""
    c = dd_case
    jg = jdd.plan_decomposition(c["jctl"], jax_first(c["jmet01"]), ndev=8)
    tg = tdd.plan_decomposition(c["tctl"], c["tmet01"], ndev=8)
    lat_axis = np.asarray(c["jmet01"].lat[0])
    jatm = c["jatm"]
    tatm = c["tatm"]
    if dtype == "float32":
        from mptrac_tpu.types import astype_state as jast
        from mptrac_tpu_torch.types import astype_state as tast
        jatm = jast(jatm, dtype=jnp.float32)
        tatm = tast(tatm, dtype=torch.float32)
    ja, jc = jdd.scatter_parcels(jg, jatm, 64, lat_axis)
    ta, tc = tdd.scatter_parcels(tg, tatm, 64, lat_axis)
    np.testing.assert_array_equal(ta.np, np.asarray(ja.np))
    for name in ("time", "p", "lon", "lat"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    np.testing.assert_array_equal(ta.q["idx"].numpy(),
                                  np.asarray(ja.q["idx"]))
    assert np.asarray(ja.lon).dtype == np.float64            # F9
    assert ta.time.dtype == torch.float64
    assert ta.lon.dtype == tc.dt.dtype == getattr(torch, dtype)
    assert tc.rng_ctr == [0] * 8 and tc.served_min == [1.0] * 8
    jo = jdd.gather_parcels(jg, ja, 64)
    to = tdd.gather_parcels(tg, ta, 64)
    assert to.np == int(jo.np) == 200
    np.testing.assert_array_equal(to.lon.numpy(), np.asarray(jo.lon))
    np.testing.assert_array_equal(to.q["idx"].numpy(),
                                  np.asarray(jo.q["idx"]))
    with pytest.raises(ValueError, match="capacity"):
        tdd.scatter_parcels(tg, tatm, 8, lat_axis)


def run_jax_dd(c, nsteps, cap=128, exch_cap=32, exchange=True):
    jg = jdd.plan_decomposition(c["jctl"], jax_first(c["jmet01"]), ndev=8)
    mesh = jmesh.make_mesh(8, axis="sub")
    tiles = jdd.make_tiles(jg, c["jmet01"])
    lat_axis = np.asarray(c["jmet01"].lat[0])
    ctl = c["jctl"].replace(t_start=0.0, t_stop=nsteps * 1200.0)
    a, ca = jdd.scatter_parcels(jg, c["jatm"], cap, lat_axis)
    step = jdd.make_dd_step(ctl, c["jclim"], jg, mesh, cap, exch_cap,
                            lat_axis, exchange=exchange)
    per_step = []
    for i in range(1, nsteps + 1):
        a, ca, ov, lo = step(tiles, a, ca, jnp.asarray(i * 1200.0))
        per_step.append((np.asarray(a.np), np.asarray(ov), np.asarray(lo)))
    return a, ca, per_step


def run_port_dd(c, nsteps, cap=128, exch_cap=32, exchange=True):
    tg = tdd.plan_decomposition(c["tctl"], c["tmet01"], ndev=8)
    tiles = tdd.make_tiles(tg, c["tmet01"])
    lat_axis = c["tmet01"].lat[0]
    ctl = c["tctl"].replace(t_start=0.0, t_stop=nsteps * 1200.0)
    a, ca = tdd.scatter_parcels(tg, c["tatm"], cap, lat_axis)
    step = tdd.make_dd_step(ctl, c["tclim"], tg,
                            tdd.local_group(8, "cpu"), cap, exch_cap,
                            lat_axis, exchange=exchange)
    per_step = []
    for i in range(1, nsteps + 1):
        a, ca, ov, lo = step(tiles, a, ca, i * 1200.0)
        per_step.append((a.np.copy(), ov, lo))
    return a, ca, per_step


@pytest.fixture(scope="module")
def dd_runs(dd_case):
    """24 steps of both packages' DD step on test_dd.py's case."""
    return run_jax_dd(dd_case, 24), run_port_dd(dd_case, 24)


def test_dd_step_matches_jax(dd_runs):
    """Every column of every slot at rtol 1e-12 after 24 steps; the live
    counts, the overflow and the lost counts of every step exactly."""
    (ja, jc, jsteps), (ta, tc, tsteps) = dd_runs
    for (jn, jo, jl), (tn, to, tl) in zip(jsteps, tsteps):
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tl, jl)
    counts = np.stack([s[0] for s in tsteps])
    assert (counts != counts[0]).any(), "no parcel changed its subdomain"
    jn, tn = state_numpy(ja, jc), state_numpy(ta, tc)
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-12, atol=0,
                                   err_msg=k)
    assert tc.rng_ctr == [int(x) for x in np.asarray(jc.rng_ctr)]


def test_dd_step_matches_single_domain(dd_case, dd_runs):
    """The decomposed trajectories equal the port's non-decomposed run
    (tests/test_dd.py's check: the halos cover a step's reach)."""
    from mptrac_tpu_torch.physics import pipeline
    from mptrac_tpu_torch.types import Cache
    c = dd_case
    _, (ta, _, _) = dd_runs
    ctl = c["tctl"].replace(t_start=0.0, t_stop=24 * 1200.0, dd=0)
    a = c["tatm"]
    cache = Cache.zeros(a.npmax, device="cpu")
    for i in range(1, 25):
        a, cache = pipeline.run_timestep(ctl, c["tclim"], c["tmet01"], a,
                                         cache, i * 1200.0)
    tg = tdd.plan_decomposition(c["tctl"], c["tmet01"], ndev=8)
    out = tdd.gather_parcels(tg, ta, 128)
    assert out.np == 200
    od = torch.argsort(out.q["idx"])
    os_ = torch.argsort(a.q["idx"])
    dlon = ((out.lon[od] - a.lon[os_] + 180) % 360 - 180).abs()
    assert float(dlon.max()) < 1e-9
    np.testing.assert_allclose(out.lat[od].numpy(), a.lat[os_].numpy(),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(out.p[od].numpy(), a.p[os_].numpy(),
                               atol=1e-9, rtol=0)


def test_dd_step_without_exchange_matches_jax(dd_case):
    """``exchange=False``: the state where the physics left it and the
    count of parcels that would migrate, as the JAX step gives them."""
    ja, jc, jsteps = run_jax_dd(dd_case, 3, exchange=False)
    ta, tc, tsteps = run_port_dd(dd_case, 3, exchange=False)
    for (jn, jm, jl), (tn, tm, tl) in zip(jsteps, tsteps):
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tl, jl)
    assert sum(int(s[1].sum()) for s in tsteps) > 0
    jn, tn = state_numpy(ja, jc), state_numpy(ta, tc)
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-12, atol=0,
                                   err_msg=k)


def test_float32_state_keeps_dtypes_and_jax_values(dd_case):
    """F9: in the float32 mode the port's DD state stays float32 (time
    and the parcel index float64, as ``astype_state`` keeps them) through
    scatter and step, where the JAX step's state turns float64; the
    values still equal JAX's at float32's resolution (the JAX side
    computes the owner and the lost test on float64 copies of the same
    float32 values)."""
    from mptrac_tpu.types import astype_state as jast
    from mptrac_tpu_torch.types import astype_state as tast
    c = dict(dd_case)
    c["jatm"] = jast(c["jatm"], dtype=jnp.float32)
    c["tatm"] = tast(c["tatm"], dtype=torch.float32)
    ja, jc, jsteps = run_jax_dd(c, 2)
    ta, tc, tsteps = run_port_dd(c, 2)
    assert np.asarray(ja.lon).dtype == np.float64                # F9
    assert ta.lon.dtype == ta.p.dtype == torch.float32
    assert ta.time.dtype == ta.q["idx"].dtype == torch.float64
    assert tc.uvwp.dtype == torch.float32
    for (jn, _, _), (tn, _, _) in zip(jsteps, tsteps):
        np.testing.assert_array_equal(tn, jn)
    jn, tn = state_numpy(ja, jc), state_numpy(ta, tc)
    for k in ("lon", "lat", "p"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=2e-3,
                                   err_msg=k)
    np.testing.assert_array_equal(tn["q_idx"], jn["q_idx"])


def test_overflow_drops_movers_and_counts_them(dd_case):
    """F10: a mover beyond ``exch_cap`` is neither kept nor sent, as in
    the JAX step: live + lost + dropped by overflow == n, and the counts
    equal the JAX package's."""
    n = 2000
    jctl, jclim, jmet01, jatm = jax_case(DD_CTL, n, 5)
    c = dict(jctl=jctl, jclim=jclim, jmet01=jmet01, jatm=jatm)
    c.update(zip(("tctl", "tclim", "tmet01", "tatm"),
                 port_case(DD_CTL, jmet01, jclim, jatm)))
    ja, _, jsteps = run_jax_dd(c, 3, cap=512, exch_cap=1)
    ta, _, tsteps = run_port_dd(c, 3, cap=512, exch_cap=1)
    dropped = lost = 0
    for (jn, jo, jl), (tn, to, tl) in zip(jsteps, tsteps):
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tl, jl)
        dropped += int(to.sum())
        lost += int(tl.sum())
        assert int(tn.sum()) + lost + dropped == n
    assert dropped > 0
    assert int(np.asarray(ja.np).sum()) == int(ta.np.sum()) < n


def test_read_met_tile_matches_jax_and_global_read(tmp_path):
    """The hyperslab tile equals the JAX package's tile and the sliced
    global read (tests/test_dd.py's test_read_met_tile_hyperslab)."""
    from mptrac_tpu import read_ctl as jread_ctl
    from mptrac_tpu.met.build import read_met as jread_met
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.met.write_nc import write_met_nc
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    args = ["NQ", "0", "METBASE", "-", "MET_TROPO", "0", "MET_CAPE", "0",
            "MET_PBL", "3", "T_STOP", "1",
            "DD", "1", "DD_SUBDOMAINS_ZONAL", "2",
            "DD_SUBDOMAINS_MERIDIONAL", "2", "DD_HALOS_SIZE", "3"]
    fn = str(tmp_path / "wind_2000_01_01_00.nc")
    write_met_nc(fn, make_wind_met(nx=36, ny=19, nz=8),
                 drop_wrap_column=True)
    jctl, tctl = jread_ctl(None, args), read_ctl(None, args)
    jglob = jread_met(fn, jctl)
    tglob = read_met(fn, tctl, device="cpu")
    jg = jdd.plan_decomposition(jctl, jglob, ndev=4)
    tg = tdd.plan_decomposition(tctl, tglob, ndev=4)
    lat_glob = tglob.lat.numpy()
    for rank in range(4):
        jt = jdd.read_met_tile(fn, jctl, jg, rank, np.asarray(jglob.lat))
        tt = tdd.read_met_tile(fn, tctl, tg, rank, lat_glob, device="cpu")
        xidx, yidx, lon_axis, lat_axis = tdd.tile_selection(tg, rank,
                                                            lat_glob)
        np.testing.assert_array_equal(tt.lon.numpy(), lon_axis)
        np.testing.assert_array_equal(tt.lat.numpy(), lat_axis)
        for k in tt.fields3d:
            np.testing.assert_array_equal(tt.fields3d[k].numpy(),
                                          np.asarray(jt.fields3d[k]),
                                          err_msg=k)
        for k in tt.fields2d:
            np.testing.assert_array_equal(tt.fields2d[k].numpy(),
                                          np.asarray(jt.fields2d[k]),
                                          err_msg=k)
        u_g = tglob.fields3d["u"].numpy()[xidx][:, yidx]
        h = tg.halo
        np.testing.assert_allclose(tt.fields3d["u"].numpy()[h:-h, h:-h],
                                   u_g[h:-h, h:-h], atol=1e-5)
    with pytest.raises(NotImplementedError, match="hyperslab"):
        read_met(fn, tctl.replace(met_type=1), device="cpu",
                 sel=tdd.tile_selection(tg, 0, lat_glob))


def test_stress_3x3_matches_jax(stress_jax):
    """The stress case (dd_stress_worker.py): 3 x 3 subdomains, 10,000
    parcels, turbulent and mesoscale diffusion on, 24 steps; the JAX side
    on 9 virtual devices in a subprocess.  Every step's per-subdomain
    counts and lost parcels and the overflow at exch_cap 1 equal the JAX
    package's exactly, and so do the regional run's lost parcels; the
    positions agree at test_torch_trac.py's tolerance with the mesoscale
    diffusion on (ATOL_DEG, 5e-5 deg).  Conservation holds on the port's
    side every step."""
    proc, out = stress_jax

    # the port's side, on the same inputs
    from mptrac_tpu.types import Atm as JAtm
    jctl, jclim, jmet01, _ = jax_case(STRESS_CTL, 1, 0)
    lon, lat, p, lat_reg = stress_parcels()
    n = STRESS_N
    jatm = JAtm.zeros(n, jctl.qnt_name).replace(
        time=jnp.zeros(n), lon=jnp.asarray(lon), lat=jnp.asarray(lat),
        p=jnp.asarray(p), np=jnp.asarray(n, jnp.int32))
    jatm.q["idx"] = jnp.arange(n, dtype=jnp.float64)
    ctl, clim, met01, atm = port_case(STRESS_CTL, jmet01, jclim, jatm)
    tg = tdd.plan_decomposition(ctl, met01, ndev=9)
    tiles = tdd.make_tiles(tg, met01)
    lat_axis = met01.lat[0].numpy()
    group = tdd.local_group(9, "cpu")
    a, c = tdd.scatter_parcels(tg, atm, STRESS_CAP, lat_axis)
    step = tdd.make_dd_step(ctl, clim, tg, group, STRESS_CAP, 1024,
                            lat_axis)
    counts, lost, total_lost = [], [], 0
    for i in range(1, STRESS_STEPS + 1):
        a, c, ov, lo = step(tiles, a, c, i * 1200.0)
        assert int(ov.sum()) == 0, f"overflow at step {i}"
        total_lost += int(lo.sum())
        assert int(a.np.sum()) + total_lost == n, i
        counts.append(a.np.copy())
        lost.append(lo)
    tiny = tdd.make_dd_step(ctl, clim, tg, group, STRESS_CAP, 1, lat_axis)
    _, _, ov1, _ = tiny(tiles, a, c, (STRESS_STEPS + 1) * 1200.0)
    lat_r = lat_axis[np.abs(lat_axis) <= 60.0]
    dd_reg = tdd.DDGrid(n_zonal=3, n_merid=3, halo=4, nx_glob=tg.nx_glob,
                        ny_glob=lat_r.size, lon0=tg.lon0, dlon=tg.dlon,
                        periodic=tg.periodic)
    atm2 = atm.replace(lat=torch.from_numpy(lat_reg), np=n)
    a2, c2 = tdd.scatter_parcels(dd_reg, atm2, STRESS_CAP, lat_r)
    step_r = tdd.make_dd_step(ctl, clim, dd_reg, group, STRESS_CAP, 1024,
                              lat_r)
    reg_lost = []
    for i in range(1, STRESS_REG_STEPS + 1):
        a2, c2, _, lo = step_r(tiles, a2, c2, i * 1200.0)
        reg_lost.append(lo)

    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, stdout + stderr[-3000:]
    j = np.load(out)

    np.testing.assert_array_equal(np.stack(counts), j["counts"])
    np.testing.assert_array_equal(np.stack(lost), j["lost"])
    assert int(j["overflow"].sum()) == 0
    assert (a.np > 0).all()
    assert int(ov1.sum()) > 0
    np.testing.assert_array_equal(ov1, j["overflow_tiny"])
    np.testing.assert_array_equal(np.stack(reg_lost), j["reg_lost"])
    assert int(np.stack(reg_lost).sum()) > 0
    np.testing.assert_array_equal(a2.np, j["reg_counts"])
    assert int(a2.np.sum()) + int(np.stack(reg_lost).sum()) == n
    assert c.rng_ctr == [int(x) for x in j["final_rng_ctr"]]
    # positions, parcel by parcel through the idx quantity
    tn = state_numpy(a, c)
    np.testing.assert_array_equal(tn["np"], j["final_np"])
    live_t = _live(tn, STRESS_CAP)
    live_j = _live({k[6:]: j[k] for k in j.files if k.startswith("final_")},
                   STRESS_CAP)
    np.testing.assert_array_equal(live_t["q_idx"], live_j["q_idx"])
    dlon = np.abs((live_t["lon"] - live_j["lon"] + 180) % 360 - 180)
    assert dlon.max() < 5e-5, dlon.max()
    np.testing.assert_allclose(live_t["lat"], live_j["lat"], rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(live_t["p"], live_j["p"], rtol=1e-6, atol=0)


def _live(cols, cap):
    """The live slots of a DD state (numpy columns), in slot order."""
    counts = cols["np"]
    slot = np.arange(cols["lon"].shape[0])
    keep = slot % cap < counts[slot // cap]
    return {k: v[..., keep] for k, v in cols.items()
            if v.shape[-1:] == keep.shape}


def test_receiving_beyond_capacity_raises(dd_case):
    """A subdomain that would hold more than ``cap`` parcels after the
    exchange raises, where the JAX step would record a count beyond its
    slots (the reference stops at its NP check, c:2281): 10 parcels at
    the east edge of subdomain 0 blow into subdomain 2, which holds 25 of
    its 30 slots."""
    from mptrac_tpu_torch.types import Atm
    c = dd_case
    n = 35
    lon = torch.tensor([87.9] * 10 + [100.0] * 25, dtype=torch.float64)
    lat = torch.full((n,), -10.0, dtype=torch.float64)
    atm = Atm(time=torch.zeros(n, dtype=torch.float64), lon=lon, lat=lat,
              p=torch.full((n,), 500.0, dtype=torch.float64),
              q={"idx": torch.arange(n, dtype=torch.float64)}, np=n)
    tg = tdd.plan_decomposition(c["tctl"], c["tmet01"], ndev=8)
    lat_axis = c["tmet01"].lat[0]
    a, ca = tdd.scatter_parcels(tg, atm, 30, lat_axis)
    assert a.np[0] == 10 and a.np[2] == 25
    step = tdd.make_dd_step(c["tctl"].replace(t_start=0.0, t_stop=1200.0),
                            c["tclim"], tg, tdd.local_group(8, "cpu"), 30,
                            16, lat_axis)
    with pytest.raises(ValueError, match="exceed its capacity 30"):
        step(tdd.make_tiles(tg, c["tmet01"]), a, ca, 1200.0)


@pytest.mark.parametrize("devices", [("cpu", "cuda:0"), ("cuda:0", "cuda:1"),
                                     ("cpu", "cpu:1")],
                         ids=["cpu-cuda", "two-cards", "cpu-indices"])
def test_local_group_on_several_devices_raises(devices):
    """A local group whose subdomains lie on different devices of one
    process is refused (no machine at hand has two cards to hold such an
    exchange against anything); the mesh needs no card to be built."""
    import torch

    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.parallel import dd as tdd
    from mptrac_tpu_torch.parallel.mesh import Mesh
    ctl = read_ctl(None, ["DD_SUBDOMAINS_ZONAL", "2",
                          "DD_SUBDOMAINS_MERIDIONAL", "1"] + DD_CTL)
    dd = tdd.plan_decomposition(
        ctl, make_wind_met(nx=36, ny=19, nz=8, device="cpu"), ndev=2)
    group = Mesh(devices=tuple(torch.device(d) for d in devices),
                 axis="sub")
    with pytest.raises(NotImplementedError, match="several devices"):
        tdd.make_dd_step(ctl, None, dd, group, cap=16, exch_cap=4,
                         lat_axis=None)
