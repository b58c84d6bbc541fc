"""The multi-process runtime of the port
(``mptrac_tpu_torch.parallel.multihost``): two gloo processes on the CPU
run ``tests/helpers/dd_worker.py``'s case (one subdomain each, met tiles
read as hyperslabs, rank 0's met broadcast to the other rank, parcels
exchanged by ``all_to_all_single``).  Their blocks equal the port's local
group (both subdomains in one process) bit for bit, and the JAX
package's DD step on 2 devices in this process at rtol 1e-12.

Run as a script (``python test_torch_multihost.py --worker RANK PORT
METDIR``) it is one of those processes: it writes its block to
``METDIR/rank<RANK>.npz``."""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("wind_2000_01_01_00.nc", "wind_2000_01_01_01.nc")
CTL_ARGS = [
    "NQ", "1", "QNT_NAME[0]", "m", "METBASE", "-", "DT_MOD", "180",
    "DIFFUSION", "0", "T_STOP", "3600", "MET_TROPO", "0",
    "MET_CAPE", "0", "MET_PBL", "3",
    "DD", "1", "DD_SUBDOMAINS_ZONAL", "2",
    "DD_SUBDOMAINS_MERIDIONAL", "1", "DD_HALOS_SIZE", "2"]
N, CAP, EXCH_CAP, STEPS = 40, 64, 16, 4


def parcels():
    """(lon, lat, p) of dd_worker.py's 40 parcels."""
    rng = np.random.default_rng(7)
    return (rng.uniform(-170, 170, N), rng.uniform(-60, 60, N),
            rng.uniform(300, 800, N))


def port_inputs(metdir, rank_tiles):
    """The port's (ctl, clim, dd, lat_glob, stacked tiles of
    ``rank_tiles``, whole atm) on the CPU."""
    import torch

    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.parallel import dd as tdd
    from mptrac_tpu_torch.types import Atm, stack_met

    ctl = read_ctl(None, CTL_ARGS)
    clim = read_clim(ctl, device="cpu")
    met_glob = read_met(os.path.join(metdir, FILES[0]), ctl, device="cpu")
    dd = tdd.plan_decomposition(ctl, met_glob, ndev=2)
    lat_glob = met_glob.lat.numpy()
    pairs = []
    for r in rank_tiles:
        t = [tdd.read_met_tile(os.path.join(metdir, f), ctl, dd, r,
                               lat_glob, clim, device="cpu") for f in FILES]
        pairs.append(stack_met(t[0], t[1]))
    lon, lat, p = parcels()
    f64 = torch.float64
    atm = Atm(time=torch.zeros(N, dtype=f64), p=torch.from_numpy(p),
              lon=torch.from_numpy(lon), lat=torch.from_numpy(lat),
              q={"m": torch.ones(N, dtype=f64)}, np=N)
    return ctl, clim, dd, lat_glob, tdd.stack_tiles(pairs), atm, met_glob


def run_steps(step, tiles, a, c):
    for i in range(STEPS):
        a, c, ov, lo = step(tiles, a, c, (i + 1) * 180.0)
    return a, c, ov, lo


def block_numpy(a, c, ov, lo):
    out = {k: getattr(a, k).numpy() for k in ("time", "p", "lon", "lat")}
    out["q_m"] = a.q["m"].numpy()
    out["uvwp"] = c.uvwp.numpy()
    out["np"] = np.asarray(a.np)
    out["rng_ctr"] = np.asarray(c.rng_ctr, np.uint64)
    out["overflow"], out["lost"] = np.asarray(ov), np.asarray(lo)
    return out


def exchange_payload(src, dtype):
    """A sender's [dst, k, exch_cap] buffer whose every entry names its
    source, destination, column and slot."""
    import torch
    dst, k, e = torch.meshgrid(torch.arange(2), torch.arange(3),
                               torch.arange(5), indexing="ij")
    return (src * 1000 + dst * 100 + k * 10 + e).to(dtype)


def _worker(rank, port, metdir):
    """One rank: join the gloo group, check read_met_shared against
    read_met, read its own tiles, step its block 4 times."""
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    torch.set_num_threads(1)
    from mptrac_tpu_torch.parallel import dd as tdd
    from mptrac_tpu_torch.parallel import multihost

    rt = multihost.init_distributed(f"localhost:{port}", 2, rank,
                                    local_devices=[torch.device("cpu")])
    try:
        assert rt.backend == "gloo" and rt.size == 2 and rt.rank == rank
        ctl, clim, dd, lat_glob, tiles, atm, met_glob = port_inputs(
            metdir, [rank])
        shared = multihost.read_met_shared(
            os.path.join(metdir, FILES[0]), ctl, rt, device="cpu")
        assert shared.time == met_glob.time
        same = dict(rtol=0, atol=0, equal_nan=True)   # (pt etc. are NaN)
        for name in ("lon", "lat", "p", "hybrid"):
            torch.testing.assert_close(getattr(shared, name),
                                       getattr(met_glob, name), **same)
        assert set(shared.fields3d) == set(met_glob.fields3d)
        assert set(shared.fields2d) == set(met_glob.fields2d)
        for k, v in met_glob.fields3d.items():
            torch.testing.assert_close(shared.fields3d[k], v, **same)
        for k, v in met_glob.fields2d.items():
            torch.testing.assert_close(shared.fields2d[k], v, **same)
        assert (shared.reg_lon, shared.lon_periodic) == (
            met_glob.reg_lon, met_glob.lon_periodic)

        mesh = multihost.global_mesh(rt)
        a_all, c_all = tdd.scatter_parcels(dd, atm, CAP, lat_glob)
        a, c = tdd.subdomain_block(a_all, c_all, CAP, [rank])
        step = tdd.make_dd_step(ctl, clim, dd, mesh, CAP, EXCH_CAP,
                                lat_glob)
        a, c, ov, lo = run_steps(step, tiles, a, c)
        total = multihost.allsum_scalar(float(a.np.sum()), rt)
        total_ov = multihost.allsum_scalar(float(ov.sum()), rt)
        assert total_ov == 0 and total + multihost.allsum_scalar(
            float(lo.sum()), rt) == N, (total, total_ov)
        g = multihost.globalize(mesh, {"lon": a.lon})
        assert g["lon"].shape == (2 * CAP,)
        assert np.array_equal(multihost.localize(g)["lon"], a.lon.numpy())
        out = block_numpy(a, c, ov, lo)
        ex = tdd._exchange_for(mesh, 2)
        for dtype in (torch.float32, torch.float64, torch.int32):
            buf = ex.buffer(3, 5, dtype)
            ex.send_view(buf, 0).copy_(exchange_payload(rank, dtype))
            out[f"recv_{dtype}"] = ex.recv_cols(ex.exchange(buf), 0).numpy()
        np.savez(os.path.join(metdir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"OK rank={rank} n={int(a.np.sum())}")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit("usage: test_torch_multihost.py --worker RANK PORT METDIR")


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mptrac_tpu_torch.parallel import dd as tdd  # noqa: E402
from mptrac_tpu_torch.parallel import multihost  # noqa: E402
from mptrac_tpu_torch.parallel.mesh import Mesh  # noqa: E402

os.environ.setdefault("LOGLEV", "0")


def _write_met(metdir):
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.met.write_nc import write_met_nc
    for t0, name in zip((0.0, 3600.0), FILES):
        write_met_nc(os.path.join(metdir, name),
                     make_wind_met(t0=t0, nx=36, ny=19, nz=8),
                     drop_wrap_column=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_two_devices(metdir):
    """The JAX package's DD step on 2 devices of this process, on the
    same hyperslab tiles (dd_worker.py's case)."""
    from mptrac_tpu import read_ctl, stack_met
    from mptrac_tpu.climatology import read_clim
    from mptrac_tpu.met.build import read_met
    from mptrac_tpu.parallel import dd as jdd
    from mptrac_tpu.parallel import mesh as jmesh
    from mptrac_tpu.types import Atm

    ctl = read_ctl(None, CTL_ARGS)
    clim = read_clim(ctl)
    met_glob = read_met(os.path.join(metdir, FILES[0]), ctl)
    dd = jdd.plan_decomposition(ctl, met_glob, ndev=2)
    lat_glob = np.asarray(met_glob.lat)
    pairs = []
    for r in range(2):
        t = [jdd.read_met_tile(os.path.join(metdir, f), ctl, dd, r,
                               lat_glob, clim) for f in FILES]
        pairs.append(stack_met(t[0], t[1]))
    tiles = jax.tree.map(lambda *x: jnp.stack(x), *pairs)
    lon, lat, p = parcels()
    atm = Atm.zeros(N, ("m",)).replace(
        time=jnp.zeros(N, jnp.float64), lon=jnp.asarray(lon),
        lat=jnp.asarray(lat), p=jnp.asarray(p),
        np=jnp.asarray(N, jnp.int32))
    atm.q["m"] = jnp.ones(N, jnp.float64)
    a, c = jdd.scatter_parcels(dd, atm, CAP, lat_glob)
    step = jdd.make_dd_step(ctl, clim, dd, jmesh.make_mesh(2, axis="sub"),
                            CAP, EXCH_CAP, lat_glob)
    for i in range(STEPS):
        a, c, ov, lo = step(tiles, a, c, jnp.asarray((i + 1) * 180.0))
    out = {k: np.asarray(getattr(a, k)) for k in ("time", "p", "lon",
                                                  "lat")}
    out["q_m"] = np.asarray(a.q["m"])
    out["uvwp"] = np.asarray(c.uvwp)
    out["np"] = np.asarray(a.np)
    out["rng_ctr"] = np.asarray(c.rng_ctr)
    out["overflow"], out["lost"] = np.asarray(ov), np.asarray(lo)
    return out


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Two gloo ranks on dd_worker.py's case, the port's local group and
    the JAX package's 2-device run on the same files."""
    metdir = str(tmp_path_factory.mktemp("met"))
    _write_met(metdir)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["LOGLEV"] = "0"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(port), metdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]

    ctl, clim, dd, lat_glob, tiles, atm, _ = port_inputs(metdir, [0, 1])
    a, c = tdd.scatter_parcels(dd, atm, CAP, lat_glob)
    step = tdd.make_dd_step(ctl, clim, dd, tdd.local_group(2, "cpu"), CAP,
                            EXCH_CAP, lat_glob)
    local = block_numpy(*run_steps(step, tiles, a, c))
    jax_out = _jax_two_devices(metdir)

    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=300), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for (out, err), rc in outs:
        assert rc == 0, out + err[-3000:]
        assert "OK rank=" in out, out + err[-3000:]
    ranks = [dict(np.load(os.path.join(metdir, f"rank{r}.npz")))
             for r in range(2)]
    return ranks, local, jax_out


def test_two_gloo_ranks_equal_the_local_group(gloo_run):
    """The ranks' blocks, side by side, are the local group's state bit
    for bit: every column, counts, counters, overflow and lost."""
    ranks, local, _ = gloo_run
    for k, v in local.items():
        joined = np.concatenate([r[k] for r in ranks], axis=-1)
        np.testing.assert_array_equal(joined, v, err_msg=k)
    assert int(local["np"].sum()) == N


def test_two_gloo_ranks_match_jax(gloo_run):
    """The same blocks against the JAX package's 2-device run at rtol
    1e-12; counts exactly."""
    ranks, _, jax_out = gloo_run
    for k, v in jax_out.items():
        joined = np.concatenate([r[k] for r in ranks], axis=-1)
        if k in ("np", "overflow", "lost", "rng_ctr"):
            np.testing.assert_array_equal(joined, v, err_msg=k)
        else:
            np.testing.assert_allclose(joined, v, rtol=1e-12, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_process_exchange_equals_local_exchange(gloo_run, dtype):
    """The two implementations of the exchange hand each subdomain the
    same received columns bit for bit: all_to_all_single between the
    gloo ranks and the local group's transpose in one process."""
    ranks, _, _ = gloo_run
    dt = getattr(torch, dtype)
    ex = tdd._exchange_for(tdd.local_group(2, "cpu"), 2)
    buf = ex.buffer(3, 5, dt)
    for src in range(2):
        ex.send_view(buf, src).copy_(exchange_payload(src, dt))
    recv = ex.exchange(buf)
    for dst in range(2):
        want = ex.recv_cols(recv, dst).numpy()
        np.testing.assert_array_equal(ranks[dst][f"recv_{dt}"], want)
        # column k of subdomain dst: every source's slots in order
        assert want[1, 5] == 1000 + dst * 100 + 10


def test_globalize_records_the_global_shape():
    mesh = Mesh(devices=(torch.device("cpu"),), axis="sub",
                process_count=3, process_index=1)
    assert mesh.size == 3
    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, 5)], "n": 7}
    g = multihost.globalize(mesh, tree)
    assert g["a"].shape == (12,) and g["b"][0].shape == (6, 5)
    assert g["n"] == 7 and g["a"].blocks[0] is tree["a"]
    back = multihost.localize(g)
    np.testing.assert_array_equal(back["a"], np.arange(4.0))
    assert back["b"][0].shape == (2, 5)


def test_init_distributed_needs_a_device_named_or_present():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_distributed("localhost:1", 1, 0)
    with pytest.raises(NotImplementedError, match="one device"):
        multihost.init_distributed("localhost:1", 1, 0,
                                   local_devices=["cpu", "cpu"])
