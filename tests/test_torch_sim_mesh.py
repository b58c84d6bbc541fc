"""``sim.Simulation(..., mesh=)`` on the CPU, over a mesh that names the
CPU four times: the sharded run against the unsharded one, bit for bit,
through ``advance``, ``run``, the sort, the writers, checkpoints and
``run_trac``; and ``mesh=None`` left as it was."""

import os
import shutil
import threading

import pytest
import torch

from mptrac_tpu_torch import flagship, sim
from mptrac_tpu_torch.ops.sort import module_sort
from mptrac_tpu_torch.parallel import mesh as pmesh
from mptrac_tpu_torch.physics import pipeline
from mptrac_tpu_torch.types import Atm, Cache
from mptrac_tpu_torch.utils import log, timers

CPU4 = [torch.device("cpu")] * 4
#: twelve steps of 180 s
TIMES = [180.0 * i for i in range(1, 13)]


@pytest.fixture(autouse=True)
def quiet_one_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers."""
    log.set_level(0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype, fast, sort_dt, slots=1024, extra=()):
    """The flagship with convection at the tests' size; all but the last
    24 of ``slots`` slots live, so the last shard holds padding."""
    ctl, clim, met01, atm, cache = flagship.make_setup(
        slots, 36, 19, 8, extra_args=("TPU_FAST", str(fast), "SORT_DT",
                                      str(sort_dt)) + tuple(extra),
        device="cpu", dtype=dtype, phys="conv")
    return ctl, clim, met01, atm.replace(np=slots - 24), cache


def _run(setup, mesh=None, ts=TIMES, **kw):
    ctl, clim, met01, atm, cache = setup
    s = sim.Simulation(ctl, atm, clim, met=sim.FixedMet(met01), cache=cache,
                       mesh=mesh, **kw)
    s.run(write_output=False, ts=ts)
    return s


def _assert_same_state(a: Atm, c: Cache, ua: Atm, uc: Cache):
    for name in ("time", "lon", "lat", "p"):
        assert torch.equal(getattr(ua, name), getattr(a, name)), name
    for k in a.q:
        assert torch.equal(ua.q[k], a.q[k]), k
    assert torch.equal(uc.uvwp, c.uvwp) and torch.equal(uc.dt, c.dt)
    assert uc.rng_ctr == c.rng_ctr and ua.np == a.np


@pytest.mark.parametrize("dtype,fast", [(torch.float32, 2),
                                        (torch.float64, 0)],
                         ids=["float32-fast2", "float64-exact"])
def test_sharded_run_equals_unsharded_bit_for_bit(dtype, fast):
    """Twelve steps without a sort: the sharded run's state, made whole,
    is the unsharded run's bit for bit, and each of the mesh's shards
    took its own step every step."""
    setup = _setup(dtype, fast, 0)
    threads = set(threading.enumerate())
    plain = _run(setup)
    shards0 = timers.counters["shards"]
    m = pmesh.make_mesh(4, devices=CPU4)
    sharded = _run(setup, m)
    assert timers.counters["shards"] - shards0 == 4 * len(TIMES)
    assert isinstance(sharded.atm.lon, pmesh.Sharded)
    assert [b.shape[0] for b in sharded.atm.lon.blocks] == [256] * 4
    assert sharded.ctl.t_start == plain.ctl.t_start
    assert sharded.ctl.t_stop == plain.ctl.t_stop
    _assert_same_state(plain.atm, plain.cache, pmesh.unshard(sharded.atm),
                       pmesh.unshard(sharded.cache))
    assert float((plain.atm.lon - setup[3].lon).abs().max()) > 0
    if fast:
        # each shard stepped with its device's tables: the unfused path
        assert len(sharded.pack) == 4 and sharded.pack[0].packT is not None
    # run() stopped the shards' threads
    assert set(threading.enumerate()) <= threads


def sort_blocks(nshard):
    """``module_sort`` of each of ``nshard`` equal blocks of the state on
    its own: what each shard of a sharded run sorts (also used by
    ``test_torch_cuda.py``)."""
    def sort(met01, atm, cache):
        c = atm.npmax // nshard
        per_parcel = cache.iso_var.shape == cache.dt.shape
        outs = []
        for k in range(nshard):
            sl = slice(k * c, (k + 1) * c)
            a_k = Atm(time=atm.time[sl], p=atm.p[sl], lon=atm.lon[sl],
                      lat=atm.lat[sl], q={n: v[sl] for n, v in atm.q.items()},
                      np=min(max(atm.np - k * c, 0), c))
            c_k = cache.replace(
                uvwp=cache.uvwp[:, sl], dt=cache.dt[sl],
                iso_var=cache.iso_var[sl] if per_parcel else cache.iso_var)
            outs.append(module_sort(met01, a_k, c_k))

        def cat(get):
            return torch.cat([get(a, c) for a, c in outs], dim=-1)

        atm2 = atm.replace(
            time=cat(lambda a, c: a.time), p=cat(lambda a, c: a.p),
            lon=cat(lambda a, c: a.lon), lat=cat(lambda a, c: a.lat),
            q={n: cat(lambda a, c, n=n: a.q[n]) for n in atm.q})
        cache2 = outs[0][1].replace(
            uvwp=cat(lambda a, c: c.uvwp), dt=cat(lambda a, c: c.dt),
            iso_var=(cat(lambda a, c: c.iso_var) if per_parcel
                     else cache.iso_var))
        return atm2, cache2
    return sort


def test_sharded_run_with_sorts_equals_blockwise_sorted_run(monkeypatch):
    """``SORT_DT 1800`` on the fused path (K1's plain version here):
    every shard sorts its own parcels, as MPTRAC's ranks do, and the run
    equals an unsharded run whose sort sorts each shard's block alone,
    bit for bit."""
    setup = _setup(torch.float32, 2, 1800)
    m = pmesh.make_mesh(4, devices=CPU4)
    sharded = _run(setup, m)
    assert sharded.nsorts == 1 and sharded.pack[0].cell is not None
    with monkeypatch.context() as mp:
        mp.setattr(sim, "module_sort", sort_blocks(4))
        plain = _run(setup)
    assert plain.nsorts == 1
    _assert_same_state(plain.atm, plain.cache, pmesh.unshard(sharded.atm),
                       pmesh.unshard(sharded.cache))
    # a whole sort orders the parcels otherwise
    whole = _run(setup)
    assert not torch.equal(whole.atm.lon, plain.atm.lon)


def test_particle_file_and_checkpoint_equal_unsharded(tmp_path):
    """The writers and the checkpoint gather the sharded state: the files
    equal the unsharded run's byte for byte, and a sharded run resumed
    from the checkpoint continues as the unsharded one does."""
    extra = ("ATM_BASENAME", "atm", "ATM_DT_OUT", "720", "ATM_TYPE_OUT",
             "0")
    setup = _setup(torch.float64, 0, 0, slots=256, extra=extra)
    ctl, clim, met01, atm, cache = setup
    files = {}
    for tag, m in (("plain", None),
                   ("sharded", pmesh.make_mesh(4, devices=CPU4))):
        d = tmp_path / tag
        d.mkdir()
        s = sim.Simulation(ctl, atm, clim, dirname=str(d),
                           checkpoint_file=str(d / "ckpt.npz"),
                           checkpoint_dt=1080.0, met=sim.FixedMet(met01),
                           cache=cache, mesh=m)
        s.run(write_output=True, ts=TIMES[:8])
        files[tag] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert sorted(files["plain"]) == ["atm_2000_01_01_00_12_00.tab",
                                      "atm_2000_01_01_00_24_00.tab",
                                      "ckpt.npz"]
    assert files["sharded"] == files["plain"]

    def resumed(m):
        s = sim.Simulation(ctl, atm, clim, met=sim.FixedMet(met01),
                           mesh=m).resume(str(tmp_path / "plain"
                                              / "ckpt.npz"))
        s.run(write_output=False, ts=TIMES[6:9])
        return s

    plain = resumed(None)
    sharded = resumed(pmesh.make_mesh(4, devices=CPU4))
    _assert_same_state(plain.atm, plain.cache, pmesh.unshard(sharded.atm),
                       pmesh.unshard(sharded.cache))


def test_run_trac_with_a_mesh_writes_the_same_files(tmp_path):
    """``run_trac(..., mesh=)`` from netCDF met files (``MetBuffer``: a
    read and a replica a met interval), without a sort (a sharded sort
    orders each shard alone): every file it writes equals the unsharded
    run's."""
    case = tmp_path / "case"
    case.mkdir()
    flagship.write_case(str(case), 64, (36, 19, 8), 2700.0, 4500.0, 900)
    out = {}
    for tag, m in (("plain", None),
                   ("sharded", pmesh.make_mesh(4, devices=CPU4))):
        d = tmp_path / tag
        shutil.copytree(case, d)
        before = set(os.listdir(d))
        s = sim.run_trac(str(d), "trac.ctl", "atm_in.bin", ["SORT_DT", "0"],
                         device="cpu", dtype=torch.float32, mesh=m)
        new = sorted(set(os.listdir(d)) - before)
        out[tag] = {f: (d / f).read_bytes() for f in new}
        assert len(s.met.reads) == 3
    assert out["plain"] and out["sharded"] == out["plain"]


def test_no_mesh_step_is_todays_path():
    """``mesh=None``: a step of ``advance`` dispatches the operations of
    ``pipeline.run_timestep`` alone (the same count and order of torch
    operations, which is where the card's launches come from), starts
    no thread and counts no shard."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    ctl, clim, met01, atm, cache = _setup(torch.float32, 2, 1800)
    s = sim.Simulation(ctl, atm, clim, met=sim.FixedMet(met01), cache=cache)
    s.advance(180.0, write_output=False)        # init, sort, tables
    a, c = s.atm, s.cache
    threads = threading.active_count()
    shards = timers.counters["shards"]
    with Ops() as got:
        s.advance(360.0, write_output=False)
    with Ops() as want:
        a2, c2 = pipeline.run_timestep(ctl, s.clim, met01, a, c, 360.0,
                                       s._flags(360.0), s.pack)
    assert got.ops == want.ops and len(got.ops) > 100
    assert threading.active_count() == threads
    assert timers.counters["shards"] == shards
    _assert_same_state(a2, c2, s.atm, s.cache)


def test_shards_run_on_their_threads_and_spans_name_them():
    """Traced, each step has one ``shard`` span a shard under the main
    thread's ``step``, each on its own thread, and each shard's sort a
    ``sort`` span under the sort's; the replicas and tables are made
    once."""
    setup = _setup(torch.float32, 2, 1800)
    timers.reset()
    prev = timers.tracing(True)
    try:
        _run(setup, pmesh.make_mesh(4, devices=CPU4))
        recs = timers.read()
    finally:
        timers.tracing(prev)
        timers.reset()
    names = [r["name"] for r in recs]
    assert names.count("met.replicate") == 1
    assert names.count("pack.build") == 1
    shard = [r for r in recs if r["name"] == "shard"]
    assert len(shard) == 4 * len(TIMES)
    main = {r["thread"] for r in recs if r["name"] == "advance"}
    assert len(main) == 1
    for r in shard:
        parent = recs[r["parent"]]
        assert parent["name"] == "step" and parent["step"] == r["step"]
        assert r["thread"] not in main and r["device"] is None
    assert len({r["thread"] for r in shard}) == 4
    sorts = [r for r in recs if r["name"] == "sort"
             and r["thread"] not in main]
    assert len(sorts) == 4
    assert all(recs[r["parent"]]["name"] == "sort" for r in sorts)
    # the sort's own stages nest under each shard's sort
    keys = [r for r in recs if r["name"] == "sort.key"]
    assert len(keys) == 4 and all(recs[r["parent"]] in sorts for r in keys)


def test_a_shards_failure_reaches_the_caller():
    """A shard that raises: the step raises its error, and the next step
    runs on the same threads."""
    setup = _setup(torch.float64, 0, 0, slots=128)
    ctl, clim, met01, atm, cache = setup
    m = pmesh.make_mesh(4, devices=CPU4)
    s = sim.Simulation(ctl, atm, clim, met=sim.FixedMet(met01), cache=cache,
                       mesh=m)
    try:
        s.advance(180.0, write_output=False)
        assert s._sharded.map(lambda k: k) == [0, 1, 2, 3]

        def fail(k):
            if k == 2:
                raise KeyError("shard 2")
            return k

        with pytest.raises(KeyError, match="shard 2"):
            s._sharded.map(fail)
        s.advance(360.0, write_output=False)
    finally:
        s.close()
    plain = _run(setup, ts=TIMES[:2])
    _assert_same_state(plain.atm, plain.cache, pmesh.unshard(s.atm),
                       pmesh.unshard(s.cache))


def test_shard_threads_hand_back_every_round_under_stress():
    """More shard threads than cores, a short switch interval and many
    rounds of ``map``: every round returns each shard's own result, in
    mesh order (a result written to another round's slot would break
    this)."""
    import sys
    n, rounds = 16, 300
    threads = set(threading.enumerate())
    step = pmesh.make_sharded_step(
        _setup(torch.float64, 0, 0, slots=64)[0], None,
        pmesh.make_mesh(n, devices=[torch.device("cpu")] * n))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for r in range(rounds):
            assert step.map(lambda k, r=r: (r, k)) == [(r, k)
                                                      for k in range(n)]
    finally:
        sys.setswitchinterval(interval)
        step.close()
    assert set(threading.enumerate()) <= threads


def test_an_unclosed_step_stops_its_threads_when_collected():
    """A sharded step dropped without ``close`` stops its threads once
    it is collected (they hold nothing of it)."""
    import gc
    import time
    threads = set(threading.enumerate())
    step = pmesh.make_sharded_step(_setup(torch.float64, 0, 0,
                                          slots=64)[0], None,
                                   pmesh.make_mesh(4, devices=CPU4))
    assert step.map(lambda k: k) == [0, 1, 2, 3]
    started = set(threading.enumerate()) - threads
    assert len(started) == 4
    del step
    gc.collect()
    deadline = time.monotonic() + 60
    while any(th.is_alive() for th in started) and (
            time.monotonic() < deadline):
        time.sleep(0.01)
    assert not any(th.is_alive() for th in started)


def test_step_self_time_leaves_out_the_shards_threads():
    """The main thread's ``step`` span waits while its ``shard`` children
    run on four threads at once: its self time is its own thread's, not
    its time less four children's."""
    setup = _setup(torch.float32, 2, 0, slots=256)
    timers.reset()
    prev = timers.tracing(True)
    try:
        _run(setup, pmesh.make_mesh(4, devices=CPU4), ts=TIMES[:3])
        recs = timers.read()
    finally:
        timers.tracing(prev)
        timers.reset()
    for i, r in enumerate(recs):
        if r["name"] == "step":
            own = [c for c in recs if c["parent"] == i
                   and c["thread"] == r["thread"]]
            assert r["self_ms"] == pytest.approx(
                r["ms"] - sum(c["ms"] for c in own), abs=1e-9)
            assert r["self_ms"] >= 0
