"""The port's tracer (``mptrac_tpu_torch.utils.timers``) on the CPU:
spans and counters, the switch that follows ``torch.profiler``, and the
met read's stages and timings."""

import threading

import pytest
import torch

from mptrac_tpu_torch import flagship, sim
from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.utils import log, timers


@pytest.fixture(autouse=True)
def clean_tracer():
    log.set_level(0)
    timers.reset()
    prev = timers.tracing(None)
    yield
    timers.tracing(prev)
    timers.reset()


def _flagship_sim(phys="base", n=512):
    ctl, clim, met01, atm, cache = flagship.make_setup(
        n, 36, 19, 8, extra_args=("TPU_FAST", "2", "SORT_DT", "360"),
        device="cpu", dtype=torch.float32, phys=phys)
    return sim.Simulation(ctl, atm, clim, met=sim.FixedMet(met01),
                          cache=cache)


STEPS = [180.0 * i for i in range(1, 5)]


def _names(recs, i):
    """Names of record ``i`` and of its ancestors, innermost first."""
    out = []
    while i is not None:
        out.append(recs[i]["name"])
        i = recs[i]["parent"]
    return out


def test_tracing_off_records_nothing(monkeypatch):
    """Without a profiler a run creates no record, no event and no
    stamp; a span's enter gives None."""
    def no_event(*a, **k):
        raise AssertionError("an event was created with tracing off")

    monkeypatch.setattr(timers, "_event", no_event)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not timers.enabled()
    s = _flagship_sim()
    s.run(write_output=False, ts=STEPS)
    _cuda.launch("sfc_interp")
    assert timers.read() == [] and timers.launch_stamps() == []
    with timers.span("advance") as rec:
        assert rec is None
    assert timers.read() == []
    table = s.timers.as_dict()
    assert table["RUN_TIMESTEP"]["count"] == len(STEPS)
    assert "device" not in table["RUN_TIMESTEP"]
    assert "self" not in table["RUN_TIMESTEP"]


def test_profiled_run_records_nested_spans():
    """Under ``torch.profiler.profile()`` a run records the driver's and
    the modules' spans, nested, each with its step index, and the TIMER
    table adds their self time."""
    s = _flagship_sim("chem")
    with torch.profiler.profile():
        assert timers.enabled()
        s.run(write_output=False, ts=STEPS)
    assert not timers.enabled()
    recs = timers.read()
    names = {r["name"] for r in recs}
    assert {"advance", "met.get", "pack.build", "sort", "sort.key",
            "sort.argsort", "sort.plan", "sort.permute", "step",
            "timesteps", "position", "advect", "diff_turb", "diff_meso",
            "convection", "meteo", "decay", "oh_chem", "h2o2_chem",
            "wet_depo", "dry_depo", "rng", "interp"} <= names
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["advance"] * len(STEPS)
    assert len({r["step"] for r in roots}) == len(STEPS)
    for i, r in enumerate(recs):
        up = _names(recs, i)
        assert up[-1] == "advance"
        # a span's step is its root's
        j = i
        while recs[j]["parent"] is not None:
            j = recs[j]["parent"]
        assert r["step"] == recs[j]["step"]
        assert r["t0_ns"] <= r["t1_ns"] and r["device_ms"] is None
        assert r["self_ms"] <= r["ms"] + 1e-9
        # only the outermost interpolation and draw are recorded
        assert up.count("interp") <= 1 and up.count("rng") <= 1
        if r["name"] in ("rng", "diff_turb", "oh_chem"):
            assert "step" in up
        if r["name"].startswith("sort."):
            assert up[1] == "sort"
    for i, r in enumerate(recs):
        kids = [c for c in recs if c["parent"] == i]
        assert r["self_ms"] == pytest.approx(
            r["ms"] - sum(c["ms"] for c in kids), abs=1e-9)
        for c in kids:
            assert r["t0_ns"] <= c["t0_ns"] <= c["t1_ns"] <= r["t1_ns"]
    table = s.timers.as_dict()
    assert table["RUN_TIMESTEP"]["count"] == len(STEPS)
    assert table["MODULE_SORT"]["count"] == 2
    assert 0.0 < table["RUN_TIMESTEP"]["self"] < table["RUN_TIMESTEP"][
        "total"]
    lines = []
    s.timers.report(log=lines.append)
    assert any(line.startswith("TIMER_RUN_TIMESTEP") and "self=" in line
               for line in lines)


def test_counters_back_launch_counts():
    """``_cuda.launch_counts`` is the tracer's counter dict; a launch is
    counted always and stamped with its device function while
    tracing."""
    assert _cuda.launch_counts is timers.counters
    assert set(_cuda.launch_counts) == set(_cuda.DEVICE_FUNCTIONS) | set(
        timers.COUNTERS)
    before = dict(_cuda.launch_counts)
    _cuda.launch("rk_fused_advect")
    assert timers.launch_stamps() == []
    timers.tracing(True)
    _cuda.launch("permute_count")
    timers.count("rk_fused_advect", 2)
    stamps = timers.launch_stamps()
    assert [k for k, _ in stamps] == ["count_kernel"]
    assert _cuda.launch_counts["rk_fused_advect"] == before[
        "rk_fused_advect"] + 3
    assert _cuda.launch_counts["permute_count"] == before[
        "permute_count"] + 1
    _cuda.reset_launch_counts()
    assert not any(_cuda.launch_counts.values())


def test_threads_keep_their_own_stacks():
    """Spans opened on two threads at once nest within their thread."""
    timers.tracing(True)
    barrier = threading.Barrier(2)

    def work(tag):
        with timers.span("outer." + tag):
            barrier.wait()
            with timers.span("inner." + tag):
                barrier.wait()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    recs = timers.read()
    assert len(recs) == 4
    for r in recs:
        tag = r["name"][-1]
        if r["name"].startswith("inner"):
            parent = recs[r["parent"]]
            assert parent["name"] == "outer." + tag
            assert parent["thread"] == r["thread"]
        else:
            assert r["parent"] is None
    assert len({r["thread"] for r in recs}) == 2


def test_tracing_false_wins_over_a_profiler():
    s = _flagship_sim()
    timers.tracing(False)
    with torch.profiler.profile():
        assert not timers.enabled()
        s.run(write_output=False, ts=STEPS[:2])
    assert timers.read() == []
    timers.tracing(None)
    with torch.profiler.profile():
        s.run(write_output=False, ts=STEPS[2:3])
    assert {r["name"] for r in timers.read()} >= {"advance", "step"}


def test_span_as_decorator_and_outermost():
    timers.tracing(True)

    @timers.span("test.outer_only", outermost=True)
    def f(k):
        return k if k == 0 else f(k - 1) + 1

    assert f(3) == 3
    recs = timers.read()
    assert [r["name"] for r in recs] == ["test.outer_only"]
    timers.tracing(False)
    assert f(2) == 2 and len(timers.read()) == 1


def test_met_read_spans_and_keys(tmp_path):
    """A run from netCDF files: ``MetBuffer.reads`` keeps its keys, with
    tracing off and on; traced, each file read is a ``met.read`` span over
    ``read_nc``, ``preprocess`` (its ``process.*`` stages) and
    ``upload``, and the pair's update is ``met.shift``."""
    d = str(tmp_path)
    flagship.write_case(d, 64, (36, 19, 8), 2700.0, 4500.0, 900)
    keys = {"file", "route", "wait", "read", "preprocess", "upload"}
    plain = sim.run_trac(d, "trac.ctl", "atm_in.bin", device="cpu",
                         dtype=torch.float32)
    assert [set(r) for r in plain.met.reads] == [keys] * 3
    assert timers.read() == []
    timers.tracing(True)
    traced = sim.run_trac(d, "trac.ctl", "atm_in.bin", device="cpu",
                          dtype=torch.float32)
    timers.tracing(None)
    assert [set(r) for r in traced.met.reads] == [keys] * 3
    recs = timers.read()
    reads = [i for i, r in enumerate(recs) if r["name"] == "met.read"]
    assert len(reads) == 3
    for i in reads:
        assert _names(recs, i)[1:] == ["met.get", "advance"]
        kids = [r["name"] for r in recs if r["parent"] == i]
        assert kids == ["read_nc", "preprocess", "upload"]
        pre = [j for j, r in enumerate(recs)
               if r["parent"] == i and r["name"] == "preprocess"][0]
        stages = [r["name"] for r in recs if r["parent"] == pre]
        assert stages[:3] == ["process.extrapolate", "process.polar_winds",
                              "process.periodic"]
        assert {"process.geopot", "process.pv", "process.tropopause",
                "process.cloud"} <= set(stages)
    assert sum(r["name"] == "met.shift" for r in recs) == 1
    assert any(r["name"] == "read_atm" and r["parent"] is None
               for r in recs)
    # the timings are the spans' host seconds
    for rd, i in zip(traced.met.reads, reads):
        kid = {r["name"]: r for r in recs if r["parent"] == i}
        assert rd["read"] == pytest.approx(1e-3 * kid["read_nc"]["ms"],
                                           rel=0.05, abs=2e-4)
        assert rd["upload"] == pytest.approx(1e-3 * kid["upload"]["ms"],
                                             rel=0.05, abs=2e-4)
    table = traced.timers.as_dict()
    assert table["READ_ATM"]["count"] == 1
    assert table["RUN_TIMESTEP"]["count"] == plain.timers.as_dict()[
        "RUN_TIMESTEP"]["count"]


def test_records_name_their_card_and_adopted_parent(monkeypatch):
    """While tracing, a record carries the index of the CUDA device
    current on its thread (None before CUDA is initialised), and a span
    opened on a worker thread under ``adopt`` takes the handed-out span
    as its parent; off, ``innermost`` gives None and nothing is
    recorded."""
    with timers.span("off") as rec:
        assert rec is None and timers.innermost() is None
    timers.tracing(True)
    with timers.span("host") as host:
        assert timers.innermost() is host
    assert timers.read()[0]["device"] is None
    timers.reset()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(timers, "_event", lambda: None)
    with timers.span("step") as parent:
        def work():
            with timers.adopt(parent):
                with timers.span("shard"):
                    with timers.span("inner"):
                        pass
            with timers.span("alone"):
                pass

        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
    assert not th.is_alive()
    recs = {r["name"]: r for r in timers.read()}
    assert all(r["device"] == 3 for r in recs.values())
    names = [r["name"] for r in timers.read()]
    assert names[recs["shard"]["parent"]] == "step"
    assert names[recs["inner"]["parent"]] == "shard"
    assert recs["alone"]["parent"] is None
    assert recs["shard"]["thread"] != recs["step"]["thread"]


def test_counters_count_every_thread_under_stress():
    """More counting threads than cores and a short switch interval: no
    count is lost (the shards' threads count launches at once)."""
    import sys
    n, rounds = 16, 2000
    before = timers.counters["shards"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            timers.count("shards") for _ in range(rounds)])
            for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert timers.counters["shards"] - before == n * rounds
