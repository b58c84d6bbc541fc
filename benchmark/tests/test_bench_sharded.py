"""The four-card cell ``base4.mem`` on the CPU at a tiny size, its mesh
naming the CPU four times: the driver ``sharded``, its checks, its
control, its sort hashes and the readers of its spans."""

import contextlib

import pytest
import torch

from benchmark import (checks, control, harness, inputs, manifest,
                       sharded_spans)
from benchmark.tests.conftest import TINY

CELL = "base4.mem"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Four shard threads on small shapes: more intra-op threads would
    only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_reads_correct_and_its_span_metrics():
    """An untraced and a traced run at the tests' size: both correct,
    every sort of the checked period hashed, and the traced run reads
    ``shard_step_max_ms`` and ``dispatch_ms`` (host ms on the CPU)."""
    from mptrac_tpu_torch.utils import timers
    out = harness.run(CELL, 2 ** 31 + 4717, 0.2, False, device="cpu",
                      sizes=TINY)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert out["window"]["sorts_checked"] == 1
    assert set(out["metrics"]) == {"parcel_steps_per_s", "peak_mem_GB",
                                   "setup_s"}
    timers.reset()
    try:
        traced = harness.run(CELL, 2 ** 31 + 4718, 0.2, True, device="cpu",
                             sizes=TINY)
    finally:
        timers.reset()
    assert traced["correct"], traced["checks"]
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert set(m) == {"shard_step_max_ms", "dispatch_ms"}
    assert m["shard_step_max_ms"] > 0 and m["dispatch_ms"] > 0


def test_control_fails_the_limits():
    limits = manifest.workload(CELL)["limits"]
    for rec in control.readings(CELL, [5, 2 ** 31 + 6], 0.1, device="cpu",
                                sizes=TINY):
        assert rec["correct"], rec["program"]
        assert any(v > limits[k] for k, v in rec["control"].items()), \
            rec["control"]


def _driver(seed=2 ** 31 + 3):
    wl = manifest.workload(CELL)
    cfg = dict(manifest.config(wl["config"]), **TINY)
    gen = manifest.met_generator(cfg)
    snaps = gen.snapshots(cfg["grid"], cfg["met"],
                          (0.0, float(wl["met"]["dt_met"])))
    args = harness.build_ctl_args(cfg, wl, None, gen.CTL)
    return manifest.driver(wl).Driver(cfg, wl, args, snaps, seed,
                                      torch.device("cpu"))


def test_sort_hashes_are_summed_over_the_cards():
    """Around the sort of a step every card hashes its parcels; the entry
    of that sort is the sum over the cards, which is the hash of the
    whole state, the same before and after."""
    from mptrac_tpu_torch.parallel import mesh as p_mesh
    drv = _driver()
    try:
        drv.step(0.0)                           # the first sort
        hashes = []
        drv.hook_sort(contextlib.nullcontext, hashes)
        for i in range(1, 10):
            drv.step(180.0 * i)
        assert hashes == []                     # no sort in those steps
        whole = int(checks.state_hash(p_mesh.unshard(drv.sim.atm),
                                      p_mesh.unshard(drv.sim.cache)))
        cards = [int(checks.state_hash(p_mesh.atm_block(drv.sim.atm, k),
                                       p_mesh.cache_block(drv.sim.cache,
                                                          k)))
                 for k in range(4)]
        drv.step(1800.0)
        assert len(hashes) == 1
        h0, h1, same = hashes[0]
        assert h0 == sum(cards) == whole and h1 == h0 and same
        assert len(set(cards)) == 4
    finally:
        drv.close()


def test_take_gathers_the_global_slots():
    """``take`` gives the sampled global slots from the cards that hold
    them, in slot order, as ``checks.sample`` of the whole state does."""
    from mptrac_tpu_torch.parallel import mesh as p_mesh
    drv = _driver()
    try:
        drv.step(0.0)
        slots = inputs.draw_slots(TINY["n_parcels"], 300, 11, 11)
        state, ctr = drv.take(slots)
        whole = checks.sample(p_mesh.unshard(drv.sim.atm),
                              p_mesh.unshard(drv.sim.cache),
                              torch.from_numpy(slots))
        assert ctr == drv.sim.cache.rng_ctr > 0
        for k in checks.STATE_KEYS:
            assert torch.equal(state[k], whole[k]), k
    finally:
        drv.close()


def test_driver_refuses_another_dtype_and_a_program_without_a_mesh(
        monkeypatch):
    wl = manifest.workload(CELL)
    cfg = dict(manifest.config(wl["config"]), **TINY, dtype="float64")
    with pytest.raises(manifest.RunError, match="float32"):
        manifest.driver(wl).Driver(cfg, wl, [], None, 1,
                                   torch.device("cpu"))
    from mptrac_tpu_torch import sim

    class NoMesh:
        def __init__(self, ctl, atm, clim=None, *, met=None, cache=None,
                     dtype=None):
            raise AssertionError("built")

    monkeypatch.setattr(sim, "Simulation", NoMesh)
    with pytest.raises(manifest.RunError, match="no mesh"):
        harness.run(CELL, 1, 0.1, False, device="cpu", sizes=TINY)


def test_cell_metrics_of_the_new_cell():
    bench = manifest.load_manifest()
    e2e = [m["name"] for m in manifest.cell_metrics(bench, CELL, False)]
    assert e2e == ["parcel_steps_per_s", "peak_mem_GB", "setup_s"]
    per_layer = [m["name"] for m in manifest.cell_metrics(bench, CELL, True)]
    assert per_layer == ["shard_step_max_ms", "dispatch_ms"]
    w = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert w["chips"] == 4 and len(w["why"]) <= 200
    assert manifest.workload(CELL)["driver"] == "sharded"
    cfg = manifest.config("base4")
    base = manifest.config("base")
    assert cfg["n_parcels"] == 4 * base["n_parcels"]
    assert {k: v for k, v in cfg.items() if k not in (
        "n_parcels", "source", "assumed", "name")} == {
        k: v for k, v in base.items() if k not in (
            "n_parcels", "source", "assumed", "name")}
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200


def _rec(name, step, ms, device_ms=None, device=None, thread=1):
    return {"name": name, "step": step, "ms": ms, "device_ms": device_ms,
            "device": device, "thread": thread, "parent": None}


def test_span_readers_take_the_steady_steps():
    """Steps with a sort or a met replica are left out; each card's mean
    is over its own ``shard`` spans; the slowest card is read."""
    recs = []
    for step, extra in ((0, "met.replicate"), (1, None), (2, "sort"),
                        (3, None)):
        recs.append(_rec("step", step, 10.0 + step))
        if extra:
            recs.append(_rec(extra, step, 1.0))
        for card in range(4):
            recs.append(_rec("shard", step, 0.5, 100.0 + card + step,
                             device=card, thread=10 + card))
    assert sharded_spans.steady_steps(recs) == {1, 3}
    assert sharded_spans.shard_step_max_ms(recs) == pytest.approx(105.0)
    assert sharded_spans.dispatch_ms(recs) == pytest.approx(12.0)
    # a run of one card, or a program without the spans: nothing to read
    plain = [r for r in recs if r["name"] != "shard"]
    assert sharded_spans.shard_step_max_ms(plain) is None
    assert sharded_spans.dispatch_ms(plain) is None
    assert sharded_spans.dispatch_ms(None) is None
    from mptrac_tpu_torch.utils import timers
    timers.reset()
    for name in ("shard_step_max_ms", "dispatch_ms"):
        assert manifest.metric_reader(name).read(None) is None
