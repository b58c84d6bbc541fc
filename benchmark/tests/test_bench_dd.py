"""The domain-decomposed cell ``dd.mem`` on the CPU at a tiny size: the
driver ``dd`` and the reference ``dd`` run a period with ``correct``
true, the traced run reads the span metrics, the checks catch a
migration that loses a parcel or leaves one in another subdomain's
block, and a program without the decomposed run is refused at once."""

import contextlib

import numpy as np
import pytest
import torch

from benchmark import checks, control, dd_spans, harness, manifest
from benchmark.tests.conftest import TINY

CELL = "dd.mem"


def test_cell_reads_correct_and_its_span_metrics():
    from mptrac_tpu_torch.utils import timers
    out = harness.run(CELL, 2 ** 31 + 4717, 0.2, False, device="cpu",
                      sizes=TINY)
    assert out["correct"], out["checks"]
    # the sort and the ten migrations of the checked period
    assert out["window"]["sorts_checked"] == 11
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
    # (the roofline reads the card's trace: none on the CPU)
    assert set(m) == {"dd_step_ms", "dd_physics_ms", "dd_migrate_ms"}
    assert m["dd_step_ms"] > m["dd_physics_ms"] > 0
    assert m["dd_step_ms"] > m["dd_migrate_ms"] > 0


def test_control_fails_the_limits():
    limits = manifest.workload(CELL)["limits"]
    for rec in control.readings(CELL, [5], 0.1, device="cpu", sizes=TINY):
        assert rec["correct"], rec["program"]
        assert any(v > limits[k] for k, v in rec["control"].items()), \
            rec["control"]


def _fault(monkeypatch, broken):
    """Run the cell with each decomposed step's result passed through
    ``broken(atm, cache, cap)``."""
    from mptrac_tpu_torch.parallel import dd as ddm
    real = ddm.make_dd_step

    def make(ctl, clim, grid, group, cap, *a, **kw):
        step = real(ctl, clim, grid, group, cap, *a, **kw)

        def faulty(tiles, atm, cache, t, flags=None):
            a2, c2, ovf, lost = step(tiles, atm, cache, t, flags)
            broken(a2, c2, cap)
            return a2, c2, ovf, lost
        return faulty

    monkeypatch.setattr(ddm, "make_dd_step", make)
    return harness.run(CELL, 11, 0.1, False, device="cpu", sizes=TINY)


def test_a_lost_parcel_fails(monkeypatch):
    def drop_last(atm, cache, cap):
        atm.np[0] -= 1

    out = _fault(monkeypatch, drop_last)
    assert not out["correct"] and out["checks"]["sort_bad"]["value"] > 0


def test_a_parcel_in_another_block_fails(monkeypatch):
    """Two parcels traded between the blocks of subdomains 0 and 7 keep
    every count and the hash; each now sits in a block its position does
    not name."""
    def trade(atm, cache, cap):
        a, b = 0, 7 * cap
        for col in [atm.time, atm.lon, atm.lat, atm.p, *atm.q.values(),
                    *cache.uvwp]:
            col[[a, b]] = col[[b, a]].clone()

    out = _fault(monkeypatch, trade)
    assert not out["correct"] and out["checks"]["sort_bad"]["value"] > 0


def test_driver_refuses_a_program_without_the_decomposed_run(monkeypatch):
    """The parent of the decomposed run ignores ``DD 1``: its ``sim``
    module has no ``DDRun``, and the driver refuses it before building
    anything; a Simulation that holds no decomposed state is refused
    after construction."""
    from mptrac_tpu_torch import sim

    class NoDD:
        def __init__(self, ctl, atm, clim=None, *, met=None, cache=None,
                     dtype=None, mesh=None):
            raise AssertionError("built")

    with monkeypatch.context() as m:
        m.setattr(sim, "Simulation", NoDD)
        m.delattr(sim, "DDRun")
        with pytest.raises(manifest.RunError, match="no domain"):
            harness.run(CELL, 1, 0.1, False, device="cpu", sizes=TINY)

    class Plain:
        dd = None

        def __init__(self, ctl, atm, clim=None, *, met=None, cache=None,
                     dtype=None):
            pass

    monkeypatch.setattr(sim, "Simulation", Plain)
    with pytest.raises(manifest.RunError, match="no decomposed state"):
        harness.run(CELL, 1, 0.1, False, device="cpu", sizes=TINY)


def test_take_finds_the_slots_by_index():
    wl = manifest.workload(CELL)
    cfg = dict(manifest.config(wl["config"]), **TINY)
    gen = manifest.met_generator(cfg)
    snaps = gen.snapshots(cfg["grid"], cfg["met"],
                          (0.0, float(wl["met"]["dt_met"])))
    args = harness.build_ctl_args(cfg, wl, None, gen.CTL)
    drv = manifest.driver(wl).Driver(cfg, wl, args, snaps, 3,
                                     torch.device("cpu"))
    try:
        for i in range(3):
            drv.step(180.0 * i)
        hashes = []
        drv.hook_sort(contextlib.nullcontext, hashes)
        drv.step(540.0)
        assert len(hashes) == 1 and hashes[0][0] == hashes[0][1]
        assert hashes[0][2]
        slots = np.array([0, 17, 4095])
        state, ctr = drv.take(slots)
        np.testing.assert_array_equal(state["m"].numpy(), slots)
        assert ctr == [0] * 8                    # nothing draws
        whole = drv.sim.parcels()
        order = torch.argsort(whole.q["idx"])[slots]
        for k in ("lon", "lat", "p", "time"):
            assert torch.equal(state[k], getattr(whole, k)[order].double())
    finally:
        drv.close()


def test_span_readers():
    """The steady steps are those with a ``dd.step`` and no sort; the
    migration's gather launches are the stamped ones inside its spans."""
    def rec(name, step, t0, t1, ms):
        return dict(name=name, step=step, t0_ns=t0, t1_ns=t1, ms=ms,
                    device_ms=ms, parent=None)

    recs = [rec("dd.step", 1, 0, 100, 10.0), rec("dd.physics", 1, 0, 50, 6.0),
            rec("dd.migrate", 1, 50, 80, 2.0), rec("dd.receive", 1, 80, 100,
                                                   1.0),
            rec("dd.step", 2, 200, 300, 30.0), rec("sort", 2, 150, 199, 5.0)]
    assert dd_spans.steady_steps(recs) == {1}
    assert dd_spans.ms_per_step(recs, ("dd.step",)) == 10.0
    assert dd_spans.ms_per_step(recs, ("dd.migrate", "dd.receive")) == 3.0
    stamps = [("gather_kernel", 60), ("gather_kernel", 170),
              ("gather_kernel", 90)]
    events = [("gather_kernel", 1000.0, 1002.0),
              ("gather_kernel", 1100.0, 1110.0),
              ("gather_kernel", 1200.0, 1201.0)]
    assert dd_spans.migration_gather_s(events, recs, stamps) == \
        pytest.approx(1.2e-5)
    assert dd_spans.migration_gather_s(events[:2], recs, stamps) is None
    assert dd_spans.selected([{"name": "dd_selected", "n": 5, "step": 1},
                              {"name": "shards", "n": 9, "step": 1}]) == 5


def test_cell_metrics_of_the_new_cell():
    bench = manifest.load_manifest()
    e2e = [m["name"] for m in manifest.cell_metrics(bench, CELL, False)]
    assert e2e == ["parcel_steps_per_s", "peak_mem_GB", "setup_s"]
    layer = {m["name"] for m in manifest.cell_metrics(bench, CELL, True)}
    assert layer == {"dd_step_ms", "dd_physics_ms", "dd_migrate_ms",
                     "dd_select_roofline_pct"}
    assert checks.unmodelled(manifest.config("dd"),
                             manifest.reference({"reference": "dd"})) == []
