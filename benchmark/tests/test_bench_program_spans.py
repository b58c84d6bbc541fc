"""The readers of the program's own spans (``program_spans.py``): a traced
run at a tiny size on the CPU, and a synthetic timeline whose clock
offset is known."""

import pytest

from benchmark import manifest, program_spans
from benchmark.tests.conftest import TINY

#: trace time less host time of the synthetic timeline [us]
OFF = 7_654_321.0


def _rec(name, parent, t0_us, t1_us, step=0, thread=1, device_ms=None):
    ms = 1e-3 * (t1_us - t0_us)
    return dict(name=name, parent=parent, step=step, thread=thread,
                t0_ns=int(1e3 * t0_us), t1_ns=int(1e3 * t1_us), ms=ms,
                device_ms=device_ms, self_ms=ms, self_device_ms=device_ms)


def _timeline():
    """One step on the host clock [us]: the met read from 10 to 60 ms
    (its netCDF read 10-30 ms), the step from 62 to 99.9 ms; the device
    busy 0.505-9 ms, 60.2-60.3 ms (a copy) and from 61.55 ms on."""
    recs = [_rec("advance", None, 0, 100_000),
            _rec("met.get", 0, 1_000, 61_000),
            _rec("met.read", 1, 10_000, 60_000),
            _rec("read_nc", 2, 10_000, 30_000),
            _rec("step", 0, 62_000, 99_900),
            _rec("rng", 4, 62_100, 70_000, device_ms=4.0),
            _rec("interp", 4, 70_000, 71_000, device_ms=1.5),
            _rec("rng", None, 99_950, 99_990, device_ms=100.0)]
    dev = [("void rk_kernel(RkParams)", 505, 9_000),
           ("Memcpy HtoD (Pageable -> Device)", 60_200, 60_300),
           ("void rk_kernel(RkParams)", 61_550, 99_000),
           ("void sfc_kernel(float const*)", 99_000, 99_500)]
    events = [(n, a + OFF, b + OFF) for n, a, b in dev]
    # a launch's stamp precedes its start on the device: the least gap is
    # the first launch's, 0 here, so the offset is OFF
    stamps = [("rk_kernel", 505_000), ("rk_kernel", 61_500_000),
              ("sfc_kernel", 98_990_000)]
    return events, recs, stamps


def test_idle_in_read_on_a_known_timeline():
    events, recs, stamps = _timeline()
    assert program_spans.clock_offset_us(events, stamps) == pytest.approx(
        OFF)
    by = program_spans.idle_by_span(events, recs, stamps)
    # idle 9-60.2 ms and 60.3-61.55 ms
    assert by == pytest.approx({"met.get": 1.9e-3, "met.read/read_nc": 0.02,
                                "met.read/met.read": 0.03,
                                "advance": 0.55e-3})
    assert program_spans.idle_in_read_pct(
        events, recs, stamps) == pytest.approx(100 * 0.05 / 0.05245)
    # gaps outside every span read "none"
    by = program_spans.idle_by_span(
        events, [_rec("met.get", None, 1_000, 61_000)], stamps)
    assert by == pytest.approx({"met.get": 0.0519, "none": 0.55e-3})


def test_idle_in_read_reads_none_without_matching_launches():
    events, recs, stamps = _timeline()
    assert program_spans.idle_in_read_pct(events[:-1], recs, stamps) is None
    assert program_spans.idle_in_read_pct(events, recs, []) is None
    assert program_spans.idle_in_read_pct(events, [], stamps) is None
    assert program_spans.idle_in_read_pct([], recs, stamps) is None


def test_ms_per_step_counts_the_steps_spans():
    _, recs, _ = _timeline()
    assert program_spans.ms_per_step(recs, "rng") == 4.0
    assert program_spans.ms_per_step(recs, "interp") == 1.5
    assert program_spans.ms_per_step(recs, "sedi") == 0.0
    assert program_spans.ms_per_step(recs[:4], "rng") is None
    assert program_spans.ms_per_step(None, "rng") is None


def test_traced_tiny_run_reads_rng_and_interp():
    """A ``--trace 1`` run of ``base.mem`` on the CPU at the tests' size:
    the program's spans give ``rng_ms`` and ``interp_plain_ms`` (host ms
    on the CPU); the device readers read nothing there."""
    from benchmark import harness
    from mptrac_tpu_torch.utils import timers
    timers.reset()
    try:
        out = harness.run("base.mem", 2 ** 31 + 4321, 0.2, True,
                          device="cpu", sizes=TINY)
    finally:
        recs = program_spans.records()
        timers.reset()
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["rng_ms"] > 0 and "k1_roofline_pct" not in m
    assert 0 < m["rng_ms"] < m["rng_diffusion_ms"]
    # interp_plain_ms is listed for base.mem: the turbulent diffusion and
    # the decay interpolate on the plain path
    assert m["interp_plain_ms"] > 0
    assert 0 < program_spans.ms_per_step(recs, "interp") < m["step_ms"]
    names = {r["name"] for r in recs}
    assert {"advance", "step", "sort", "rng", "interp"} <= names
    reader = manifest.metric_reader("idle_in_read_pct")
    assert reader.read(type("C", (), {"trace": None})) is None
