"""One run of one cell: set-up, warm-up, the timed window, the checks.

The cell's workload names its driver (``drivers/<name>.py``), which
builds the program's state on the cell's cards and advances it a step at
a time; its configuration names its met generator (``mets/<name>.py``)
and its reference (``references/<name>.py``).  ``manifest`` finds the
three by name.

The window holds whole periods of the cell's slowest recurring event
(``period_s``: the sort interval, or the met interval): it starts at a
period's first step and ends with the period in which ``--seconds`` run
out.  It holds the program's steps alone.  One more period follows on
the same state, with the checks: the sampled slots' state around steps
drawn from the seed, and the hash around each sort.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from benchmark import checks, inputs, manifest, tracing
from benchmark.manifest import RunError

#: top-level module names that no run may have loaded: JAX, and the JAX
#: package with its benchmark, smoke script and tools
FORBIDDEN = ("jax", "jaxlib", "flax", "mptrac_tpu", "bench", "chip_smoke",
             "parity", "perf")


#: the profiler covers the window's first whole periods up to this many
#: seconds (its events take minutes to read back over a whole window);
#: the spans cover the whole window
TRACE_S = 12.0


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _cache_dir(*parts) -> str:
    return os.path.join(manifest.HERE, "cache", *parts)


def _clim_files(cfg: dict) -> dict:
    """The configuration's climatology files: key -> absolute path."""
    return {key: os.path.join(manifest.HERE, "data", name)
            for key, name in cfg.get("clim_files", {}).items()}


def met_from_files(met_cfg: dict, gen) -> bool:
    """Whether the cell's met is a series of files of generator ``gen``
    (``source`` ``files``, or the format ``gen.FORMAT`` that it writes)
    or held in memory (``memory``); any other source is refused."""
    src = met_cfg["source"]
    if src == "memory":
        return False
    fmt = getattr(gen, "FORMAT", None)
    if src == "files" or (fmt is not None and src == fmt):
        return True
    raise RunError(f"met source {src!r}: 'memory' or 'files'"
                   + (f" (or {fmt!r}, the format of its met generator)"
                      if fmt is not None else ""))


def build_ctl_args(cfg: dict, wl: dict, met_base: Optional[str],
                   met_ctl) -> list:
    """The control parameters (``KEY VALUE``) of a cell: the
    configuration's, its climatology files made absolute, and the met
    source's (``met_base``: the base name of the met files, None for
    met in memory; ``met_ctl``: the pairs that read the generator's
    files)."""
    args = list(cfg["ctl"])
    for key, path in _clim_files(cfg).items():
        args += [key, path]
    if met_base is not None:
        args += ["METBASE", met_base, "DT_MET", str(wl["met"]["dt_met"]),
                 *met_ctl]
    else:
        args += ["METBASE", "-"]
    return args


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", sizes: Optional[dict] = None,
        t_start: Optional[float] = None, control: bool = False) -> dict:
    """Run cell ``cell`` once and return its result line (a dict).
    ``sizes`` overrides the configuration's ``n_parcels`` and ``grid``
    (the CPU tests); ``t_start`` is the process's start on
    ``time.perf_counter``'s clock.  ``control`` adds the control's
    readings (``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.load_manifest()
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    if sizes:
        cfg = dict(cfg, **sizes)
    ref = manifest.reference(cfg)
    bad = checks.unmodelled(cfg, ref)
    if bad:
        raise RunError(f"the reference {manifest.name_of('references', cfg)}"
                       f" does not model {', '.join(bad)}")
    gen = manifest.met_generator(cfg)
    files = met_from_files(wl["met"], gen)
    drv_mod = manifest.driver(wl)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < wl["chips"]:
            raise RunError(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {wl['chips']}")

    grid = cfg["grid"]
    n = int(cfg["n_parcels"])
    met_cfg = wl["met"]
    dt_met = float(met_cfg["dt_met"])
    met_base = snaps = None
    if files:
        gkey = "x".join(str(grid[k]) for k in ("nx", "ny", "nz"))
        gen_name = manifest.name_of("mets", cfg)
        if gen_name != manifest.NAMED_BY["mets"][1]:
            gkey += "_" + gen_name
        met_base = gen.series(_cache_dir("met", f"{wl['config']}_{gkey}"),
                              grid, cfg["met"], dt_met,
                              int(met_cfg["files"]))
    else:
        snaps = gen.snapshots(grid, cfg["met"], (0.0, dt_met))
    args = build_ctl_args(cfg, wl, met_base, gen.CTL)
    drv = drv_mod.Driver(cfg, wl, args, snaps, seed, dev)
    ctl = drv.ctl
    dt_mod = ctl.dt_mod
    period = int(round(float(wl["period_s"]) / dt_mod))
    t_last = (float(met_cfg["files"] - 1) * dt_met if files
              else float(ctl.t_stop))

    def t_of(i):
        return ctl.t_start + i * dt_mod

    def is_sort(t):
        return ctl.sort_dt > 0 and math.fmod(t, ctl.sort_dt) == 0

    # ---- warm-up: the cell's own steps (its sorts, its met swap)
    i = 0
    for _ in range(int(wl["warmup_steps"])):
        drv.step(t_of(i))
        i += 1
    drv.sync()

    # ---- hooks of the window: spans (traced runs), the read stages (file
    # cells) and the sort, whose state is hashed in the checked period
    hashes = []
    spans = tracing.Spans(dev) if trace else None
    stages = tracing.ReadStages() if files else None

    def label(name):
        return (torch.profiler.record_function("bench:" + name) if trace
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def around_sort():
        with label("sort"), (spans.span("sort") if spans is not None
                             else contextlib.nullcontext()):
            yield

    def step(t, k):
        if t > t_last:
            raise RunError(f"the run outran the cell's time range at t={t}"
                           " (a longer met series or T_STOP is needed)")
        swap = drv.swap_due(t)
        rec = {"i": k, "t": t, "sort": is_sort(t), "swap": swap,
               "wall_ms": None}
        timed_wall = spans is not None and swap and stages is not None
        if timed_wall:
            drv.sync()
            w0 = time.perf_counter()
        if spans is not None:
            spans.step_index = k
        with label("swap" if swap else "step"):
            drv.step(t)
        if timed_wall:
            drv.sync()
            rec["wall_ms"] = 1e3 * (time.perf_counter() - w0)
        return rec

    steps = []
    prof = trace_s = None
    drv.hook_sort(around_sort)
    if spans is not None:
        spans.wrap_all()
    if stages is not None:
        stages.wrap_all()
    reads0 = len(drv.met_reads())
    try:
        # ---- the window: whole periods of the program's steps alone
        if trace:
            prof = tracing.start_profiler()
        drv.sync()
        t_win0 = time.perf_counter()
        setup_s = t_win0 - t_start
        while True:
            for _ in range(period):
                steps.append(step(t_of(i), len(steps)))
                i += 1
            drv.sync()
            elapsed = time.perf_counter() - t_win0
            if prof is not None and trace_s is None and elapsed >= TRACE_S:
                tracing.stop_profiler(prof)
                trace_s = elapsed
            if elapsed >= float(seconds):
                break
        t_win1 = time.perf_counter()
        if prof is not None and trace_s is None:
            tracing.stop_profiler(prof)
            trace_s = t_win1 - t_win0
        window_s = t_win1 - t_win0
        mem_peak = max(drv.peak_bytes())
        if spans is not None:
            spans.restore()
            span_ms = spans.ms()
            spans = None
        else:
            span_ms = {}
        reads_window = drv.met_reads()[reads0:]
        stages_window = list(stages.reads) if stages is not None else []

        # ---- the checked period, right after the window, on the same
        # state: the sampled slots' state before and after steps without a
        # sort drawn from the seed, and the hash of every parcel around
        # each sort
        rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 7])
        free = [jj for jj in range(period) if not is_sort(t_of(i + jj))]
        checked = set(rng.choice(free, size=min(int(wl["check"]["steps"]),
                                                len(free)),
                                 replace=False).tolist())
        slots_np = inputs.draw_slots(n, int(wl["check"]["slots"]), seed, 11)
        taken = []

        def take(t):
            state, ctr = drv.take(slots_np)
            taken.append({"t_step": t, "state": state, "ctr": ctr})

        drv.hook_sort(around_sort, hashes)
        for jj in range(period):
            t = t_of(i)
            if jj in checked:
                take(t)
            step(t, -1)
            if jj in checked:
                take(t)
            i += 1
        t_checked = t_of(i - 1)
    finally:
        drv.unhook_sort()
        if spans is not None:
            spans.restore()
        if stages is not None:
            stages.restore()

    # ---- the program's met pair (file cells), then its state is freed
    hash_ok = [bool(int(a) == int(b)) and bool(same)
               for a, b, same in hashes]
    pair_fields = pair_times = None
    if files:
        pair_fields, pair_times = drv.met_pair(ref.INGESTED)
    trace_info = None
    if prof is not None:
        trace_info = (_read_trace(prof, trace_s) if dev.type == "cuda"
                      else None)
        del prof
    drv.close()
    del drv

    # ---- the checks against the reference
    # (every parcel starts at time 0: MPTRAC's run starts there too)
    rctl = dict(ref.params(args), t_start=0.0)
    rclim = ref.load_clim(_clim_files(cfg))
    slots_t = torch.from_numpy(slots_np)
    pairs = [(taken[q], taken[q + 1]) for q in range(0, len(taken), 2)]
    ingest = functools.lru_cache(maxsize=8)(ref.ingest)
    met_for = _reference_met(ref, gen, dt_met, snaps, met_base, ingest)
    step_res = checks.step_gaps(ref, pairs, rctl, met_for, rclim, n,
                                slots_t)
    ctrl_res = (checks.step_gaps(ref, pairs, rctl, met_for, rclim, n,
                                 slots_t, dtype=torch.bfloat16)
                if control else None)
    numbers = checks.combine(step_res)
    numbers["sort_bad"] = float(sum(1 for ok in hash_ok if not ok))
    ingest_res = None
    if files:
        t0 = pair_t0(t_checked, dt_met)
        exp_times = (t0, t0 + dt_met)
        expected = [ingest(gen.filename(met_base, tt)) for tt in exp_times]
        ingest_res = checks.ingest_gaps(pair_fields, pair_times, expected,
                                        exp_times)
        if control:
            low = [ref.ingest(gen.filename(met_base, tt), torch.bfloat16)
                   for tt in exp_times]
            ctrl_ingest = checks.ingest_gaps(
                {k: np.stack([s[4].get(k, s[3].get(k)) for s in low])
                 for k in pair_fields}, exp_times, expected, exp_times)
        numbers.update(ingest_res)
    # the numbers compared are those the cell has limits for
    limits = wl["limits"]
    check_out = {k: {"value": numbers[k], "limit": lim}
                 for k, lim in limits.items()}
    correct = (all(numbers[k] <= lim for k, lim in limits.items())
               and bool(pairs) and bool(hashes))
    failed = sum(1 for r in step_res
                 if any(r[k] > limits[k] for k in checks.STEP_NUMBERS
                        if k in limits))
    failed += numbers["sort_bad"]
    if ingest_res and any(v > limits[k] for k, v in ingest_res.items()):
        failed += 1

    # ---- metrics
    metrics = {}
    # (what the metric readers see; metrics_common.py and metrics/)
    ctx = SimpleNamespace(
        spans=span_ms, steps=steps, trace=trace_info, reads=reads_window,
        n=n, grid=(grid["nx"] + 1, grid["ny"], grid["nz"]),
        cols32=9, cols64=1, advect_stages=int(ctl.advect),
        roofline=manifest.roofline)
    if trace:
        for m in manifest.cell_metrics(bench, cell, True):
            val = manifest.metric_reader(m["name"]).read(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        rate = n * len(steps) / window_s
        e2e = {"parcel_steps_per_s": rate, "parcel_steps_per_s.nc": rate,
               "peak_mem_GB": mem_peak / 1e9, "setup_s": setup_s}
        for m in manifest.cell_metrics(bench, cell, False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": wl["chips"], "memory_peak_bytes": int(mem_peak)}
    out = {"correct": bool(correct), "attempted": len(steps),
           "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace_info is not None:
        dev_info["busy_s"] = trace_info.busy_s
        dev_info["window_s"] = trace_info.window_s
        out["breakdown"] = trace_info.breakdown
    out["window"] = {"seconds": window_s, "steps": len(steps),
                     "periods": len(steps) // period,
                     "sorts_checked": len(hashes),
                     "checked_steps": len(pairs),
                     "reads": [dict(r, stages=st) for r, st in zip(
                         reads_window, stages_window[-len(reads_window):])]
                     if reads_window else [],
                     "card": tracing.card_info() if dev.type == "cuda"
                     else {}}
    if ctrl_res is not None:
        out["numbers"] = numbers
        out["control"] = checks.combine(ctrl_res)
        if ingest_res is not None:
            out["control"].update(ctrl_ingest)
    out["checks"] = check_out
    # last, once the reference and the metric readers have run too
    for name in forbidden_modules():
        raise RunError(f"module {name!r} is loaded")
    return out


def pair_t0(t: float, dt_met: float) -> float:
    """The first time of the met pair that serves model time ``t`` (a
    pair (t0, t1) serves t0 < t <= t1 once the run has left time 0)."""
    t0 = math.floor(t / dt_met) * dt_met
    return t0 - dt_met if t0 == t and t > 0 else t0


def _reference_met(ref, gen, dt_met: float, snaps, met_base, ingest):
    """t -> reference ``ref``'s met pair at model time t: from the
    snapshots in memory (``met_base`` None), or from what it derives
    from the pair's two files of generator ``gen``'s series."""
    if met_base is None:
        pair = ref.met_pair((0.0, dt_met), snaps[0], snaps[1])
        return lambda t: pair
    cache = {}

    def met_for(t):
        t0 = pair_t0(t, dt_met)
        if t0 not in cache:
            cache.clear()
            cache[t0] = ref.met_pair(
                (t0, t0 + dt_met),
                *[ingest(gen.filename(met_base, tt))
                  for tt in (t0, t0 + dt_met)])
        return cache[t0]

    return met_for


def _read_trace(prof, window_s: float) -> SimpleNamespace:
    """Busy time, kernels and idle gaps of the traced window."""
    events = tracing.device_events(prof)
    labels = tracing.host_labels(prof)
    if not events:
        raise RunError("the profiler recorded no device activity")
    t0 = min(a for _, a, _ in events + labels)
    t1 = max(b for _, _, b in events + labels)
    busy_us, gap_list = tracing.busy_and_gaps(events, t0, t1)
    by_name = {}
    for name, a, b in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gap_list, key=lambda g: g[0] - g[1])[:10]
    idle = [[tracing.label_at(labels, 0.5 * (a + b)), (b - a) * 1e-6]
            for a, b in gaps]
    span_s = (t1 - t0) * 1e-6
    return SimpleNamespace(
        events=events, busy_s=busy_us * 1e-6, window_s=window_s,
        trace_span_s=span_s,
        breakdown={"device_ops": [[k[:160], v] for k, v in top],
                   "idle_gaps": idle})


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace),
                  t_start=t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
