#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mptrac_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; without a GPU it exits with a
non-zero code and prints no result.  Phases, each of which must pass:

1. environment: versions of torch, CUDA, nvcc, Triton and the NVIDIA
   kernel module, and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build of the CUDA kernels from ``mptrac_tpu_torch/csrc`` (seconds
   printed);
3. main path: the flagship configuration (solid-body wind on a
   360x181x61 grid, midpoint advection, turbulent and mesoscale
   diffusion, decay, float32 state) with N parcels through the port's
   ``Simulation`` loop on the fused RK kernel (``TPU_FAST 2``): initial
   sort, 2 warm-up steps, 10 timed steps with ``SORT_DT 1800``, so one
   re-sort of drifted parcels falls inside.  Launch counts are zeroed
   just before and read just after;
4. kernels of the main path (K1-K3): each CUDA kernel against its plain
   PyTorch version on the main path's own tensors (the plain version
   evaluated in chunks, to bound its temporaries), with its time, the
   plain version's, a library call's where one computes the same
   function, and the bound from bytes and operations; K1 with its
   registers, spills and resident blocks for each RK scheme; K3 also on
   the main path's own re-sort permutation (the loop stepped on, outside
   the counted run, to the state that the next sort sees), as its count
   pass plans it and on each of its two paths forced, and its count pass
   against the plain count;
5. unfused path: the same configuration on the unfused kernels
   (``TPU_FAST 1``: one interpolation launch per RK node, the sigma
   gather after the turbulent displacement from the table of every
   cell's sigma built once per met pair, the meteo sampling of
   t, u, v, w, theta, ps), driven and counted the same way;
6. kernels of the unfused path (K4, K5's table and gather, the gather
   also in a random parcel order) on its own tensors, and the two
   ``ops`` kernels on other table layouts (K6, K7), which no module
   reaches: those are driven once through their public functions with
   the counts zeroed before and read after, then compared and timed
   like the others.  All kernels are printed as one JSON line
   ``{"kernels": [...]}``;
7. card against CPU: 10 steps at the tests' size on "cuda" and on "cpu",
   for the fused path, the unfused path and the exact float64 path, and
   for the chemistry step on the fused and on the exact float64 path;
8. chem path: the flagship with its chemistry (``phys="chem"``:
   convection, OH and H2O2 chemistry, wet and dry deposition of SO2) on
   the fused path at N parcels, driven and counted as the main path;
9. trac path: the run a user starts from files.  In a temporary
   directory: three netCDF met snapshots of the flagship wind one hour
   apart, a binary particle file of N parcels, a control file with the
   flagship's parameters and a dirlist; then
   ``mptrac_tpu_torch.tools.trac`` on them with ``--dtype float32`` on
   the card (met ingest, ``MetBuffer``, the fused step, one met swap and
   two sorts inside, binary particle output at the end), with the seconds
   of every met file, of reading and writing the particles, the
   milliseconds of every step and of the table rebuilds, and the timer
   table.  The output file is read back and checked;
10. trac against CPU: the same through files at the tests' size on
    "cuda" and on "cpu", float32 fused and float64 exact;
11. golden_long: the port's ``run_trac`` on the card in float64 on a
    temporary copy of ``parity/golden_long`` (1020 steps of the reference
    model's chemistry configuration), held to the golden particle files
    at the staged tolerances of tests/test_long_parity.py;
12. probes: ``mptrac_tpu_torch.perf.probe lane grid small`` (kernels
    P1-P3) driven through its entry point with the counts zeroed before
    and read after, then each kernel against its plain version on every
    element at 2,000,000 and at N parcels, with times and bounds;
13. output path: ``tools.trac`` from files on the flagship case with all
    seven output writers as a user at this size runs them (a global
    1-degree netCDF grid of 360x180x50 cells, the 32 ensemble members,
    every 100th parcel to VTK, CSI, profiles and samples against 10,000
    observations, golden_chem's station), float32 on the fused path, 21
    steps from 0 to 3600 s: each writer's milliseconds a call (CUDA
    events), ``WRITE_OUTPUT`` a step, the step without its output
    beside trac_path's, the bytes of each file and peak memory; every
    file is checked;
14. writers against CPU: the same case at 2048 parcels, 10 steps, on the
    card and on the CPU in float64: every file at the tolerances of
    tests/test_full_parity.py, counts exactly;
15. golden_chem: the port's ``run_trac`` on the card in float64 on a
    copy of ``parity/golden_chem`` with every writer, each particle,
    grid, ensemble, CSI, station, profile, sample and VTK file held to
    the golden files;
16. zeta path: ``tools.trac`` with diabatic zeta advection from two
    CLaMS-convention met files at 360x181x61 model levels (the recipe of
    parity/mint_zeta.sh), N parcels, float32 on the unfused kernels, 2 +
    10 steps: ms a step, a column search and a field, the K2 and K5
    launches, the met files' seconds, peak memory;
17. golden_zeta: ``run_trac`` on the card in float64 on a copy of
    ``parity/golden_zeta``, held at tests/test_zeta_parity.py's
    tolerances;
18. pbl path: a radionuclide release near the ground, the flagship with
    the PBL scheme, sedimentation and radioactive decay (``PBL_QNT``,
    ``PBL_ARGS``) over a boundary layer planted on the synthetic met
    (``plant_pbl``), fused, N parcels: ms a step, the new modules' ms,
    the share of parcels in each branch of the PBL scheme;
19. iso path: isentropic trajectories, the flagship with ``ISOSURF 3``
    and the threefry generator, N parcels, and one threefry draw of 3N
    normals beside a Squares draw;
20. kpp path: KPP chemistry on the chemistry rung at ``KPP_N`` parcels,
    1 + 3 steps: each module_kpp_chem call's ms and Rosenbrock steps;
21. checkpoint: the pbl path at ``CKPT_N`` parcels, 4 steps against 2 +
    a checkpoint + a resumed Simulation's 2, bit for bit; the save and
    load seconds and the file's bytes;
22. card against CPU of the new modules (``phase_slice_vs_cpu``): the
    PBL scheme, each isosurface mode (4 with a balloon file), KPP and
    all modules at once, fused float32 and exact float64, and the
    threefry bits of both devices;
23. bin path: trac path's case (its directory is kept for 23-25) read
    from MET_TYPE 1 files that the port's ``write_met_bin`` converted
    from its netCDF files, the second and third through the native
    decode-ahead, counted as the main path: ms a step, the step at the
    swap beside trac path's, each file's seconds by stage, route and
    wait, peak memory, the launches; the particle file held to trac
    path's byte for byte;
24. codec path: one full-size file of each other container (2, 2 with
    MET_PCK_ZSTD, 3, 4, 5, 7, 8): ratio and bits per value, the write
    and read seconds by stage, the card's read against the CPU's in ulps
    on every field, the error against the MET_TYPE 1 fields within each
    codec's guarantee;
25. capi: the port's C shim and ``demo_trac`` built and run on the card
    at ``CAPI_N`` parcels, its particle file held to ``run_trac``'s;
26. grib path: a GRIB2 set at 360x181x61 through ``read_met`` on the
    card and on the CPU, every field held equal;
27. clams atm: CLaMS particle files (types 3 and 4) of N parcels written
    and read back equal (CDF-2), seconds and bytes;
28. formats against CPU: each new reader at the tests' size, card
    against CPU, and ``run_trac`` from MET_TYPE 1 files;
29. dd path: bench_dd's case (bench.py:300-412) at N parcels, nothing
    cut: the flagship without diffusion and decay on the exact float32
    path, the plain step (``rate_1``), the domain-decomposed step of
    4 x 2 subdomains in the local group (cap 2N/8 a subdomain, exch_cap
    cap/8; counted as the main path) and the DD step without the
    exchange, 2 + 5 steps each: ms a step, the exchange's and
    compaction's ms, migrated parcels, overflow, lost, peak memory, one
    more DD step with every K3 launch in it timed, and one with the
    allocator read at the edges of its stages (the peak's breakdown);
    live + lost == N;
30. dd against CPU: tests/test_dd.py's case (200 parcels, DD 4 x 2, 24
    steps, float64) card against CPU slot by slot and against the plain
    run on the card, then the 3 x 3 stress case (10,000 parcels,
    diffusion on) on the card: conservation, overflow at exch_cap 1,
    lost parcels on a regional grid;
31. dd dist: the process-group route on dd_worker.py's case: one NCCL
    rank a card (this script with ``--dd-rank``), its block against the
    local group's bit for bit; then two ranks on one card over NCCL and,
    where NCCL refuses them as a duplicate GPU, over gloo with the ranks'
    CUDA buffers; which backend carried it is printed, and any other
    failure, or none carrying it, fails the phase.

Every phase prints its seconds (``[phase]`` lines, ``phase_seconds``).
The environment phase also names the libzstd that ``met/zstd`` binds and
the host compilers (``g++``, ``gcc``) that the met loader and the C API
are built with, and fails by name where one is missing.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The ``{"kernels": [...]}`` line lists K1-K7 (K5 as its gather and its
table build) and P1-P3; K3's entry carries its launches and times on
the dd path (``dd_path``).

N is fixed at 100,663,296 parcels (100M rounded up to a multiple of
2^21, the size the JAX benchmark uses).  ``--np`` and ``--steps`` exist
for short debugging runs; ``--profile`` adds, for each path (the chem
path too), a pass over two extra steps timed module by module and a
profiler pass that prints the device time by kernel.
"""

import argparse
import importlib.metadata
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("LOGLEV", "0")

N_FLAGSHIP = 100_663_296
GRID = (360, 181, 61)
WARMUP_STEPS = 2
TIMED_STEPS = 10
SORT_DT = 1800.0

#: published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside
#: the tensor cores (the kernels here are float32 gathers)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

#: parcels per pass of a plain version (bounds its temporaries)
PLAIN_CHUNK = 1 << 22

#: card against CPU after ten steps at the tests' size (why these: see
#: phase_card_vs_cpu)
TOLS_F32 = dict(lon=6.2e-4, lat=6.2e-4, p=6.2e-4, t=6.2e-5, m=2e-6,
                uvwp=5e-3, rh=1e-4, sh=1e-9)
TOLS_F64 = dict(lon=1e-7, lat=1e-7, p=5e-6, t=1e-9, m=1e-12, uvwp=5e-6,
                rh=1e-6, sh=1e-12)
#: the chemistry step: each step's OH loss passes through log10,
#: pow(0.6, x) and exp of the parcel's M and T, a few float32 ulp apart
#: between the two math libraries, over ten steps: m to 1e-5 in float32
TOLS_CHEM_F32 = dict(TOLS_F32, m=1e-5)

#: quantities sampled on the unfused path: straight 3-D samplings (the
#: uvwt kernel), a derived quantity and a surface field (the surface
#: kernel)
UNFUSED_QNT = ("t", "m", "u", "v", "w", "theta", "ps")


def say(msg):
    print(msg, flush=True)


def run_text(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def time_ms(fn, torch, repeats=5):
    """Milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(repeats):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / repeats


def chunked(fn, tensors, n, chunk=PLAIN_CHUNK):
    """Apply ``fn`` to [s:e] slices of ``tensors`` and concatenate the
    row results: the plain version on the same inputs, piecewise."""
    import torch
    outs = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        outs.append(torch.stack(list(fn(*[t[s:e] for t in tensors]))))
    return torch.cat(outs, dim=1)


def max_err(a, b, torch):
    """Largest |a - b| with NaN equal to NaN (inf if only one is NaN)."""
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max())


# ------------------------------------------------------------ phases

def phase_environment(torch):
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    drv = run_text(["nvidia-smi", "--query-gpu=driver_version",
                    "--format=csv,noheader"])
    from mptrac_tpu_torch.ops import _cuda
    nvcc = run_text([_cuda.find_nvcc(), "--version"]).splitlines()[-2:]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {triton} nvidia "
        f"{drv.splitlines()[0] if drv else '?'} nvcc "
        f"{' '.join(x.strip() for x in nvcc)}")
    if not smi:
        raise RuntimeError("nvidia-smi gave no name,power.limit line")
    from mptrac_tpu_torch.met import zstd
    for tool in ("g++", "gcc"):
        if shutil.which(tool) is None:
            raise RuntimeError(f"{tool} is missing: the met readers' host "
                               "library and the C API cannot be built")
    say(f"[env] libzstd {zstd.version()} (met/zstd), "
        f"{run_text(['g++', '--version']).splitlines()[0]}")
    say(smi)
    return smi.splitlines()[0]


def ptxas_usage(text):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from the
    ``-Xptxas -v`` lines of the build log."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    return usage


def phase_build():
    """Builds the kernels; returns the registers and spills of each
    kernel as the build log gives them."""
    from mptrac_tpu_torch.ops import _cuda
    t0 = time.time()
    lib = _cuda.build()
    _cuda.load()
    dt = time.time() - t0
    say(f"[build] {lib} in {dt:.1f} s")
    usage = {}
    if os.path.exists(_cuda.build_log_path()):
        with open(_cuda.build_log_path()) as f:
            usage = ptxas_usage(f.read())
        for name, u in sorted(usage.items()):
            say(f"[build] {name}: {json.dumps(u)}")
    return usage


def rng3_draws(ctl):
    """``module_rng3`` calls a step: the turbulent diffusion, the PBL
    scheme and the mesoscale diffusion draw 3n normals each."""
    if not ctl.diffusion:
        return 0
    turb = any(v > 0 for v in (ctl.turb_dx_pbl, ctl.turb_dz_pbl,
                                ctl.turb_dx_trop, ctl.turb_dz_trop,
                                ctl.turb_dx_strat, ctl.turb_dz_strat))
    return (int(turb) + int(ctl.turb_pbl_scheme == 1)
            + int(ctl.turb_mesox > 0 or ctl.turb_mesoz > 0))


def drive_flagship(torch, tag, n, steps, profile, extra_args, phys="base",
                   prepare=None, warmup=WARMUP_STEPS):
    """The flagship (rung ``phys`` of its physics ladder) through
    ``Simulation`` with the pack that its ``TPU_FAST`` asks for: initial
    sort, warm-up steps, timed steps.  ``prepare(met01, atm)``, where
    given, sets the met fields and the parcels' values a path needs
    before the run.  Launch counts are zeroed just before and read just
    after.  Checks what every path must show (finite state, moved
    parcels, the RNG counter, the mass decay, or with the chemistry a
    loss beyond it, parcel times, T = 280 K, the sorts) and returns
    (sim, counts, stats)."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.sim import FixedMet, Simulation

    t0 = time.time()
    ctl, clim, met01, atm, cache = flagship.make_setup(
        n, *GRID, extra_args=("SORT_DT", str(int(SORT_DT))) + extra_args,
        device="cuda", phys=phys)
    if prepare is not None:
        prepare(met01, atm)
    sim = Simulation(ctl, atm, clim, met=FixedMet(met01), cache=cache)
    ctl = sim.ctl
    del atm, cache
    torch.cuda.synchronize()
    say(f"[{tag}] set-up of {n} parcels on {GRID[0]}x{GRID[1]}x{GRID[2]} "
        f"in {time.time() - t0:.1f} s")
    dt_mod = ctl.dt_mod
    total = warmup + steps
    ts = [dt_mod * (i + 1) for i in range(total)]

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()              # the path starts here
    t0 = time.time()
    sim.sort()                               # initial sort (random order)
    torch.cuda.synchronize()
    sort0_s = time.time() - t0
    sort_peak = torch.cuda.max_memory_allocated()
    lon_sorted = sim.atm.lon.clone()
    t0 = time.time()
    sim.run(write_output=False, ts=ts[:warmup])
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    # (the loop built the tables that TPU_FAST asks for at its first step)
    tables = {k: v.table if k == "cell" else v
              for k, v in sim.pack._asdict().items() if v is not None}
    say(f"[{tag}] tables " + ", ".join(
        f"{k} {v.numel() * 4 / 1e6:.1f} MB" for k, v in tables.items()))
    # (no sort falls into the warm-up, so parcels keep their places)
    moved = float((sim.atm.lon - lon_sorted).abs().max())
    del lon_sorted
    t0 = time.time()
    sim.run(write_output=False, ts=ts[warmup:])
    torch.cuda.synchronize()
    timed_s = time.time() - t0
    counts = dict(_cuda.launch_counts)       # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    a, c = sim.atm, sim.cache
    for name, x in [("lon", a.lon), ("lat", a.lat), ("p", a.p),
                    ("time", a.time), ("uvwp", c.uvwp)] + [
                        (k, v) for k, v in a.q.items()]:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{tag}: non-finite values in {name}")
    if not moved > 1e-3:
        raise RuntimeError(f"{tag}: parcels did not move")
    # the diffusion draws of 3n + 1 a step, and the convection's n + 1
    conv = ctl.conv_mix_pbl or ctl.conv_cape >= 0
    want_ctr = total * (rng3_draws(ctl) * (3 * n + 1)
                        + (n + 1 if conv else 0))
    if c.rng_ctr != want_ctr:
        raise RuntimeError(f"{tag}: rng_ctr {c.rng_ctr}, expected "
                           f"{want_ctr}")
    want_m = math.exp(-dt_mod / ctl.tdec_trop) ** total
    if phys in ("chem", "full"):
        # OH chemistry and dry deposition take mass beyond the decay
        m_max = float(a.q["m"].max())
        m_err = float(a.q["m"].min()) / want_m - 1.0
        if not (m_max <= want_m * (1.0 + 1e-5) and -0.5 < m_err < -1e-6):
            raise RuntimeError(f"{tag}: mass {m_err:.2e} rel. off the "
                               f"decay, largest {m_max}")
    else:
        m_err = float((a.q["m"] / want_m - 1.0).abs().max())
        if not m_err < 1e-5:
            raise RuntimeError(f"{tag}: mass decay off by {m_err:.2e} rel.")
    if not float((a.time - ts[-1]).abs().max()) == 0.0:
        raise RuntimeError(f"{tag}: parcel times did not reach t")
    if not (abs(float(a.q["t"].min()) - 280.0) < 1e-2
            and abs(float(a.q["t"].max()) - 280.0) < 1e-2):
        raise RuntimeError(f"{tag}: sampled temperature is not 280 K")
    expect_sorts = 1 + sum(1 for t in ts if math.fmod(t, SORT_DT) == 0)
    k3 = {k: counts[f"permute_{k}"] for k in ("count", "gather", "pack",
                                               "rows")}
    # one count pass a sort, then the gather or the pack and rows kernels;
    # the first sort (a random order) takes the row path, the re-sort of
    # the timed steps the gather path, but where convection moves every
    # parcel to a random height each step (phys chem) the re-sort's
    # permutation is random too and takes the row path
    both_paths = (phys == "base" and prepare is None
                  and steps >= TIMED_STEPS)
    if (sim.nsorts != expect_sorts or k3["count"] != expect_sorts
            or k3["pack"] != k3["rows"]
            or k3["gather"] + k3["rows"] != expect_sorts
            or (both_paths and min(k3.values()) < 1)):
        raise RuntimeError(f"{tag}: {sim.nsorts} sorts, K3 launches {k3}, "
                           f"expected {expect_sorts} sorts")
    stats = {
        "phys": phys, "n_parcels": n, "grid": list(GRID),
        "steps_timed": steps,
        "steps_warmup": warmup, "resorts": sim.nsorts - 1,
        "initial_sort_s": sort0_s, "initial_sort_peak_bytes": sort_peak,
        "warmup_s": warm_s,
        "timed_s": timed_s, "ms_per_step": 1e3 * timed_s / steps,
        "parcel_steps_per_s": n * steps / timed_s,
        "peak_memory_allocated_bytes": peak,
        "launches": counts, "mass_rel_err": m_err}
    if profile:
        stats["profile"] = profile_steps(
            torch, sim, [ts[-1] + dt_mod * (i + 1) for i in range(2)])
    return sim, counts, stats


def phase_main_path(torch, n, steps, profile):
    """The fused path: one K1 launch a step."""
    sim, counts, stats = drive_flagship(torch, "main", n, steps, profile,
                                        ("TPU_FAST", "2"))
    total = WARMUP_STEPS + steps
    if counts["rk_fused_advect"] != total:
        raise RuntimeError(f"K1 launches {counts['rk_fused_advect']} != "
                           f"steps {total}")
    if counts["sfc_interp"] < total:
        raise RuntimeError(f"K2 launches {counts['sfc_interp']} < {total}")
    say(json.dumps({"main_path": stats}))
    return sim, counts


def phase_unfused_path(torch, n, steps, profile):
    """The unfused path: per step K4 once per RK node and once in the
    meteo sampling, K5's gather once (its table once per met pair), K2
    for the turbulent diffusion and for the sampled surface pressure."""
    qnt = ("NQ", str(len(UNFUSED_QNT)))
    for k, name in enumerate(UNFUSED_QNT):
        qnt += (f"QNT_NAME[{k}]", name)
    sim, counts, stats = drive_flagship(torch, "unfused", n, steps, profile,
                                        ("TPU_FAST", "1") + qnt)
    total = WARMUP_STEPS + steps
    # K5: its table once (one met pair, a FixedMet), its gather a step
    want = {"uvwt_interp": (sim.ctl.advect + 1) * total,
            "meso_sigma_table": 1, "meso_sigma": total,
            "sfc_interp": 2 * total, "rk_fused_advect": 0}
    for name, k in want.items():
        if counts[name] != k:
            raise RuntimeError(f"unfused path: {name} launched "
                               f"{counts[name]} times, expected {k}")
    a = sim.atm
    # theta = T (1000/p)^0.286 at T = 280 K and 200 < p < 1013.25 hPa;
    # ps is uniform; the solid-body wind stays under its u0 and has w = 0
    from mptrac_tpu_torch.ops import thermo
    th_err = float((a.q["theta"] - thermo.theta(a.p, a.q["t"])).abs().max())
    vh = float(torch.sqrt(a.q["u"] ** 2 + a.q["v"] ** 2).max())
    if not (th_err == 0.0 and abs(float(a.q["ps"].min()) - 1013.25) < 1e-3
            and abs(float(a.q["ps"].max()) - 1013.25) < 1e-3
            and 1.0 < vh < 38.6 and float(a.q["w"].abs().max()) == 0.0):
        raise RuntimeError(
            f"unfused path: sampled quantities off (theta {th_err:.2e}, "
            f"max wind {vh:.3f}, ps {float(a.q['ps'].min()):.3f})")
    say(json.dumps({"unfused_path": stats}))
    return sim, counts


def phase_chem_path(torch, n, steps, profile):
    """The flagship with the chemistry (phys ``chem``: convection, OH and
    H2O2 chemistry, wet and dry deposition of SO2) on the fused path:
    one K1 launch a step, K2 for the turbulent diffusion, K3 for the
    sorts; the modules of the chemistry are plain PyTorch."""
    sim, counts, stats = drive_flagship(torch, "chem", n, steps, profile,
                                        ("TPU_FAST", "2"), phys="chem")
    total = WARMUP_STEPS + steps
    ctl = sim.ctl
    if not (ctl.oh_chem_reaction == 3 and ctl.h2o2_chem_reaction == 1
            and ctl.conv_cape >= 0 and ctl.dry_depo_vdep > 0):
        raise RuntimeError("chem path: the control parameters do not "
                           "switch the chemistry on")
    if counts["rk_fused_advect"] != total:
        raise RuntimeError(f"chem path: K1 launches "
                           f"{counts['rk_fused_advect']} != steps {total}")
    if counts["sfc_interp"] < total:
        raise RuntimeError(f"chem path: K2 launches {counts['sfc_interp']} "
                           f"< {total}")
    say(json.dumps({"chem_path": stats}))
    return sim, counts


# ------------------------------- the physics that no golden set runs

#: a radionuclide release near the ground (pbl path): 1 um particles of
#: 2500 kg/m^3 (sedimentation), radon with its lead, caesium, iodine
PBL_QNT = ("t", "m", "rp", "rhop", "Arn222", "Apb210", "Acs137", "Ai131")
#: the PBL scheme and radioactive decay; the vertical mesoscale diffusion
#: stays off beside the PBL scheme: both keep their vertical perturbation
#: in uvwp[2], the PBL scheme in m/s, the mesoscale diffusion in hPa/s,
#: so a PBL perturbation of 1 m/s becomes a mesoscale step of 180 hPa
#: (in both packages; ROADMAP section 3, F7)
PBL_ARGS = ("TURB_PBL_SCHEME", "1", "RADIO_DECAY", "1", "TURB_MESOZ", "0")
#: isentropic trajectories with the threefry generator
ISO_ARGS = ("ISOSURF", "3", "RNG_TYPE", "2")
#: KPP chemistry on the chemistry rung, every step
KPP_QNT = ("t", "m", "Cx", "Coh", "Cho2", "Ch2o2", "Co3p", "Co1d", "Ch",
           "mloss_kpp")
KPP_ARGS = ("KPP_CHEM", "1", "DT_KPP", "180")
#: KPP's parcels and steps: on the order of a volcanic SO2 chemistry run,
#: not the flagship's 100,663,296 (PERF.md section 4: the cut and why)
KPP_N = 1 << 20
KPP_WARMUP, KPP_STEPS = 1, 3
#: the checkpoint phase's parcels and steps (a checkpoint after step 2)
CKPT_N = 4_194_304
CKPT_STEPS = 4


def qnt_args(names):
    out = ("NQ", str(len(names)))
    for k, name in enumerate(names):
        out += (f"QNT_NAME[{k}]", name)
    return out


def plant_pbl(torch, met01, atm, seed=1):
    """A boundary layer over the synthetic met, in place, varying with
    longitude and latitude: 0.5-2 km deep, sensible heat flux -50 to
    300 W/m^2, surface stresses 0.05-0.3 N/m^2 (the synthetic met has
    zero flux and stress, where the PBL scheme sees only its neutral
    regime); and the parcels of a release near the ground: pressures
    uniform in 700-1010 hPa (drawn from ``seed``), 1 um
    particles of 2500 kg/m^3, activities of 1000 Bq (lead 0)."""
    from mptrac_tpu_torch.constants import H0
    lon, lat = met01.lon[0], met01.lat[0]
    x = torch.deg2rad(lon.double())[:, None]
    y = torch.deg2rad(lat.double())[None, :]
    f2 = met01.fields2d

    def put(name, v):
        f2[name].copy_(v.to(f2[name].dtype).expand_as(f2[name]))

    depth = 0.5 + 1.5 * (0.5 + 0.5 * torch.sin(x) * torch.cos(y))
    put("pbl", f2["ps"][0].double() * torch.exp(-depth / H0))
    put("shf", -50.0 + 350.0 * (0.5 + 0.5 * torch.cos(2.0 * x)
                                * torch.cos(y)))
    put("ess", 0.05 + 0.25 * (0.5 + 0.5 * torch.sin(3.0 * y) + 0.0 * x))
    put("nss", 0.05 + 0.25 * (0.5 + 0.5 * torch.cos(x) + 0.0 * y))
    # (drawn on the host, so that every device gets the same parcels)
    gen = torch.Generator().manual_seed(seed)
    atm.p.copy_(700.0 + 310.0 * torch.rand(atm.p.shape, generator=gen,
                                           dtype=torch.float64))
    for name, v in (("rp", 1.0), ("rhop", 2500.0), ("Arn222", 1e3),
                    ("Apb210", 0.0), ("Acs137", 1e3), ("Ai131", 1e3)):
        if name in atm.q:
            atm.q[name].fill_(v)


def module_ms(torch, sim, ts, targets):
    """ms a step of each ``(owner, name)`` of ``targets`` by CUDA events
    over the steps ``ts`` (after the timed steps)."""
    timing = Timing(torch)
    for owner, name, tag in targets:
        timing.wrap(owner, name, tag)
    try:
        sim.run(write_output=False, ts=ts)
    finally:
        timing.restore()
    return {tag: sum(timing.ms(tag)) / len(ts) for _, _, tag in targets}


def branch_shares(torch, sim):
    """Share of the live parcels in each branch of the PBL scheme."""
    from mptrac_tpu_torch.physics import pbl
    code = pbl.pbl_branches(sim.ctl, sim.cache, sim.met.get(0.0), sim.atm)
    counts = torch.bincount(code.long(), minlength=len(pbl.BRANCHES))
    return {b: int(c) / sim.atm.np
            for b, c in zip(pbl.BRANCHES, counts.tolist())}


def phase_pbl_path(torch, n, steps, profile):
    """A radionuclide release near the ground on the fused path: the
    flagship with the PBL scheme, sedimentation and radioactive decay
    (``PBL_QNT``, ``PBL_ARGS``) over the planted boundary layer, at N
    parcels: ms a step, the new modules' ms, the share of parcels in each
    branch of the PBL scheme, peak memory, launch counts."""
    from mptrac_tpu_torch.physics import decay, pbl, sedi
    sim, counts, stats = drive_flagship(
        torch, "pbl", n, steps, profile,
        ("TPU_FAST", "2") + qnt_args(PBL_QNT) + PBL_ARGS,
        prepare=lambda met01, atm: plant_pbl(torch, met01, atm))
    total = WARMUP_STEPS + steps
    if counts["rk_fused_advect"] != total or counts["sfc_interp"] < total:
        raise RuntimeError(f"pbl path: K1/K2 launches {counts}")
    a = sim.atm
    shares = branch_shares(torch, sim)
    if not (sum(v > 0 for k, v in shares.items() if k != "inactive") >= 3
            and 0.2 < 1.0 - shares["inactive"] < 0.8):
        raise RuntimeError(f"pbl path: branch shares {shares}")
    if not (float(a.q["Apb210"].min()) > 0.0
            and float(a.q["Ai131"].max()) < 1e3
            and float(sim.cache.uvwp[2].abs().max()) > 0.0):
        raise RuntimeError("pbl path: no in-growth, decay or perturbation")
    dt_mod = sim.ctl.dt_mod
    t_end = dt_mod * total
    stats["module_ms"] = module_ms(torch, sim, [
        t_end + dt_mod * (i + 1) for i in range(2)], [
        (pbl, "module_diff_pbl", "module_diff_pbl"),
        (pbl, "module_rng3", "module_diff_pbl rng3"),
        (sedi, "module_sedi", "module_sedi"),
        (decay, "module_radio_decay", "module_radio_decay")])
    stats["pbl_branch_shares"] = shares
    say(json.dumps({"pbl_path": stats}))
    return sim


def phase_iso_path(torch, n, steps, profile):
    """Isentropic trajectories on the fused path: the flagship with
    ``ISOSURF 3`` and the threefry generator (``RNG_TYPE 2``) at N
    parcels.  The synthetic met's T is uniform, so every parcel keeps its
    pressure.  Also the ms of one 3N-normal threefry draw beside a
    Squares draw."""
    from mptrac_tpu_torch.ops import rng
    from mptrac_tpu_torch.physics import diffusion, isosurf
    p0 = {}

    def keep_p(met01, atm):
        p0["p"] = atm.p.clone()

    sim, counts, stats = drive_flagship(
        torch, "iso", n, steps, profile, ("TPU_FAST", "2") + ISO_ARGS,
        prepare=keep_p)
    total = WARMUP_STEPS + steps
    if counts["rk_fused_advect"] != total:
        raise RuntimeError(f"iso path: K1 launches {counts}")
    # the sort permuted the parcels and their isentropes together
    c = sim.cache
    if c.iso_var.shape != sim.atm.p.shape:
        raise RuntimeError("iso path: no isosurface variable per parcel")
    theta = sim.atm.q["t"] * (1000.0 / sim.atm.p) ** 0.286
    iso_err = float((theta / c.iso_var - 1.0).abs().max())
    p_sorted = torch.sort(sim.atm.p).values
    p_err = float((p_sorted / torch.sort(p0.pop("p")).values - 1.0)
                  .abs().max())
    if not (iso_err < 1e-5 and p_err < 1e-5):
        raise RuntimeError(f"iso path: off the isentropes by {iso_err:.2e}"
                           f", pressures by {p_err:.2e}")
    dt_mod = sim.ctl.dt_mod
    t_end = dt_mod * total
    stats["module_ms"] = module_ms(torch, sim, [
        t_end + dt_mod * (i + 1) for i in range(2)], [
        (isosurf, "module_isosurf", "module_isosurf"),
        (diffusion, "module_rng3", "module_rng3 (threefry, 2 a step)")])
    ctr = c.rng_ctr
    draws = {}
    for tag, kind in (("threefry", 2), ("squares", 1)):
        draws[tag] = time_ms(lambda: rng.module_rng3(
            kind, ctr, n, dtype=torch.float32, device="cuda"), torch)
    stats.update(isentrope_rel_err=iso_err, pressure_rel_err=p_err,
                 rng3_ms_3n_normals=draws)
    say(json.dumps({"iso_path": stats}))
    return sim


def prepare_kpp(torch, met01, atm):
    """The met and parcels of tests/test_kpp.py: H2O 5e-6 and O3 2e-6;
    SO2 1e-9, OH 1e-13, HO2 1e-12, H2O2 1e-10."""
    met01.fields3d["h2o"].fill_(5e-6)
    met01.fields3d["o3"].fill_(2e-6)
    for name, v in (("Cx", 1e-9), ("Coh", 1e-13), ("Cho2", 1e-12),
                    ("Ch2o2", 1e-10)):
        atm.q[name].fill_(v)


def phase_kpp_path(torch, n, profile):
    """KPP chemistry on the chemistry rung (fused path, phys ``chem``
    plus ``KPP_CHEM 1``, ``DT_KPP 180``) at ``KPP_N`` parcels, 1 + 3
    steps: ms a step, the chunk size, the ms of each module_kpp_chem
    call and the Rosenbrock steps of its slowest parcel and their mean."""
    from mptrac_tpu_torch.physics import kpp
    calls = []
    orig = kpp.module_kpp_chem

    def timed(ctl, cache, clim, met01, atm, stats=None):
        st = {}
        torch.cuda.synchronize()
        t0 = time.time()
        out = orig(ctl, cache, clim, met01, atm, stats=st)
        torch.cuda.synchronize()
        st["ms"] = 1e3 * (time.time() - t0)
        calls.append(st)
        return out

    kpp.module_kpp_chem = timed
    try:
        sim, counts, stats = drive_flagship(
            torch, "kpp", n, KPP_STEPS, profile,
            ("TPU_FAST", "2") + qnt_args(KPP_QNT) + KPP_ARGS, phys="chem",
            prepare=lambda met01, atm: prepare_kpp(torch, met01, atm),
            warmup=KPP_WARMUP)
    finally:
        kpp.module_kpp_chem = orig
    total = KPP_WARMUP + KPP_STEPS
    a = sim.atm
    if len(calls) != total or counts["rk_fused_advect"] != total:
        raise RuntimeError(f"kpp path: {len(calls)} KPP calls, launches "
                           f"{counts}")
    if not (float(a.q["mloss_kpp"].max()) > 0.0
            and bool((a.q["Coh"] != 1e-13).any())
            and float(a.q["Cx"].min()) >= 0.0):
        raise RuntimeError("kpp path: the chemistry changed nothing")
    stats.update(kpp_chunk=kpp.KPP_CHUNK, kpp_calls=calls)
    say(json.dumps({"kpp_path": stats}))
    return sim


def phase_checkpoint(torch, n):
    """The pbl path's configuration at ``CKPT_N`` parcels: 4 steps
    uninterrupted; 2 steps with a checkpoint after step 2, and a fresh
    Simulation resumed from it for steps 3 and 4.  The final states are
    held bit for bit.  Prints the seconds of a save and a load and the
    file's bytes."""
    from mptrac_tpu_torch import checkpoint, flagship
    from mptrac_tpu_torch.sim import FixedMet, Simulation
    args = (("SORT_DT", str(int(SORT_DT)), "TPU_FAST", "2")
            + qnt_args(PBL_QNT) + PBL_ARGS)

    def sim(**kw):
        ctl, clim, met01, atm, cache = flagship.make_setup(
            n, *GRID, extra_args=args, device="cuda")
        plant_pbl(torch, met01, atm)
        return Simulation(ctl, atm, clim, met=FixedMet(met01), cache=cache,
                          **kw)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        full = sim()
        dt_mod = full.ctl.dt_mod
        ts = [dt_mod * (i + 1) for i in range(CKPT_STEPS)]
        full.sort()
        full.run(write_output=False, ts=ts)
        ck = os.path.join(tmp, "state.npz")
        first = sim(checkpoint_file=ck, checkpoint_dt=2 * dt_mod)
        first.sort()
        first.run(write_output=False, ts=ts[:2])
        del first
        resumed = sim()
        torch.cuda.synchronize()
        t0 = time.time()
        resumed.resume(ck)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        resumed.run(write_output=False, ts=ts[2:])
        a, b = resumed.atm, full.atm
        same = {name: bool(torch.equal(getattr(a, name), getattr(b, name)))
                for name in ("time", "lon", "lat", "p")}
        same.update({f"q_{k}": bool(torch.equal(a.q[k], b.q[k]))
                     for k in b.q})
        same["uvwp"] = bool(torch.equal(resumed.cache.uvwp, full.cache.uvwp))
        same["rng_ctr"] = resumed.cache.rng_ctr == full.cache.rng_ctr
        if not all(same.values()):
            raise RuntimeError(f"checkpoint: resumed run differs {same}")
        if not float(full.cache.uvwp[2].abs().max()) > 0.0:
            raise RuntimeError("checkpoint: no PBL perturbation to carry")
        t0 = time.time()
        checkpoint.save_checkpoint(os.path.join(tmp, "again.npz"),
                                   full.atm, full.cache, ts[-1])
        save_s = time.time() - t0
        nbytes = os.path.getsize(ck)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"checkpoint": {
        "n_parcels": n, "steps": CKPT_STEPS, "checkpoint_after_step": 2,
        "bit_exact": True, "save_s": save_s, "load_s": load_s,
        "file_bytes": nbytes}}))


#: card against CPU of the new modules: extra quantities' relative
#: tolerances (the positions, T, m and uvwp keep TOLS_F32 / TOLS_F64)
SLICE_RTOL32 = 1e-4
SLICE_RTOL64 = 1e-9
#: ... but the PBL scheme's pressures: its AR(1) perturbations take the
#: two devices' normals (a few float32 ulp apart, see
#: phase_card_vs_cpu) times sigma_w ~1 m/s times 180 s a step into the
#: height, 0.14 hPa a metre near the ground: 1.3e-5 hPa in float64 after
#: ten steps; in float32 the height-pressure round trip and the
#: reflections add ~20 ulp of p (1.2e-3 hPa, measured on one H100)
TOLS_PBL_F32 = dict(TOLS_CHEM_F32, p=5e-3)
TOLS_PBL_F64 = dict(TOLS_F64, p=5e-5)
#: KPP in float64 through cuBLAS/cuSOLVER on the card and LAPACK on the
#: CPU: the LU ulps grow over hundreds of Rosenbrock steps (the port
#: against JAX: 1.8e-6, tests/test_torch_kpp.py), and mixing ratios
#: below ~1e-18 are below the solver's resolution
KPP_RTOL, KPP_ATOL = 1e-4, 1e-18


def write_balloon(path):
    """A balloon track over the card-vs-CPU run's 1800 s: pressures
    from 200 to 80 hPa."""
    with open(path, "w") as f:
        for k in range(11):
            f.write(f"{-60.0 + 200.0 * k:.1f} {200.0 - 12.0 * k:.3f}\n")


def phase_slice_vs_cpu(torch):
    """The new modules and the all-modules step at the tests' size on
    the card and on the CPU, on the fused float32 path and the exact
    float64 path: the PBL scheme with sedimentation and radioactive
    decay over the planted boundary layer (2048 parcels, 10 steps), the
    isosurface in each mode (mode 4 with a balloon file in a temporary
    directory) with the threefry generator, KPP and everything at once
    (512 parcels, 3 steps); and the threefry bits of both devices, equal
    bit for bit."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.ops import rng
    from mptrac_tpu_torch.sim import FixedMet, Simulation

    f32, f64 = torch.float32, torch.float64
    tmp = tempfile.mkdtemp(prefix="chip_smoke_balloon_")
    balloon = os.path.join(tmp, "balloon.tab")
    write_balloon(balloon)
    all_qnt = tuple(dict.fromkeys(PBL_QNT + KPP_QNT))
    # (name, quantities, control parameters, rung, parcels, steps); KPP
    # at fewer parcels and steps: its CPU side takes the longest
    configs = [("pbl", PBL_QNT, PBL_ARGS, "base", 2048, 10)]
    configs += [(f"iso{k}", ("t", "m"), ("ISOSURF", str(k), "RNG_TYPE", "2",
                                         "BALLOON", balloon), "base", 2048,
                 10) for k in (1, 2, 3, 4)]
    configs += [("kpp", KPP_QNT, KPP_ARGS, "chem", 512, 3),
                ("all_modules", all_qnt, PBL_ARGS + KPP_ARGS, "chem", 512,
                 3)]
    report, failed = {}, []
    try:
        for name, qnt, extra, phys, n, steps in configs:
            pbl_on = "TURB_PBL_SCHEME" in extra
            for path, fast, dtype, tols, rtol in (
                    ("fused", "2", f32,
                     TOLS_PBL_F32 if pbl_on else TOLS_CHEM_F32, SLICE_RTOL32),
                    ("exact_f64", "0", f64,
                     TOLS_PBL_F64 if pbl_on else TOLS_F64, SLICE_RTOL64)):
                out = {}
                for dev in ("cuda", "cpu"):
                    ctl, clim, met01, atm, cache = flagship.make_setup(
                        n, nx=36, ny=19, nz=8,
                        extra_args=("SORT_DT", "900", "TPU_FAST", fast)
                        + qnt_args(qnt) + extra, device=dev, dtype=dtype,
                        phys=phys)
                    if "rp" in qnt:
                        plant_pbl(torch, met01, atm)
                    if "Cx" in qnt:
                        prepare_kpp(torch, met01, atm)
                    s = Simulation(ctl, atm, clim, met=FixedMet(met01),
                                   cache=cache)
                    s.sort()
                    s.run(write_output=False,
                          ts=[ctl.dt_mod * (i + 1) for i in range(steps)])
                    out[dev] = s
                a, b = out["cuda"], out["cpu"]
                tag = f"{name}_{path}"
                if a.cache.rng_ctr != b.cache.rng_ctr:
                    failed.append(f"{tag}: rng_ctr")
                errs = {}
                for key, x, y in (("lon", a.atm.lon, b.atm.lon),
                                  ("lat", a.atm.lat, b.atm.lat),
                                  ("p", a.atm.p, b.atm.p),
                                  ("uvwp", a.cache.uvwp, b.cache.uvwp)):
                    errs[key] = float((x.cpu() - y).abs().max())
                    if not errs[key] <= tols[key]:
                        failed.append(f"{tag}: {key} differs by "
                                      f"{errs[key]:.3e} > {tols[key]:.1e}")
                kpp_on = "Cx" in qnt
                for key in qnt:
                    x, y = a.atm.q[key].cpu().double(), b.atm.q[key].double()
                    kpp_q = kpp_on and (key in KPP_QNT and key != "t")
                    r, at = (KPP_RTOL, KPP_ATOL) if kpp_q else (rtol, 0.0)
                    if key == "mloss_kpp":
                        at = 1e-9
                    bad = ~((x - y).abs() <= at + r * y.abs())
                    errs[key] = float(((x - y).abs()
                                       / y.abs().clamp(min=1e-300)).max())
                    if bool(bad.any()):
                        failed.append(f"{tag}: {key} differs by "
                                      f"{errs[key]:.3e} rel. > {r:.1e}")
                report[tag] = errs
        bits = {}
        for width in (32, 64):
            key = rng.threefry_key(12345)
            x = rng.threefry_bits(key, 0, 1 << 20, width, "cuda").cpu()
            y = rng.threefry_bits(key, 0, 1 << 20, width, "cpu")
            bits[f"bits{width}_equal"] = bool(torch.equal(x, y))
            if not bits[f"bits{width}_equal"]:
                failed.append(f"threefry bits ({width})")
        for dtype, tol in ((f32, 1e-5), (f64, 1e-12)):
            x, _ = rng.module_rng3(2, 12345, 1 << 18, dtype=dtype,
                                   device="cuda")
            y, _ = rng.module_rng3(2, 12345, 1 << 18, dtype=dtype,
                                   device="cpu")
            err = float(((x.cpu() - y).abs() / y.abs()).max())
            bits[f"normal_{dtype}_max_rel_err"] = err
            if not err <= tol:
                failed.append(f"threefry normals ({dtype}) {err:.2e} > "
                              f"{tol:.0e}")
        report["threefry"] = bits
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"card_vs_cpu_slice": report}))
    if failed:
        raise RuntimeError("card vs CPU: " + "; ".join(failed))


def profile_steps(torch, sim, ts2):
    """Where a step's device time goes: by module (CUDA events around
    each module of the pipeline, the random draws counted apart from
    the modules that call them; returned as ms per step) and by kernel
    (torch.profiler, printed)."""
    from torch.profiler import ProfilerActivity, profile as prof

    from mptrac_tpu_torch.physics import (advect, bound, chem, convection,
                                          decay, depo, diffusion, isosurf,
                                          kpp, meteo, mixing, pbl, position,
                                          sedi, timesteps)
    spans = []

    def wrap(mod, name):
        orig = getattr(mod, name)

        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **k)
            e1.record()
            spans.append((name, e0, e1))
            return out

        setattr(mod, name, timed)
        return mod, name, orig

    patched = [wrap(timesteps, "module_timesteps"),
               wrap(position, "module_position"),
               wrap(advect, "module_advect_fused"),
               wrap(advect, "module_advect"),
               wrap(diffusion, "module_rng3"),
               wrap(diffusion, "module_diff_turb"),
               wrap(diffusion, "module_diff_meso"),
               wrap(meteo, "module_meteo"),
               wrap(decay, "module_decay"),
               wrap(convection, "module_rng"),
               wrap(convection, "module_convection"),
               wrap(bound, "module_bound_cond"),
               wrap(mixing, "module_mixing"),
               wrap(chem, "module_chem_grid"),
               wrap(chem, "module_oh_chem"),
               wrap(chem, "module_h2o2_chem"),
               wrap(chem, "module_tracer_chem"),
               wrap(depo, "module_wet_depo"),
               wrap(depo, "module_dry_depo"),
               wrap(pbl, "module_diff_pbl"),
               wrap(sedi, "module_sedi"),
               wrap(isosurf, "module_isosurf"),
               wrap(decay, "module_radio_decay"),
               wrap(kpp, "module_kpp_chem")]
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sim.run(write_output=False, ts=ts2)
        e1.record()
        torch.cuda.synchronize()
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)
    per = {}
    for name, a, b in spans:
        per[name] = per.get(name, 0.0) + a.elapsed_time(b) / len(ts2)
    # the draws run inside the two diffusion modules: take them out
    # (the PBL scheme's draw is not among them: the scheme imports its
    # own name of module_rng3)
    per["module_diff_turb+meso (without rng)"] = (
        per.pop("module_diff_turb") + per.pop("module_diff_meso")
        - per["module_rng3"])
    if "module_convection" in per:
        # ... and the convection's uniform draws from the convection
        per["module_convection (without rng)"] = (
            per.pop("module_convection") - per["module_rng"])
    per["step"] = e0.elapsed_time(e1) / len(ts2)

    ts3 = [ts2[-1] + sim.ctl.dt_mod * (i + 1) for i in range(2)]
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as trace:
        sim.run(write_output=False, ts=ts3)
        torch.cuda.synchronize()
    say(trace.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    return per


def bound_ms(nbytes, ops):
    """(bound_ms, bound_by, by bytes, by operations): the least time the
    card could take, from its published peaks."""
    b_bytes = 1e3 * nbytes / PEAK_BYTES_S
    b_ops = 1e3 * ops / PEAK_F32_OPS_S
    return (max(b_bytes, b_ops),
            "bytes" if b_bytes >= b_ops else "operations", b_bytes, b_ops)


def resort_perm(torch, sim):
    """The permutation of the main path's next re-sort, and how far it
    moves the parcels.  The loop is advanced (outside the counted run)
    to the state that the next sort of ``SORT_DT`` sees, SORT_DT of drift
    after the last one, and the sort's own key is argsorted there."""
    from mptrac_tpu_torch.ops.sort import sort_key

    dt_mod = sim.ctl.dt_mod
    t = float(sim.atm.time[0]) + dt_mod
    ts = []
    while math.fmod(t, SORT_DT) != 0:
        ts.append(t)
        t += dt_mod
    sim.run(write_output=False, ts=ts)
    perm = torch.sort(sort_key(sim.met.pair, sim.atm), stable=True).indices
    n = perm.shape[0]
    d = (perm - torch.arange(n, device=perm.device)).abs_()
    shares = {f"le_{k}": int((d <= k).sum()) / n for k in (32, 4096, 65536)}
    shares["beyond_65536"] = int((d > 65536).sum()) / n
    del d
    say(f"[kernels] re-sort permutation after {len(ts)} more steps "
        f"(drift since the last sort: {SORT_DT:.0f} s): |perm[i] - i| "
        + json.dumps(shares))
    return perm, shares


def phase_kernels(torch, sim, counts, usage):
    """K1-K3 against their plain versions on the main path's tensors."""
    from mptrac_tpu_torch.ops import interp, rk_fused, slab_interp
    from mptrac_tpu_torch.physics.timesteps import module_timesteps

    perm_resort, shares = resort_perm(torch, sim)
    atm, cache, met01, pack = sim.atm, sim.cache, sim.met.pair, sim.pack
    n = atm.npmax
    t_next = float(atm.time[0]) + sim.ctl.dt_mod
    cache = module_timesteps(sim.ctl, cache, met01, atm, t_next)
    cell = pack.cell
    kernels = []

    # ---- K1: every scheme; the main path runs the midpoint scheme
    lon, lat, p, dtp = atm.lon, atm.lat, atm.p, cache.dt
    wt0 = interp.time_weight(met01, atm.time).to(torch.float32)
    #: on the card both sides do the same float32 operations without
    #: contraction (-fmad=false) and share cosf; PyTorch divides by a
    #: constant through its reciprocal, the kernel divides: 2 ulp of a
    #: position (ulp(180 deg) 1.5e-5, ulp(900 hPa) 6.1e-5), 1 ulp of T
    #: (280 K).  Sigma is a statistic of the final cell: 1e-5 where both
    #: sides put the parcel into the same cell; a parcel within an ulp of
    #: a cell face may land on either side, and then sigma is another
    #: cell's.  Those parcels are counted and must stay under 1e-5 of all.
    tol1 = [3.1e-5, 3.1e-5, 1.3e-4, 1e-5, 1e-5, 1e-5, 3.1e-5]

    def final_cell(rows):
        return chunked(lambda a, b, c: (rk_fused.locate_plain(
            cell, a, b, c)[0],), (rows[0], rows[1], rows[2]), n)[0]

    k1 = {}
    for nstage in (1, 2, 4):
        got = torch.stack(list(rk_fused.advect_all(
            cell, nstage, lon, lat, p, dtp, wt0)[0]))
        t_plain0 = time.time()
        exp = chunked(lambda *a: rk_fused.rk_plain(cell, nstage, *a),
                      (lon, lat, p, dtp, wt0), n)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t_plain0)
        same = final_cell(got) == final_cell(exp)
        crossers = int((~same).sum())
        errs = [max_err(got[r], exp[r], torch) if r not in (3, 4, 5)
                else max_err(got[r][same], exp[r][same], torch)
                for r in range(7)]
        if crossers > 1e-5 * n:
            raise RuntimeError(f"K1 nstage {nstage}: {crossers} parcels "
                               "end in another cell than the plain "
                               "version's")
        del got, exp, same
        for r, (e, tol) in enumerate(zip(errs, tol1)):
            if not e <= tol:
                raise RuntimeError(f"K1 nstage {nstage} row {r}: max abs "
                                   f"err {e:.3e} > {tol:.1e}")
        ms = time_ms(lambda: rk_fused.advect_all(
            cell, nstage, lon, lat, p, dtp, wt0), torch)
        # bound: 5 inputs + 7 outputs streamed once, the table and the
        # axes read once; operations with the axis search counted as a
        # binary search (the least any implementation needs)
        nbytes = n * 48 + cell.table.numel() * 4 + (cell.ny + cell.npl) * 4
        search = math.ceil(math.log2(cell.npl)) + (
            4 if cell.lat_reg else math.ceil(math.log2(cell.ny)))
        per_locate = 19 + search
        ops = n * (nstage * (per_locate + 6 * 21 + 9 + 6 + 20)
                   + per_locate + 2 * 21 + 3 + 159 + 25)
        attrs = rk_fused.kernel_attributes(cell, nstage)
        ptxas = [u for name, u in usage.items()
                 if "rk_kernel" in name and f"ILi{nstage}E" in name]
        k1[nstage] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                          bytes=nbytes, operations=ops,
                          cell_crossers=crossers,
                          registers=attrs["registers"],
                          spills=(ptxas[0].get("spill_stores", 0)
                                  + ptxas[0].get("spill_loads", 0)
                                  if ptxas else None),
                          local_bytes=attrs["local_bytes"],
                          blocks_per_sm=attrs["blocks_per_sm"])
    main_stage = sim.ctl.advect
    b, by, b_bytes, b_ops = bound_ms(k1[main_stage]["bytes"],
                                     k1[main_stage]["operations"])
    kernels.append(dict(
        name="rk_fused_advect", route="cuda",
        source="mptrac_tpu_torch/csrc/rk_fused.cu",
        replaces="mptrac_tpu/ops/rk_fused.py:256",
        launches=counts["rk_fused_advect"],
        max_abs_err=k1[main_stage]["max_abs_err"],
        ms=k1[main_stage]["ms"], plain_ms=k1[main_stage]["plain_ms"],
        bound_ms=b, bound_by=by,
        library_ms=None, n=n, nstage=main_stage,
        bound_bytes_ms=b_bytes, bound_operations_ms=b_ops,
        bytes_per_parcel=48, tolerance=tol1,
        cell_crossers=k1[main_stage]["cell_crossers"],
        registers=k1[main_stage]["registers"],
        spills=k1[main_stage]["spills"],
        blocks_per_sm=k1[main_stage]["blocks_per_sm"],
        variants={str(k): {kk: v[kk] for kk in (
            "max_abs_err", "ms", "plain_ms", "cell_crossers", "registers",
            "spills", "local_bytes", "blocks_per_sm")}
            for k, v in k1.items()}))

    # ---- K2: the main path's fields (pbl, ps) at its located parcels,
    # on a table with structure and NaNs: one corner of pbl in snapshot
    # 1, and all of ps in snapshot 0
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    nx, ny = pack.sfcT.shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    table = torch.rand(pack.sfcT.shape, device="cuda", generator=gen) \
        * 1000.0 + 1.0
    fields = (slab_interp.SFC_FIELDS.index("pbl"),
              slab_interp.SFC_FIELDS.index("ps"))
    table[nx // 3, ny // 2, 1, fields[0]] = float("nan")
    table[:, :, 0, fields[1]] = float("nan")
    basexy = (loc.ix * ny + loc.iy).to(torch.int32)
    w3 = (loc.wx.contiguous(), loc.wy.contiguous(), wt0)
    del loc
    got = slab_interp.interp_sfc(table, basexy, w3, fields)
    t_plain0 = time.time()
    exp = chunked(
        lambda b, wx, wy, wt: slab_interp.sfc_interp_plain(
            table, b, wx, wy, wt, fields), (basexy,) + w3, n)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t_plain0)
    #: same float32 operations without contraction: 2 ulp of values up
    #: to 1001 (ulp 6.1e-5)
    tol2 = 1.3e-4
    err2 = max_err(got, exp, torch)
    if not err2 <= tol2:
        raise RuntimeError(f"K2: max abs err {err2:.3e} > {tol2:.1e}")
    # ps: snapshot 0 is all NaN, so the value is snapshot 1's wherever
    # that is the nearer one (wt < 0.5), and NaN elsewhere
    if not bool((torch.isfinite(got[1]) == (wt0 < 0.5)).all()):
        raise RuntimeError("K2: the NaN snapshot was not bridged")
    nan_parcels = int(torch.isnan(got[0]).sum())
    del got, exp
    ms2 = time_ms(lambda: slab_interp.interp_sfc(table, basexy, w3, fields),
                  torch)
    nbytes2 = n * (4 + 12 + 4 * len(fields)) + nx * ny * 2 * len(fields) * 4
    # per field: 2 snapshots x (7 lerp operations + 4 finite tests
    # + 3 selects) + the time lerp and its selects
    ops2 = n * len(fields) * 33
    b, by, _, _ = bound_ms(nbytes2, ops2)
    kernels.append(dict(
        name="sfc_interp", route="cuda",
        source="mptrac_tpu_torch/csrc/sfc_interp.cu",
        replaces="mptrac_tpu/ops/slab_interp.py:303",
        launches=counts["sfc_interp"], max_abs_err=err2, ms=ms2,
        plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None, n=n, nfields=len(fields),
        bytes_per_parcel=16 + 4 * len(fields), tolerance=tol2,
        nan_parcels_pbl=nan_parcels))
    del table, basexy, w3

    # ---- K3: every state column of the sort, on a random and on a
    # banded permutation (blocks of 4096 shuffled within themselves), and
    # on the main path's own re-sort; each as planned and on each path
    # forced, every result against the plain gather bit for bit, and the
    # count pass that plans it against the plain count
    cols = [cache.uvwp[0], cache.uvwp[1], cache.uvwp[2], atm.lon, atm.lat,
            atm.p, cache.dt] + [atm.q[k] for k in atm.q]
    stacked = torch.stack(cols)
    k3 = {}
    for kind in ("random", "banded", "resort"):
        if kind == "random":
            perm = torch.randperm(n, device="cuda", generator=gen)
        elif kind == "resort":
            perm, perm_resort = perm_resort, None
        else:
            blk = torch.arange(n, device="cuda", dtype=torch.float64)
            blk = torch.div(blk, 4096, rounding_mode="floor") + torch.rand(
                n, device="cuda", dtype=torch.float64, generator=gen)
            perm = torch.sort(blk).indices
            del blk
        sectors = slab_interp.permute_sectors(perm)
        sampled = slab_interp.permute_sampled(n)
        sectors_plain = slab_interp.permute_sectors_plain(perm)
        if sectors != sectors_plain:
            raise RuntimeError(f"K3 count pass ({kind}): {sectors} sectors, "
                               f"the plain count {sectors_plain}")
        plan = slab_interp.permute_plan(perm)
        exp32, exp64 = slab_interp.permute_cols_plain(cols, perm, atm.time)
        for force in (None, "rows", "gather"):
            got32, got64 = slab_interp.permute_cols(cols, perm, atm.time,
                                                    plan=force)
            if not (bool(torch.equal(got32, exp32))
                    and bool(torch.equal(got64, exp64))):
                raise RuntimeError(f"K3 ({kind}, path {force or plan}): "
                                   "permuted state differs")
            del got32, got64
        del exp32, exp64
        ms = time_ms(lambda: slab_interp.permute_cols(cols, perm, atm.time),
                     torch, repeats=3)
        by_path = {p: time_ms(lambda: slab_interp.permute_cols(
            cols, perm, atm.time, plan=p), torch, repeats=3)
            for p in ("rows", "gather")}
        count_ms = time_ms(lambda: slab_interp.permute_sectors(perm), torch,
                           repeats=3)
        count_plain_ms = time_ms(
            lambda: slab_interp.permute_sectors_plain(perm), torch,
            repeats=3)
        plain = time_ms(lambda: slab_interp.permute_cols_plain(
            cols, perm, atm.time), torch, repeats=3)
        lib = time_ms(lambda: (torch.index_select(stacked, 1, perm),
                               torch.index_select(atm.time, 0, perm)),
                      torch, repeats=3)
        k3[kind] = dict(ms=ms, plain_ms=plain, library_ms=lib, path=plan,
                        ms_by_path=by_path, sectors=sectors,
                        sectors_per_output=sectors / sampled,
                        count_ms=count_ms,
                        count_plain_ms=count_plain_ms)
        say(f"[kernels] K3 {kind}: " + json.dumps(k3[kind]))
        del perm
    per_parcel = 8 + 8 * len(cols) + 16
    b_bytes = bound_ms(n * per_parcel, 0)[0]
    rw = slab_interp.permute_row_words(len(cols), True)
    # the count pass reads perm at the outputs it samples (8 B each), its
    # compares and adds far below that
    sampled = slab_interp.permute_sampled(n)
    b_count, by_count, _, _ = bound_ms(sampled * 8, sampled * 4)
    kernels.append(dict(
        name="permute_cols", route="cuda",
        source="mptrac_tpu_torch/csrc/permute_cols.cu",
        replaces="mptrac_tpu/ops/slab_interp.py:303",
        launches=(counts["permute_gather"] + counts["permute_pack"]
                  + counts["permute_rows"]),
        launches_by_kernel={k: counts[f"permute_{k}"]
                            for k in ("gather", "pack", "rows")},
        max_abs_err=0.0,
        ms=k3["random"]["ms"], plain_ms=k3["random"]["plain_ms"],
        bound_ms=b_bytes, bound_by="bytes",
        library_ms=k3["random"]["library_ms"], n=n,
        columns_f32=len(cols), columns_f64=1,
        bytes_per_parcel=per_parcel, tolerance=0.0,
        ms_banded=k3["banded"]["ms"],
        plain_ms_banded=k3["banded"]["plain_ms"],
        library_ms_banded=k3["banded"]["library_ms"],
        ms_resort=k3["resort"]["ms"],
        plain_ms_resort=k3["resort"]["plain_ms"],
        library_ms_resort=k3["resort"]["library_ms"],
        resort_displacement_shares=shares,
        paths={k: v["path"] for k, v in k3.items()},
        ms_by_path={k: v["ms_by_path"] for k, v in k3.items()},
        sectors_per_output={k: v["sectors_per_output"]
                            for k, v in k3.items()},
        row_bytes=4 * rw, scratch_bytes=4 * rw * n,
        count_kernel=dict(
            launches=counts["permute_count"], max_abs_err=0,
            ms=k3["random"]["count_ms"],
            plain_ms=k3["random"]["count_plain_ms"], bound_ms=b_count,
            bound_by=by_count, library_ms=None,
            ms_by_permutation={k: v["count_ms"] for k, v in k3.items()})))
    return kernels


def phase_kernels_unfused(torch, sim, counts):
    """K4 and K5 against their plain versions on the unfused path's
    tensors, and K6 and K7, the same functions on other table layouts,
    driven once through their public functions and then compared."""
    from mptrac_tpu_torch.ops import (_cuda, fast_interp, interp,
                                      lane_interp, pallas_interp,
                                      slab_interp)

    atm, met01, table = sim.atm, sim.met.pair, sim.pack.packT
    n = atm.npmax
    npl, nx, ny = table.shape[:3]
    gen = torch.Generator(device="cuda").manual_seed(2)
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    cell = slab_interp.cell_from_loc(table, loc)
    base = ((loc.ix * ny + loc.iy) * npl + loc.iz).to(torch.int32)
    wt = interp.time_weight(met01, atm.time).to(torch.float32)
    w4 = (loc.wx.contiguous(), loc.wy.contiguous(), loc.wz.contiguous(), wt)
    del loc
    # a second table of the same shape with structure in all 8 fields
    # (the flagship's w is 0 and its T uniform)
    rtable = torch.rand(table.shape, device="cuda", generator=gen) \
        * 100.0 - 50.0
    #: same float32 operations without contraction on both sides: 2 ulp
    #: of the largest value (280 K: ulp 3.1e-5; winds and the random
    #: table stay under 64: ulp 3.8e-6)
    tol_uvw, tol_t = 7.7e-6, 6.2e-5
    kernels = []

    def timed_plain(fn, tensors):
        t0 = time.time()
        exp = chunked(fn, tensors, n)
        torch.cuda.synchronize()
        return exp, 1e3 * (time.time() - t0)

    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
              ops, per_parcel, tol, **more):
        b, by, b_bytes, b_ops = bound_ms(nbytes, ops)
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                    library_ms=None, n=n, bound_bytes_ms=b_bytes,
                    bound_operations_ms=b_ops, bytes_per_parcel=per_parcel,
                    tolerance=tol, **more)

    def check(name, got, exp, tols):
        errs = [max_err(got[r], exp[r], torch) for r in range(got.shape[0])]
        for r, (e, tol) in enumerate(zip(errs, tols)):
            if not e <= tol:
                raise RuntimeError(f"{name} row {r}: max abs err {e:.3e} "
                                   f"> {tol:.1e}")
        return max(errs)

    # ---- K4 on the path's table and on the random one
    err4, plain4 = 0.0, 0.0
    for tag, tab in (("path", table), ("random", rtable)):
        got = slab_interp.interp_uvwt(tab, cell, w4)
        exp, plain4 = timed_plain(
            lambda c, *w: slab_interp.uvwt_interp_plain(tab, c, *w),
            (cell,) + w4)
        err4 = max(err4, check(f"K4 ({tag} table)", got, exp,
                               [tol_uvw] * 3 + [tol_t]))
        if tag == "path":
            uvwt_path = got
        del exp
    ms4 = time_ms(lambda: slab_interp.interp_uvwt(table, cell, w4), torch)
    # the cost of losing the sort: the same parcels in a random order
    perm = torch.randperm(n, device="cuda", generator=gen)
    cell_r = cell[perm]
    w4_r = tuple(x[perm] for x in w4)
    got_r = slab_interp.interp_uvwt(table, cell_r, w4_r)
    if not bool(torch.equal(got_r, uvwt_path[:, perm])):
        raise RuntimeError("K4: a random parcel order changes the values")
    del got_r
    ms4_r = time_ms(lambda: slab_interp.interp_uvwt(table, cell_r, w4_r),
                    torch)
    del cell_r, w4_r, perm
    tbytes = table.numel() * 4
    # 8 fields x 21 operations in space, 4 time interpolations x 3
    kernels.append(entry(
        "uvwt_interp", "mptrac_tpu_torch/csrc/uvwt_interp.cu",
        "mptrac_tpu/ops/slab_interp.py:303", counts["uvwt_interp"], err4,
        ms4, plain4, n * 36 + tbytes, n * 180, 36, [tol_uvw, tol_t],
        ms_random_order=ms4_r))

    # ---- K5: the table of every cell's sigma (once per met pair) and the
    # gather from it, on the path's table (the cancelling case) and on the
    # random one, in the path's order and in a random order; bit for bit
    # against the plain versions
    sigT_path = sim.pack.sigT
    ncell = npl * nx * ny
    perm = torch.randperm(n, device="cuda", generator=gen)
    cell_r = cell[perm]
    plain5, plain5t = 0.0, 0.0
    for tag, tab in (("path", table), ("random", rtable)):
        t0 = time.time()
        plainT = slab_interp.sigma_table_plain(tab)
        torch.cuda.synchronize()
        plain5t = 1e3 * (time.time() - t0)
        sigT = slab_interp.sigma_table(tab)
        if not bool(torch.equal(sigT, plainT)):
            raise RuntimeError(f"K5 table kernel ({tag} table) differs from "
                               "sigma_table_plain")
        if tag == "path" and not bool(torch.equal(sigT, sigT_path)):
            raise RuntimeError("K5: the path's table differs from a table "
                               "built again")
        exp, plain5 = timed_plain(
            lambda c: slab_interp.meso_sigma_plain(tab, c), (cell,))
        got = slab_interp.meso_sigma(tab, cell, sigT)
        if not bool(torch.equal(got, exp)):
            raise RuntimeError(f"K5 gather ({tag} table) differs from "
                               "meso_sigma_plain")
        if not bool(torch.equal(slab_interp.meso_sigma(tab, cell_r, sigT),
                                exp[:, perm])):
            raise RuntimeError(f"K5 gather ({tag} table): a random parcel "
                               "order changes the values")
        if tag == "path":
            sig_path = got
            sig_max = float(got.max())
        del exp, plainT, got, sigT
    if not 0.0 < sig_max < 10.0:
        raise RuntimeError(f"K5: largest sigma {sig_max} on the flagship's "
                           "wind is not a subgrid standard deviation")
    ms5 = time_ms(lambda: slab_interp.meso_sigma(table, cell, sigT_path),
                  torch)
    ms5_r = time_ms(lambda: slab_interp.meso_sigma(table, cell_r, sigT_path),
                    torch)
    ms5t = time_ms(lambda: slab_interp.sigma_table(table), torch)
    del cell_r, perm
    sig_bytes = sigT_path.numel() * 4
    # the gather: 4 B of cell in, 12 B out a parcel, the sigma table once;
    # no arithmetic
    kernels.append(entry(
        "meso_sigma", "mptrac_tpu_torch/csrc/meso_sigma.cu",
        "mptrac_tpu/ops/slab_interp.py:303", counts["meso_sigma"], 0.0,
        ms5, plain5, n * 16 + sig_bytes, 0, 16, 0.0, sigma_max=sig_max,
        layout="rows [ncell, 4]", scratch_bytes=sig_bytes,
        ms_random_order=ms5_r, ms_table_build=ms5t,
        launches_by_kernel={k: counts[k] for k in ("meso_sigma_table",
                                                    "meso_sigma")}))
    # the table: the wind table read once, the sigma table written once,
    # 159 operations a cell
    kernels.append(entry(
        "meso_sigma_table", "mptrac_tpu_torch/csrc/meso_sigma.cu",
        "mptrac_tpu/ops/slab_interp.py:303", counts["meso_sigma_table"],
        0.0, ms5t, plain5t, tbytes + sig_bytes, ncell * 159, None, 0.0,
        n_cells=ncell))
    del rtable

    # ---- K6, K7: no module reaches them.  Their path is their public
    # functions, called once each on the unfused path's parcels.
    w4s = torch.stack(w4)                          # [4, n]
    w4t = w4s.T.contiguous()                       # [n, 4]
    del w4
    _cuda.reset_launch_counts()                    # the ops path starts
    t0 = time.time()
    lanes = lane_interp.build_lane_tables(met01)
    pack8 = fast_interp.build_advect_pack(met01)
    uvw6, t6, served6 = lane_interp.interp_uvwt_sorted(lanes, base, w4s)
    sig6, served6m = lane_interp.meso_sigma_sorted(lanes, base)
    uvw7, ok7 = pallas_interp.interp_uvw_sorted(pack8, base, w4t,
                                                (ny * npl, npl))
    torch.cuda.synchronize()
    ops_s = time.time() - t0
    ops_counts = dict(_cuda.launch_counts)         # ... and ends here
    for name in ("lane_interp_uvwt", "lane_meso_sigma", "uvw_rows_interp"):
        if ops_counts[name] != 1:
            raise RuntimeError(f"ops path: {name} launched "
                               f"{ops_counts[name]} times, expected 1")
    if (served6, served6m) != (1.0, 1.0) or not bool(ok7.all()):
        raise RuntimeError("K6/K7: a parcel was not served")
    for name, x in (("K6 uvw", uvw6), ("K6 t", t6), ("K6 sigma", sig6),
                    ("K7 uvw", uvw7)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"ops path: non-finite values in {name}")
    # the same function on another table layout: the same values
    if not (bool(torch.equal(uvw6, uvwt_path[0:3]))
            and bool(torch.equal(t6, uvwt_path[3]))
            and bool(torch.equal(sig6, sig_path))
            and bool(torch.equal(uvw7.T, uvwt_path[0:3]))):
        raise RuntimeError("K6/K7 differ from K4/K5 on the same parcels")
    del uvwt_path, sig_path, uvw7, ok7
    say(json.dumps({"ops_path": {
        "n_parcels": n, "grid": list(GRID), "seconds": ops_s,
        "table64_bytes": lanes.pack64.numel() * 4,
        "table8_bytes": pack8.numel() * 4, "launches": ops_counts,
        "equal_to_K4_K5": True}}))

    rows4 = tuple(w4s[k] for k in range(4))
    got = torch.cat([uvw6, t6[None]])
    del uvw6, t6
    exp, plain6 = timed_plain(
        lambda b, *w: lane_interp.interp_uvwt_plain(lanes.pack64, b,
                                                    torch.stack(w)),
        (base,) + rows4)
    err6 = check("K6 interp", got, exp, [tol_uvw] * 3 + [tol_t])
    del got, exp
    # the sigma mode: one sigma16 a run of equal cells, the same sums in
    # the same order as the plain version, so bit for bit; in a random
    # parcel order too
    exp, plain6m = timed_plain(
        lambda b: lane_interp.meso_sigma_plain(lanes.pack64, b), (base,))
    if not bool(torch.equal(sig6, exp)):
        raise RuntimeError("K6 sigma differs from meso_sigma_plain")
    err6m = 0.0
    perm = torch.randperm(n, device="cuda", generator=gen)
    base_r = base[perm]
    sig6_r, _ = lane_interp.meso_sigma_sorted(lanes, base_r)
    if not bool(torch.equal(sig6_r, exp[:, perm])):
        raise RuntimeError("K6 sigma: a random parcel order changes the "
                           "values")
    del sig6, sig6_r, exp, perm
    runs6 = int(torch.unique_consecutive(base).numel())
    cells6 = int(torch.unique(base).numel())
    ms6 = time_ms(lambda: lane_interp.interp_uvwt_sorted(lanes, base, w4s),
                  torch)
    ms6m = time_ms(lambda: lane_interp.meso_sigma_sorted(lanes, base), torch)
    ms6m_r = time_ms(lambda: lane_interp.meso_sigma_sorted(lanes, base_r),
                     torch)
    del base_r
    # the rows of the cells that hold parcels, each read once: 256 bytes
    # for the interpolation; the sigma reads a row's 48 wind lanes, not
    # its 16 T lanes, and does 159 operations a run of parcels in a cell
    b6m = bound_ms(n * 16 + cells6 * 192, runs6 * 159)
    kernels.append(entry(
        "lane_interp", "mptrac_tpu_torch/csrc/lane_interp.cu",
        "mptrac_tpu/ops/lane_interp.py:65",
        ops_counts["lane_interp_uvwt"] + ops_counts["lane_meso_sigma"],
        max(err6, err6m), ms6, plain6, n * 36 + cells6 * 256, n * 180, 36,
        [tol_uvw, tol_t, 0.0], mode="interp",
        launches_by_mode={"interp": ops_counts["lane_interp_uvwt"],
                          "meso": ops_counts["lane_meso_sigma"]},
        meso={"max_abs_err": err6m, "ms": ms6m, "plain_ms": plain6m,
              "ms_random_order": ms6m_r, "parcels_per_run": n / runs6,
              "cells_touched": cells6,
              "bound_ms": b6m[0], "bound_by": b6m[1],
              "bytes_per_parcel": 16}))
    del lanes

    got = pallas_interp.interp_uvw_sorted(pack8, base, w4t,
                                          (ny * npl, npl))[0].T
    exp, plain7 = timed_plain(
        lambda b, *w: pallas_interp.interp_uvw_plain(
            pack8, b, torch.stack(w, dim=1), (ny * npl, npl)).T,
        (base,) + rows4)
    err7 = check("K7", got, exp, [tol_uvw] * 3)
    del got, exp
    ms7 = time_ms(lambda: pallas_interp.interp_uvw_sorted(
        pack8, base, w4t, (ny * npl, npl)), torch)
    # 6 fields x 21 operations in space, 3 time interpolations x 3
    kernels.append(entry(
        "uvw_rows_interp", "mptrac_tpu_torch/csrc/uvw_rows.cu",
        "mptrac_tpu/ops/pallas_interp.py:34", ops_counts["uvw_rows_interp"],
        err7, ms7, plain7, n * 32 + pack8.numel() * 4, n * 135, 32,
        tol_uvw))
    return kernels


def phase_card_vs_cpu(torch):
    """10 steps at the tests' size on the card and on the CPU, for the
    fused path, the unfused path and the exact float64 path, held to
    the ten-step tolerances of tests/test_torch_step.py, and for the
    chemistry step (phys ``chem``) on the fused path and on the exact
    float64 path.  The unfused and the exact path run on a humid met
    (q = 4e-3) and sample rh and sh, so the humidity branch of
    module_meteo runs on the card."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.ops import thermo
    from mptrac_tpu_torch.sim import FixedMet, Simulation

    f32, f64 = torch.float32, torch.float64
    #: float32: the two sides differ by the math libraries' cos, log,
    #: exp (a few ulp of a position per step).  float64: the normals
    #: are drawn through single-precision log, cos and sin in this mode
    #: too (the reference's Box-Muller), so they differ by a few
    #: float32 ulp (~5e-7 of a normal up to 5) between two math
    #: libraries, times a step's random displacement (~1e-2 deg, a few
    #: hPa), over ten steps; T is uniform, m is one exp per step.
    #: rh follows p (36 % at 900 hPa: 4e-2 % per hPa); sh is uniform.
    tols32, tols64 = TOLS_F32, TOLS_F64
    humid = ("NQ", "4", "QNT_NAME[2]", "rh", "QNT_NAME[3]", "sh")
    q_humid = 4e-3
    report = {}
    for path, fast, dtype, tols, q, phys in (
            ("fused", "2", f32, tols32, 0.0, "base"),
            ("unfused", "1", f32, tols32, q_humid, "base"),
            ("exact_f64", "0", f64, tols64, q_humid, "base"),
            ("chem_fused", "2", f32, TOLS_CHEM_F32, 0.0, "chem"),
            ("chem_exact_f64", "0", f64, tols64, 0.0, "chem")):
        out = {}
        for dev in ("cuda", "cpu"):
            ctl, clim, met01, atm, cache = flagship.make_setup(
                2048, nx=36, ny=19, nz=8,
                extra_args=("SORT_DT", "900", "TPU_FAST", fast)
                + (humid if q else ()), device=dev, dtype=dtype, q=q,
                phys=phys)
            sim = Simulation(ctl, atm, clim, met=FixedMet(met01),
                             cache=cache)
            sim.sort()
            sim.run(write_output=False,
                    ts=[ctl.dt_mod * (i + 1) for i in range(10)])
            out[dev] = sim
        a, b = out["cuda"], out["cpu"]
        if a.cache.rng_ctr != b.cache.rng_ctr or a.nsorts != b.nsorts:
            raise RuntimeError(f"card vs CPU ({path}): rng_ctr or sort "
                               "count differ")
        if a.atm.lon.dtype != dtype:
            raise RuntimeError(f"card vs CPU ({path}): state is "
                               f"{a.atm.lon.dtype}, not {dtype}")
        errs = {}
        pairs = [("lon", a.atm.lon, b.atm.lon), ("lat", a.atm.lat, b.atm.lat),
                 ("p", a.atm.p, b.atm.p), ("t", a.atm.q["t"], b.atm.q["t"]),
                 ("m", a.atm.q["m"], b.atm.q["m"]),
                 ("uvwp", a.cache.uvwp, b.cache.uvwp)]
        if q:
            pairs += [(k, a.atm.q[k], b.atm.q[k]) for k in ("rh", "sh")]
            # the card's own values: humidity of a uniform mixing ratio
            h2o = torch.full_like(a.atm.p, q)
            want = {"rh": thermo.rh(a.atm.p, a.atm.q["t"], h2o),
                    "sh": thermo.sh(h2o)}
            for k, w in want.items():
                rel = float((a.atm.q[k] / w - 1.0).abs().max())
                if not (rel <= 1e-5 and float(w.min()) > 0.0):
                    raise RuntimeError(f"card vs CPU ({path}): sampled {k} "
                                       f"is off by {rel:.2e} rel.")
        for name, x, y in pairs:
            errs[name] = float((x.cpu() - y).abs().max())
            if not errs[name] <= tols[name]:
                raise RuntimeError(
                    f"card vs CPU ({path}): {name} differs by "
                    f"{errs[name]:.3e} > {tols[name]:.1e}")
        if phys == "chem" and not float(a.atm.q["m"].min()) < math.exp(
                -10 * ctl.dt_mod / ctl.tdec_trop) * (1.0 - 1e-6):
            raise RuntimeError(f"card vs CPU ({path}): no loss beyond the "
                               "decay")
        report[path] = {"max_abs_err": errs,
                        "tolerance": {k: tols[k] for k in errs}}
    say(json.dumps({"card_vs_cpu": {"steps": 10, "n_parcels": 2048,
                                    "paths": report}}))


# ----------------------------------------------------- run_trac from files

#: the trac path's clock: met snapshots at 0, 3600 and 7200 s (file names
#: carry the hour), the run from T_TRAC_START over one met swap (the step at
#: 3780 s is the first past the second snapshot) to its stop; both sorts of
#: SORT_DT 1800 fall on the first step and on the step at 3600 s
DT_MET = 3600.0
T_TRAC_START = 1800.0
T_TRAC_STOP = 4500.0


def disk_cut(tmp, n, per_parcel, tag):
    """Parcels that the temporary space holds (a multiple of 2^21)."""
    free = shutil.disk_usage(tmp).free
    fit = int((0.9 * free - 2e9) // per_parcel) // (1 << 21) * (1 << 21)
    n_run = min(n, fit)
    if n_run < (1 << 21) and n_run < n:
        raise RuntimeError(f"{tag}: {free} bytes of temporary space hold no "
                           "particle file")
    return n_run, (f" (cut from {n}: {free} bytes free)" if n_run < n
                   else "")


def run_trac_tool(torch, argv, tag):
    """``tools.trac`` on ``argv``, with CUDA events around every step of
    the loop and every table build (measurement only: the run itself is
    the tool's).  Peak memory and the launch counts are reset just before
    and read just after.  Returns (sim, steps, builds, counts, peak,
    run_s); each step a dict of its ``ms`` and of how many met files were
    read, sorts run, and whether it wrote the output."""
    from mptrac_tpu_torch import sim as simmod
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.tools import trac

    steps, builds, holder = [], [], {}
    advance, build_pack = simmod.Simulation.advance, simmod.build_pack

    def timed_advance(self, t, write_output=True):
        holder["sim"] = self
        reads = len(self.met.reads)
        sorts = self.nsorts
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        advance(self, t, write_output)
        e1.record()
        steps.append(dict(t=t, e0=e0, e1=e1,
                          met_files=len(self.met.reads) - reads,
                          sorted=self.nsorts - sorts,
                          output=t == self.ctl.t_stop))

    def timed_build_pack(ctl, met01):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = build_pack(ctl, met01)
        e1.record()
        builds.append((e0, e1))
        return out

    simmod.Simulation.advance = timed_advance
    simmod.build_pack = timed_build_pack
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()              # the path starts here
    t0 = time.time()
    try:
        rc = trac.main(argv)
    finally:
        simmod.Simulation.advance = advance
        simmod.build_pack = build_pack
    torch.cuda.synchronize()
    run_s = time.time() - t0
    counts = dict(_cuda.launch_counts)       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"{tag}: tools.trac returned {rc}")
    for st in steps:
        st["ms"] = st.pop("e0").elapsed_time(st.pop("e1"))
    return holder["sim"], steps, builds, counts, peak, run_s


def phase_trac_path(torch, n):
    """``tools.trac`` from files on the card at full size, float32 state,
    the fused path, across one met swap.  The case's directory is kept for
    the phases that run on its files (``tmp`` of the summary returned);
    the caller removes it."""
    import numpy as np

    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io

    tmp = tempfile.mkdtemp(prefix="mptrac_trac_")
    kept = False
    try:
        # the particle file in and out (6 float64 columns each) and the
        # met files must fit the temporary space
        n_run, cut = disk_cut(tmp, n, 2 * 6 * 8, "trac path")
        t0 = time.time()
        dirlist = flagship.write_case(
            tmp, n_run, GRID, T_TRAC_START, T_TRAC_STOP, int(SORT_DT),
            DT_MET, ("TPU_FAST", "2"))
        setup_s = time.time() - t0
        sizes = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
        say(f"[trac] {n_run} parcels{cut}; files written in "
            f"{setup_s:.1f} s: " + ", ".join(
                f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items()))

        sim, steps, builds, counts, peak, run_s = run_trac_tool(
            torch, ["trac", dirlist, "trac.ctl", "atm_in.bin", "--device",
                    "cuda", "--dtype", "float32"], "trac path")
        ctl = sim.ctl
        nadv = len(steps)
        want_adv = int(round((T_TRAC_STOP - T_TRAC_START) / ctl.dt_mod)) + 1
        if nadv != want_adv:
            raise RuntimeError(f"trac path: {nadv} steps, expected "
                               f"{want_adv}")
        swap = [st for st in steps[1:] if st["met_files"]]
        if (len(sim.met.reads) != 3 or len(swap) != 1
                or tuple(sim.met.pair.time) != (DT_MET, 2 * DT_MET)):
            raise RuntimeError(
                f"trac path: the run did not cross one met swap (files "
                f"{[r['file'] for r in sim.met.reads]}, pair "
                f"{sim.met.pair.time})")
        if sim.nsorts != 2 or counts["permute_count"] != 2:
            raise RuntimeError(f"trac path: {sim.nsorts} sorts, K3 count "
                               f"passes {counts['permute_count']}, "
                               "expected 2")
        if counts["rk_fused_advect"] != nadv or counts["sfc_interp"] < nadv:
            raise RuntimeError(
                f"trac path: K1 launches {counts['rk_fused_advect']}, K2 "
                f"{counts['sfc_interp']} in {nadv} steps")
        if len(builds) != 2:
            raise RuntimeError(f"trac path: {len(builds)} table builds, "
                               "expected one per met pair (2)")
        # steps with nothing but the timestep: no file read, no sort, no
        # particle output
        plain = [st["ms"] for st in steps[1:]
                 if not (st["met_files"] or st["sorted"] or st["output"])]

        # the output: one binary particle file at the stop time
        outs = sorted(f for f in os.listdir(tmp)
                      if f.startswith("atm_") and f != "atm_in.bin")
        if outs != ["atm_2000_01_01_01_15_00.bin"]:
            raise RuntimeError(f"trac path: output files {outs}")
        back = atm_io.read_atm(os.path.join(tmp, outs[0]),
                               read_ctl(os.path.join(tmp, "trac.ctl")),
                               device="cpu")
        if back.np != n_run:
            raise RuntimeError(f"trac path: {back.np} parcels read back, "
                               f"{n_run} written")
        for name, x in (("lon", back.lon), ("lat", back.lat), ("p", back.p),
                        ("t", back.q["t"]), ("m", back.q["m"])):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"trac path: non-finite {name} in the "
                                   "output file")
        if not (float(back.lon.min()) >= -180.0
                and float(back.lon.max()) <= 180.0
                and float(back.lat.abs().max()) <= 90.0
                and float(back.p.min()) > 0.0):
            raise RuntimeError("trac path: positions out of range")
        if not float((back.time - T_TRAC_STOP).abs().max()) == 0.0:
            raise RuntimeError("trac path: parcel times did not reach the "
                               "stop time")
        # the first step has dt = 0; every later one decays the mass
        want_m = math.exp(-ctl.dt_mod / ctl.tdec_trop) ** (nadv - 1)
        m_err = float((back.q["m"] / want_m - 1.0).abs().max())
        t_err = float((back.q["t"] - 280.0).abs().max())
        if not (m_err < 1e-5 and t_err < 1e-2):
            raise RuntimeError(f"trac path: mass off by {m_err:.2e} rel., "
                               f"T by {t_err:.2e} K")
        same = bool(torch.equal(back.lon.to(torch.float32),
                                sim.atm.lon.cpu()))
        if not same:
            raise RuntimeError("trac path: the output file does not hold "
                               "the final state")
        del back
        timers = sim.timers.as_dict()
        sim.timers.report(log=lambda line: say("[trac] " + line))
        say(json.dumps({"trac_path": {
            "n_parcels": n_run, "n_parcels_asked": n, "grid": list(GRID),
            "steps": nadv, "run_s": run_s, "files_written_s": setup_s,
            "met_files": sim.met.reads,
            "read_atm_s": timers["READ_ATM"]["total"],
            "write_atm_s": timers["WRITE_OUTPUT"]["max"],
            "ms_per_step": float(np.mean(plain)),
            "ms_per_step_min_max": [min(plain), max(plain)],
            "ms_step_at_swap": swap[0]["ms"],
            "ms_first_step": steps[0]["ms"],
            "ms_last_step_with_output": steps[-1]["ms"],
            "ms_steps": [round(st["ms"], 3) for st in steps],
            "step_tags": [("first " if i == 0 else "")
                          + ("swap " if st["met_files"] and i else "")
                          + ("sort " if st["sorted"] else "")
                          + ("output" if st["output"] else "")
                          for i, st in enumerate(steps)],
            "pack_rebuild_ms": [a.elapsed_time(b) for a, b in builds],
            "resorts": sim.nsorts,
            "peak_memory_allocated_bytes": peak, "launches": counts,
            "mass_rel_err": m_err, "timers": timers}}))
        kept = True
        return {"ms_per_step": float(np.mean(plain)),
                "ms_per_step_min_max": [min(plain), max(plain)],
                "peak": peak, "ms_step_at_swap": swap[0]["ms"], "tmp": tmp,
                "n_parcels": n_run, "dirlist": dirlist, "output": outs[0]}
    finally:
        if not kept:
            shutil.rmtree(tmp, ignore_errors=True)


def phase_trac_vs_cpu(torch):
    """``run_trac`` from files at the tests' size on the card and on the
    CPU: 10 steps across a met swap, float32 on the fused path and float64
    on the exact path, held to the tolerances of the card-against-CPU
    phase."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.sim import run_trac

    names = ("lon", "lat", "p", "t", "m")
    tols = {"float32": {k: TOLS_F32[k] for k in names},
            "float64": {k: TOLS_F64[k] for k in names}}
    t_start, t_stop = DT_MET - 5 * 180.0, DT_MET + 5 * 180.0
    report = {}
    for mode, fast in (("float32", "2"), ("float64", "0")):
        tmp = tempfile.mkdtemp(prefix="mptrac_trac_")
        try:
            flagship.write_case(tmp, 2048, (36, 19, 8), t_start, t_stop,
                                900, DT_MET, ("TPU_FAST", fast))
            ctl = read_ctl(os.path.join(tmp, "trac.ctl"))
            out = {}
            for dev in ("cuda", "cpu"):
                sim = run_trac(tmp, "trac.ctl", "atm_in.bin",
                               ("ATM_BASENAME", "atm_" + dev), device=dev,
                               dtype=getattr(torch, mode))
                if (len(sim.met.reads) != 3 or sim.nsorts != 3
                        or sim.atm.lon.dtype != getattr(torch, mode)):
                    raise RuntimeError(
                        f"trac vs CPU ({mode}, {dev}): {len(sim.met.reads)} "
                        f"met files, {sim.nsorts} sorts, state "
                        f"{sim.atm.lon.dtype}")
                out[dev] = atm_io.read_atm(
                    os.path.join(tmp, f"atm_{dev}_2000_01_01_01_15_00.bin"),
                    ctl, device="cpu")
            a, b = out["cuda"], out["cpu"]
            errs = {}
            for name, x, y in (("lon", a.lon, b.lon), ("lat", a.lat, b.lat),
                               ("p", a.p, b.p), ("t", a.q["t"], b.q["t"]),
                               ("m", a.q["m"], b.q["m"])):
                errs[name] = float((x - y).abs().max())
                if not errs[name] <= tols[mode][name]:
                    raise RuntimeError(
                        f"trac vs CPU ({mode}): {name} differs by "
                        f"{errs[name]:.3e} > {tols[mode][name]:.1e}")
            if float((a.time - t_stop).abs().max()) != 0.0:
                raise RuntimeError(f"trac vs CPU ({mode}): parcel times did "
                                   "not reach the stop time")
            report[mode] = {"tpu_fast": int(fast), "max_abs_err": errs,
                            "tolerance": tols[mode]}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"trac_vs_cpu": {"steps": 10, "n_parcels": 2048,
                                    "grid": [36, 19, 8], "modes": report}}))


# ------------------------------------------- met and particle formats

#: parcels of the C API phase (a run through the embedded interpreter)
CAPI_N = 1 << 20
#: the containers of codec_path besides MET_TYPE 1: (MET_TYPE, extra
#: control parameters)
CODECS = ((2, ()), (2, ("MET_PCK_ZSTD", "1")), (3, ()), (4, ()), (5, ()),
          (7, ()), (8, ()))


def codec_tag(met_type, extra):
    return f"type{met_type}" + ("_zstd" if extra else "")


def same_file(a, b, chunk=1 << 26):
    """Whether two files hold the same bytes (read in chunks)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def column_diffs(a, b):
    """Largest |a - b| of each column of two particle states."""
    out = {k: float((getattr(a, k) - getattr(b, k)).abs().max())
           for k in ("time", "p", "lon", "lat")}
    out.update({"q." + k: float((a.q[k] - b.q[k]).abs().max()) for k in a.q})
    return out


def max_ulps(torch, a, b):
    """Largest distance in units of the last place between two float32
    tensors of one shape (0 where both are NaN; inf where one is)."""
    a, b = a.contiguous(), b.to(a.device).contiguous()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    # the integers of IEEE floats ordered like the floats
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = torch.where(nan_a, torch.zeros_like(ia), (ia - ib).abs())
    return int(d.max()) if d.numel() else 0


def fields_ulps(torch, ra, rb):
    """{field: max_ulps} over every 2-D and 3-D field of two raw dicts or
    Mets (card against CPU)."""
    def get(r, kind):
        return r[kind] if isinstance(r, dict) else getattr(r, kind)
    out = {}
    for kind in ("fields2d", "fields3d"):
        fa, fb = get(ra, kind), get(rb, kind)
        if sorted(fa) != sorted(fb):
            raise RuntimeError(f"fields differ: {sorted(fa)} {sorted(fb)}")
        for k in fa:
            out[k] = max_ulps(torch, fa[k], fb[k])
    return out


def phase_bin_path(torch, trac):
    """``tools.trac`` on trac_path's case (its directory, its particle
    file of N parcels, 16 steps across the met swap and two sorts, the
    fused path, float32) from MET_TYPE 1 files that the port's
    ``write_met_bin`` converted from the case's three netCDF files, the
    second and third read by the native decode-ahead: ms a step, the
    step at the swap beside trac_path's, each file's seconds by stage,
    route and wait, peak memory, the launches; the final particle file
    held to trac_path's byte for byte."""
    import numpy as np

    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io

    tmp = trac["tmp"]
    t0 = time.time()
    paths = flagship.convert_case(tmp, 1, workers=3)
    convert_s = time.time() - t0
    sizes = [os.path.getsize(p) for p in paths]
    say(f"[bin] the case's netCDF met files converted to MET_TYPE 1 in "
        f"{convert_s:.1f} s (3 processes): {sizes} B")
    sim, steps, builds, counts, peak, run_s = run_trac_tool(
        torch, ["trac", trac["dirlist"], "trac.ctl", "atm_in.bin",
                "ATM_BASENAME", "bin", "--device", "cuda", "--dtype",
                "float32"], "bin path")
    nadv = len(steps)
    swap = [st for st in steps[1:] if st["met_files"]]
    routes = [r["route"] for r in sim.met.reads]
    if (routes != ["python", "native", "native"] or len(swap) != 1
            or tuple(sim.met.pair.time) != (DT_MET, 2 * DT_MET)):
        raise RuntimeError(f"bin path: files {sim.met.reads}, pair "
                           f"{sim.met.pair.time}, {len(swap)} swaps")
    if sim.nsorts != 2 or counts["permute_count"] != 2 or (
            counts["permute_gather"] + counts["permute_rows"] != 2):
        raise RuntimeError(f"bin path: {sim.nsorts} sorts, K3 {counts}")
    if counts["rk_fused_advect"] != nadv or counts["sfc_interp"] < nadv:
        raise RuntimeError(f"bin path: K1 {counts['rk_fused_advect']}, K2 "
                           f"{counts['sfc_interp']} launches in {nadv} steps")
    plain = [st["ms"] for st in steps[1:]
             if not (st["met_files"] or st["sorted"] or st["output"])]
    reads = sim.met.reads
    del sim
    torch.cuda.empty_cache()
    ours = os.path.join(tmp, "bin" + trac["output"][len("atm"):])
    ref = os.path.join(tmp, trac["output"])
    t0 = time.time()
    equal = same_file(ours, ref)
    diffs = None
    if not equal:
        ctl = read_ctl(os.path.join(tmp, "trac.ctl"))
        diffs = column_diffs(atm_io.read_atm(ours, ctl, device="cpu"),
                             atm_io.read_atm(ref, ctl, device="cpu"))
    compare_s = time.time() - t0
    summary = {
        "n_parcels": trac["n_parcels"], "grid": list(GRID), "steps": nadv,
        "met_type": 1, "convert_s": convert_s, "met_file_bytes": sizes,
        "run_s": run_s, "ms_per_step": float(np.mean(plain)),
        "ms_per_step_min_max": [min(plain), max(plain)],
        "ms_step_at_swap": swap[0]["ms"],
        "trac_path_ms_per_step": trac["ms_per_step"],
        "trac_path_ms_step_at_swap": trac["ms_step_at_swap"],
        "ms_first_step": steps[0]["ms"],
        "ms_steps": [round(st["ms"], 3) for st in steps],
        "pack_rebuild_ms": [a.elapsed_time(b) for a, b in builds],
        "met_files": reads,
        "peak_memory_allocated_bytes": peak,
        "trac_path_peak_memory_allocated_bytes": trac["peak"],
        "launches": counts, "particle_file_equal_to_trac_path": equal,
        "column_max_abs_diff": diffs, "compare_s": compare_s}
    say(json.dumps({"bin_path": summary}))
    if not equal:
        raise RuntimeError("bin path: the particle file differs from "
                           f"trac_path's: {diffs}")
    os.remove(ours)
    return summary


def phase_codec_path(torch, trac):
    """One full-size file of each other container (2, 2 with
    MET_PCK_ZSTD, 3, 4, 5, 7, 8), written by the port's ``write_met_bin``
    from the fields of bin_path's second MET_TYPE 1 file: each file's
    ratio and bits per value (the JAX ``_log_codec``'s), the write and the
    read seconds by stage, the card's read against the CPU's on every
    field (in ulps), and the error against the MET_TYPE 1 fields within
    each codec's guarantee: PCK half its step a level, SQZ half its step
    (each plus one float32 ulp of the level's largest magnitude); ZFP's
    and CMS's errors printed."""
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met import bin_io
    from mptrac_tpu_torch.met.build import read_met

    tmp = trac["tmp"]
    ctl_file = os.path.join(tmp, "trac.ctl")
    src = os.path.join(tmp, "met_2000_01_01_01.bin")
    ctl1 = read_ctl(ctl_file, ["MET_TYPE", "1"])
    met = read_met(src, ctl1, device="cpu")
    ref = {k: v.to("cuda") for k, v in met.fields3d.items()}
    report = {}
    for met_type, extra in CODECS:
        tag = codec_tag(met_type, extra)
        ctl = read_ctl(ctl_file, ["MET_TYPE", str(met_type), *extra])
        fn = os.path.join(tmp, f"codec_{tag}.bin")
        stats = []
        t0 = time.time()
        bin_io.write_met_bin(fn, met, met_type, pck_zstd=bool(
            ctl.met_pck_zstd), ctl=ctl, stats=stats)
        write_s = time.time() - t0
        values = sum(st[2] for st in stats)
        stored = sum(st[3] for st in stats)
        card_t, cpu_t = {}, {}
        t0 = time.time()
        card = bin_io.read_met_bin(fn, ctl, device="cuda", timings=card_t)
        card_s = time.time() - t0
        t0 = time.time()
        cpu = bin_io.read_met_bin(fn, ctl, device="cpu", timings=cpu_t)
        cpu_s = time.time() - t0
        ulps = fields_ulps(torch, card, cpu)
        worst = max(ulps.values())
        errs, within = {}, True
        for mv, (name, _, _) in enumerate(bin_io.BIN_3D):
            got = card["fields3d"][name].double().reshape(-1, met.npl)
            want = ref[name].double().reshape(-1, met.npl)
            err = (got - want).abs().max(dim=0).values
            errs[name] = float(err.max())
            rng = want.max(dim=0).values - want.min(dim=0).values
            ulp = want.abs().max(dim=0).values * 2.0 ** -23
            if met_type == 2:
                within &= bool((err <= rng / 65533.0 / 2 + ulp).all())
            elif met_type == 7:
                step = torch.clamp(rng, min=1e-30) * 0.5 ** ctl.met_sz3_prec[mv]
                within &= bool((err <= step / 2 + ulp).all())
            elif met_type in (4, 8):
                within &= errs[name] == 0.0
        for k in met.fields2d:
            if not torch.equal(card["fields2d"][k].cpu().nan_to_num(-999.0),
                               met.fields2d[k].nan_to_num(-999.0)):
                within = False
        report[tag] = {
            "bytes": os.path.getsize(fn), "ratio": 4 * values / stored,
            "bpv": 8 * stored / values, "write_s": write_s,
            "read_card_s": card_s, "read_card_stages_s": card_t,
            "read_cpu_s": cpu_s, "read_cpu_stages_s": cpu_t,
            "card_vs_cpu_max_ulps": worst, "max_abs_err_vs_type1": errs,
            "within_guarantee": within}
        say(f"[codec] {tag}: RATIO={4 * values / stored:g} "
            f"BPV={8 * stored / values:g}, write {write_s:.2f} s, read "
            f"card {card_s:.3f} s {json.dumps(card_t)}, cpu {cpu_s:.3f} s, "
            f"card vs cpu {worst} ulp, max err {max(errs.values()):.3e}")
        os.remove(fn)
        del card, cpu
        if worst != 0:
            raise RuntimeError(f"codec path: {tag} read on the card differs "
                               f"from the CPU's by up to {worst} ulp: {ulps}")
        if not within:
            raise RuntimeError(f"codec path: {tag} outside its guarantee: "
                               f"{errs}")
    say(json.dumps({"codec_path": {"grid": list(GRID), "containers": report}}))


def phase_capi(torch, trac):
    """The port's C shim and ``demo_trac`` built (``capi.build_shim``)
    and the demo run on the card (``--device cuda --dtype float32``) on
    trac_path's case, from its MET_TYPE 1 files, at CAPI_N parcels; its
    final particle file held to ``run_trac``'s on the same case, byte for
    byte."""
    import numpy as np

    from mptrac_tpu_torch import capi
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.sim import run_trac
    from mptrac_tpu_torch.types import Atm

    tmp = trac["tmp"]
    t0 = time.time()
    paths = capi.build_shim()
    build_s = time.time() - t0
    ctl = read_ctl(os.path.join(tmp, "trac.ctl"))
    rng = np.random.default_rng(1)
    n = CAPI_N

    def col(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n))
    atm = Atm(time=torch.full((n,), T_TRAC_START, dtype=torch.float64),
              p=col(200, 900), lon=col(-180, 180), lat=col(-60, 60),
              q={"t": torch.zeros(n, dtype=torch.float64),
                 "m": torch.ones(n, dtype=torch.float64)}, np=n)
    atm_io.write_atm(os.path.join(tmp, "atm_capi.bin"), ctl, atm,
                     T_TRAC_START)
    t0 = time.time()
    r = subprocess.run(
        [paths["demo"], tmp, "trac.ctl", "atm_capi.bin", "ATM_BASENAME",
         "capi", "--device", "cuda", "--dtype", "float32"],
        env=capi.demo_env({"LOGLEV": "0"}), capture_output=True, text=True,
        timeout=600)
    demo_s = time.time() - t0
    nsteps = int(round((T_TRAC_STOP - T_TRAC_START) / ctl.dt_mod)) + 1
    if r.returncode != 0 or f"done: {nsteps} steps, {n} parcels" not in r.stdout:
        raise RuntimeError(f"capi: demo_trac returned {r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    t0 = time.time()
    sim = run_trac(tmp, "trac.ctl", "atm_capi.bin", ("ATM_BASENAME", "pyc"),
                   device="cuda", dtype=torch.float32)
    run_s = time.time() - t0
    routes = [x["route"] for x in sim.met.reads]
    del sim
    stamp = trac["output"][len("atm"):]
    equal = same_file(os.path.join(tmp, "capi" + stamp),
                      os.path.join(tmp, "pyc" + stamp))
    say(json.dumps({"capi": {
        "n_parcels": n, "steps": nsteps, "met_type": ctl.met_type,
        "build_s": build_s, "shim": paths["lib"], "demo_s": demo_s,
        "run_trac_s": run_s, "run_trac_routes": routes,
        "demo_stdout": r.stdout.strip().splitlines()[:3],
        "particle_file_equal_to_run_trac": equal}}))
    if not equal:
        raise RuntimeError("capi: demo_trac's particle file differs from "
                           "run_trac's")


def grib_levels():
    """61 isobaric levels [hPa], whole hPa (GRIB's levels are integers),
    geometric from 1000 to 10 hPa."""
    import numpy as np
    levels = np.unique(np.round(np.geomspace(1000.0, 10.0, GRID[2])))[::-1]
    assert len(levels) == GRID[2]
    return levels


def phase_grib_path(torch):
    """A GRIB2 set of the flagship's wind at 360x181 on 61 isobaric
    levels (``_ml`` and ``_sf`` files, the port's
    ``grib2.encode_message``): ``read_met`` on the card and on the CPU,
    the seconds by stage (the decode of the GRIB messages is in
    ``read``), every field of the two ``Met`` held equal."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.met.synthetic import make_wind_met

    tmp = tempfile.mkdtemp(prefix="mptrac_grib_")
    try:
        met = make_wind_met(t0=0.0, nx=GRID[0], ny=GRID[1], nz=GRID[2],
                            alpha=30.0, q=5e-6, o3=2e-6, device="cpu")
        path = os.path.join(tmp, "gb_XX_2000_01_01_00.grb")
        t0 = time.time()
        flagship.write_grib_met(path, met, grib_levels())
        write_s = time.time() - t0
        sizes = {x: os.path.getsize(path.replace("XX", x))
                 for x in ("ml", "sf")}
        ctl = read_ctl(None, ["MET_TYPE", "6", "METBASE",
                              os.path.join(tmp, "gb_XX"), "MET_TROPO", "3"])
        card_t, cpu_t = {}, {}
        t0 = time.time()
        card = read_met(path, ctl, device="cuda", timings=card_t)
        card_s = time.time() - t0
        t0 = time.time()
        cpu = read_met(path, ctl, device="cpu", timings=cpu_t)
        cpu_s = time.time() - t0
        ulps = fields_ulps(torch, card, cpu)
        axes = all(torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
                   for k in ("lon", "lat", "p"))
        say(json.dumps({"grib_path": {
            "grid": [card.nx, card.ny, card.npl], "bytes": sizes,
            "messages": 6 * GRID[2] + 4, "write_s": write_s,
            "read_met_card_s": card_s, "card_stages_s": card_t,
            "read_met_cpu_s": cpu_s, "cpu_stages_s": cpu_t,
            "card_vs_cpu_max_ulps": max(ulps.values()), "axes_equal": axes}}))
        if max(ulps.values()) != 0 or not axes or card.npl != GRID[2]:
            raise RuntimeError(f"grib path: card and CPU differ: {ulps}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_clams_atm(torch, n):
    """CLaMS particle files (``ATM_TYPE_OUT`` / ``ATM_TYPE`` 3 and 4) of a
    float32 state of N parcels on the card: the 64-bit-offset format (the
    classic one cannot hold the file, where the JAX writer fails), the
    write and read seconds and bytes, the file read back equal to the
    state."""
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.types import Atm

    tmp = tempfile.mkdtemp(prefix="mptrac_clams_")
    try:
        # 7 float64 columns (LAT, LON, PRESS, ZETA, t, m and the header)
        n_run, cut = disk_cut(tmp, n, 8 * 8, "clams atm")
        g = torch.Generator("cuda").manual_seed(3)

        def col(lo, hi):
            return torch.rand(n_run, generator=g, device="cuda") * (
                hi - lo) + lo
        atm = Atm(time=torch.full((n_run,), 3600.0, dtype=torch.float64,
                                  device="cuda"),
                  p=col(200, 900), lon=col(-180, 180), lat=col(-60, 60),
                  q={"t": col(200, 300), "m": col(0, 1)}, np=n_run)
        report = {}
        for k in (3, 4):
            ctl = read_ctl(None, ["NQ", "2", "QNT_NAME[0]", "t", "QNT_NAME[1]",
                                  "m", "ATM_TYPE", str(k), "ATM_TYPE_OUT",
                                  str(k), "METBASE", "-"])
            version = atm_io.clams_version(n_run, ctl)
            fn = os.path.join(tmp, f"atm_clams{k}.nc")
            t0 = time.time()
            atm_io.write_atm(fn, ctl, atm, 3600.0)
            write_s = time.time() - t0
            with open(fn, "rb") as f:
                magic = f.read(4)
            t0 = time.time()
            back = atm_io.read_atm(fn, ctl, dtype=torch.float32,
                                   device="cuda")
            torch.cuda.synchronize()
            read_s = time.time() - t0
            equal = back.np == n_run and all(
                torch.equal(getattr(back, c), getattr(atm, c))
                for c in ("time", "p", "lon", "lat")) and all(
                torch.equal(back.q[q], atm.q[q]) for q in ("t", "m"))
            report[f"type{k}"] = {
                "version": version, "magic": magic.decode("latin-1"),
                "bytes": os.path.getsize(fn), "write_s": write_s,
                "read_s": read_s, "equal_to_state": equal}
            os.remove(fn)
            del back
            if not equal or magic != b"CDF" + bytes([version]):
                raise RuntimeError(f"clams atm: type {k}: {report}")
        begins = atm_io.clams_begins(n_run, ctl)
        say(json.dumps({"clams_atm": {
            "n_parcels": n_run, "n_parcels_asked": n, "cut": cut,
            "zeta_begin_bytes": begins["ZETA"],
            "cdf1_max_begin_bytes": atm_io.CDF1_MAX_BEGIN, "files": report}}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_formats_vs_cpu(torch):
    """At the tests' size (36x19x8), each new reader on the card against
    the CPU: every binary container, the GRIB set, the CLaMS particle
    files (equal to the bit), and ``run_trac`` from MET_TYPE 1 files (the
    decode-ahead on both devices) at the card-against-CPU tolerances."""
    import numpy as np

    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.met import bin_io
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.sim import run_trac
    from mptrac_tpu_torch.types import Atm

    tmp = tempfile.mkdtemp(prefix="mptrac_fmt_")
    report = {}
    try:
        met = make_wind_met(t0=3600.0, nx=36, ny=19, nz=8, alpha=30.0,
                            q=1e-5, o3=1e-6, device="cpu")
        rng = np.random.default_rng(1)
        met = met.replace(fields3d={
            k: v + torch.from_numpy(rng.normal(0, 1, v.shape).astype(
                np.float32)) for k, v in met.fields3d.items()})
        for met_type, extra in ((1, ()),) + CODECS:
            tag = codec_tag(met_type, extra)
            ctl = read_ctl(None, ["MET_TYPE", str(met_type), "METBASE", "-",
                                  *extra])
            fn = os.path.join(tmp, tag + ".bin")
            bin_io.write_met_bin(fn, met, met_type,
                                 pck_zstd=bool(ctl.met_pck_zstd), ctl=ctl)
            report[tag] = max(fields_ulps(
                torch, bin_io.read_met_bin(fn, ctl, device="cuda"),
                bin_io.read_met_bin(fn, ctl, device="cpu")).values())
        path = os.path.join(tmp, "gb_XX_2000_01_01_00.grb")
        flagship.write_grib_met(path, met, (1000, 850, 700, 500, 300, 200,
                                            100, 50))
        ctl = read_ctl(None, ["MET_TYPE", "6", "METBASE", "-",
                              "MET_TROPO", "3"])
        report["grib"] = max(fields_ulps(
            torch, read_met(path, ctl, device="cuda"),
            read_met(path, ctl, device="cpu")).values())
        for k in (3, 4):
            ctl = read_ctl(None, ["NQ", "1", "QNT_NAME[0]", "m", "ATM_TYPE",
                                  str(k), "ATM_TYPE_OUT", str(k),
                                  "METBASE", "-"])
            n = 2048
            atm = Atm(
                time=torch.full((n,), 60.0, dtype=torch.float64),
                p=torch.from_numpy(rng.uniform(100, 900, n)),
                lon=torch.from_numpy(rng.uniform(-180, 180, n)),
                lat=torch.from_numpy(rng.uniform(-90, 90, n)),
                q={"m": torch.from_numpy(rng.uniform(0, 1, n))}, np=n)
            fn = os.path.join(tmp, f"c{k}.nc")
            atm_io.write_atm(fn, ctl, atm, 60.0)
            a = atm_io.read_atm(fn, ctl, device="cuda")
            b = atm_io.read_atm(fn, ctl, device="cpu")
            report[f"clams{k}"] = max(column_diffs(
                a.replace(time=a.time.cpu(), p=a.p.cpu(), lon=a.lon.cpu(),
                          lat=a.lat.cpu(), q={q: v.cpu() for q, v in
                                              a.q.items()}), b).values())
        case = os.path.join(tmp, "case")
        os.makedirs(case)
        t_start, t_stop = DT_MET - 5 * 180.0, DT_MET + 5 * 180.0
        flagship.write_case(case, 2048, (36, 19, 8), t_start, t_stop, 900,
                            DT_MET, ("TPU_FAST", "2"))
        flagship.convert_case(case, 1)
        ctl = read_ctl(os.path.join(case, "trac.ctl"))
        out = {}
        for dev in ("cuda", "cpu"):
            sim = run_trac(case, "trac.ctl", "atm_in.bin",
                           ("ATM_BASENAME", "atm_" + dev), device=dev,
                           dtype=torch.float32)
            if [r["route"] for r in sim.met.reads] != ["python", "native",
                                                        "native"]:
                raise RuntimeError(f"formats vs CPU: routes {sim.met.reads}")
            out[dev] = atm_io.read_atm(
                os.path.join(case, f"atm_{dev}_2000_01_01_01_15_00.bin"),
                ctl, device="cpu")
        errs = column_diffs(out["cuda"], out["cpu"])
        report["run_trac_type1"] = errs
        say(json.dumps({"formats_vs_cpu": report}))
        bad = [k for k, v in report.items() if k != "run_trac_type1" and v]
        for name in ("lon", "lat", "p"):
            if not errs[name] <= TOLS_F32[name]:
                bad.append(f"run_trac {name} {errs[name]:.3e}")
        if bad:
            raise RuntimeError(f"formats vs CPU: card and CPU differ: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------ golden_long on card

def clim_overrides(root):
    """The climatology files of the golden control files, in this
    package (tests/test_torch_golden.py ``CLIM_OVERRIDES``)."""
    clim = os.path.join(root, "mptrac_tpu_torch", "data")
    radical = os.path.join(clim, "clams_radical_species_vmr.nc")
    return ("CLIM_PHOTO", os.path.join(clim, "clams_photolysis_rates.nc"),
            "CLIM_OH_FILENAME", radical,
            "CLIM_H2O2_FILENAME", os.path.join(clim, "cams_H2O2.nc"),
            "CLIM_HO2_FILENAME", radical, "CLIM_O1D_FILENAME", radical,
            "CLIM_CCL3F_TIMESERIES", os.path.join(clim, "noaa_gml_cfc11.tab"))


def run_golden_copy(torch, gold, wanted, args):
    """The port's ``run_trac`` on the card in float64 on a temporary copy
    of the files ``wanted(name)`` of a golden set; returns (temporary
    directory, its data directory, the simulation, seconds)."""
    from mptrac_tpu_torch.sim import run_trac
    tmp = tempfile.mkdtemp(prefix="mptrac_golden_")
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    for f in sorted(os.listdir(gold)):
        if wanted(f):
            shutil.copy(os.path.join(gold, f), data)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.time()
        sim = run_trac("data", "trac.ctl", args[0], args[1:], device="cuda",
                       dtype=torch.float64)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        os.chdir(cwd)
    return tmp, data, sim, seconds


def hold_tab(tag, ours_path, ref_path, col_tol, default):
    """A golden text file held per column, as tests/test_full_parity.py's
    ``assert_tab_close``; returns the largest difference of each
    column."""
    import numpy as np
    from test_full_parity import load_tab
    ours, ref = load_tab(ours_path), load_tab(ref_path)
    if ours.shape != ref.shape:
        raise RuntimeError(f"{tag}: shape {ours.shape} vs {ref.shape}")
    errs = []
    for c in range(ref.shape[1] if ref.ndim == 2 else 0):
        rtol, atol = col_tol.get(c, default)
        errs.append(float(np.nanmax(np.abs(ours[:, c] - ref[:, c]))))
        if not np.allclose(ours[:, c], ref[:, c], rtol=rtol, atol=atol,
                           equal_nan=True):
            raise RuntimeError(f"{tag} column {c}: max abs diff "
                               f"{errs[-1]:.3e} beyond rtol {rtol} atol "
                               f"{atol}")
    return errs


def phase_golden_long(torch):
    """The port's ``run_trac`` on a temporary copy of
    ``parity/golden_long`` (the reference model's 1020 steps of the
    chemistry configuration, 2000 parcels) on the card in float64, with
    the ``CLIM_*`` overrides that point at this package's climatology
    files, held to the golden particle files at the staged tolerances of
    tests/test_long_parity.py (``STAGES``, imported from there) and to
    its below-a-cell check.  Mixing and the chemistry grid add with
    ``index_add_``, which the card does in no fixed order, so these are
    tolerance checks."""
    import numpy as np

    from test_full_parity import load_tab
    from test_long_parity import STAGES

    root = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(root, "parity", "golden_long", "data")
    tmp, data, sim, seconds = run_golden_copy(
        torch, gold, lambda f: f in ("trac.ctl", "atm_split.tab")
        or f.startswith("met_"),
        ("atm_split.tab", "ATM_BASENAME", "atm") + clim_overrides(root))
    try:
        nsteps = sim.timers.as_dict()["RUN_TIMESTEP"]["count"]
        if sim.atm.lon.device.type != "cuda" or nsteps != 1021:
            raise RuntimeError(f"golden_long: {nsteps} steps on "
                               f"{sim.atm.lon.device}")
        stages = {}
        for stamp, step, col_tol, default in STAGES:
            f = f"atm_{stamp}.tab"
            stages[f"step{step}"] = {"max_abs_err_by_column": hold_tab(
                f"golden_long {f}", os.path.join(data, f),
                os.path.join(gold, f), col_tol, default)}
        ours = load_tab(os.path.join(data, f"atm_{STAGES[-1][0]}.tab"))
        ref = load_tab(os.path.join(gold, f"atm_{STAGES[-1][0]}.tab"))
        med = {"lon": float(np.median(np.abs(ours[:, 2] - ref[:, 2]))),
               "lat": float(np.median(np.abs(ours[:, 3] - ref[:, 3]))),
               "z": float(np.median(np.abs(ours[:, 1] - ref[:, 1])))}
        if not (med["lon"] < 0.5 and med["lat"] < 0.5 and med["z"] < 0.1):
            raise RuntimeError(f"golden_long: median divergence {med}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"golden_long": {
        "steps": nsteps - 1, "n_parcels": sim.atm.np, "dtype": "float64",
        "seconds": seconds, "met_files": len(sim.met.reads),
        "stages": stages, "median_divergence_step1020": med}}))


# ------------------------------------------------------------ the writers

#: the output path: the flagship from files with every output writer,
#: 21 steps from 0 to 3600 s; the sorts of SORT_DT 2700 fall on the first
#: step and one inside
OUT_T_STOP = 3600.0
OUT_SORT_DT = 2700
OUT_QNT = ("t", "m", "stat", "ens")
#: uniform H2O and O3 of the met (the reference wind tool's WIND_Q and
#: WIND_O3), which the profile writer interpolates
OUT_WIND_Q = 1e-3
OUT_WIND_O3 = 3e-7
N_OBS = 10_000
WRITERS = ("GridWriter", "EnsWriter", "CsiWriter", "ProfWriter",
           "SampleWriter", "StationWriter", "VtkWriter")


def write_obs(path, n, t0, t1, seed=0):
    """``n`` observations (ASCII, ``OBS_TYPE 0``) drawn uniformly over the
    flagship parcels' range (lon, lat, altitude of 200-900 hPa) and the
    run's time, sorted by time."""
    import numpy as np
    rng = np.random.default_rng(seed)
    z0, z1 = (7.0 * math.log(1013.25 / p) for p in (900.0, 200.0))
    rows = np.stack([rng.uniform(t0, t1, n), rng.uniform(z0, z1, n),
                     rng.uniform(-180.0, 180.0, n),
                     rng.uniform(-60.0, 60.0, n),
                     10.0 ** rng.uniform(-9.0, -3.0, n)], axis=-1)
    rows = rows[np.argsort(rows[:, 0], kind="stable")]
    np.savetxt(path, rows, fmt="%.3f %.6f %.6f %.6f %.6e")
    return path


def output_args(obs, dt_out, fast):
    """Control parameters of every writer, as a user of the global
    flagship runs them: a 1-degree netCDF grid of 360x180x50 cells, the
    32 ensemble members, every 100th parcel to VTK, CSI, profiles and
    samples against one observation file (their grids on their
    defaults, SAMPLE_DZ of golden_chem) and golden_chem's station."""
    dt = str(int(dt_out))
    return ("TPU_FAST", fast, "MOLMASS", "64.066", "ATM_BASENAME", "-",
            "GRID_BASENAME", "grid", "GRID_TYPE", "1", "GRID_DT_OUT", dt,
            "GRID_LON0", "-180", "GRID_LON1", "180", "GRID_NX", "360",
            "GRID_LAT0", "-90", "GRID_LAT1", "90", "GRID_NY", "180",
            "GRID_Z0", "0", "GRID_Z1", "50", "GRID_NZ", "50",
            "ENS_BASENAME", "ens", "ENS_DT_OUT", dt,
            "VTK_BASENAME", "vtk", "VTK_STRIDE", "100", "VTK_DT_OUT", dt,
            "CSI_BASENAME", "csi", "CSI_OBSFILE", obs, "CSI_DT_OUT", dt,
            "PROF_BASENAME", "prof", "PROF_OBSFILE", obs,
            "SAMPLE_BASENAME", "sample", "SAMPLE_OBSFILE", obs,
            "SAMPLE_DZ", "100", "OBS_TYPE", "0",
            "STAT_BASENAME", "station", "STAT_LON", "-72",
            "STAT_LAT", "-40.5", "STAT_R", "200")


def tab_rows(path):
    """Data rows of a text output as a float array ``[rows, cols]``."""
    import numpy as np
    rows = [[float(x) for x in line.split()] for line in open(path)
            if line.strip() and not line.startswith("#")]
    return np.array(rows) if rows else np.zeros((0, 0))


def vtk_points(path):
    """The ``POINTS`` count of a VTK file."""
    with open(path) as f:
        for line in f:
            if line.startswith("POINTS"):
                return int(line.split()[1])
    return -1


class HostProbe:
    """What the host does while a wrapped function runs, call by call:
    its wall time, the calling thread's CPU time, its involuntary
    context switches, the time in Python's garbage collector, the
    allocator's ``cudaMalloc`` calls, and the card's SM clock and power
    sampled every 20 ms by ``nvidia-smi`` (in the background until
    ``stop()``).  A step that takes longer on the card than its peers
    shows here whether the host was held (switches, collector, CPU time
    far below the wall time), the allocator called ``cudaMalloc``, or the
    card ran at a lower clock."""

    def __init__(self, torch):
        import gc
        import resource
        self.torch, self.gc, self.resource = torch, gc, resource
        self.calls, self.saved, self.gc_spans, self._gc0 = [], None, [], 0.0
        gc.callbacks.append(self._on_gc)
        self.log = tempfile.TemporaryFile("w+")
        self.smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=self.log, stderr=subprocess.DEVNULL, text=True)
        self.samples = []

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc0 = time.time()
        else:
            self.gc_spans.append((self._gc0, time.time()))

    def wrap(self, owner, name):
        fn = getattr(owner, name)
        self.saved = (owner, name, fn)
        torch, res = self.torch, self.resource

        def probed(*a, **k):
            r0 = res.getrusage(res.RUSAGE_THREAD)
            d0 = torch.cuda.memory_stats().get("num_device_alloc", -1)
            w0, c0 = time.time(), time.thread_time()
            out = fn(*a, **k)
            w1, c1 = time.time(), time.thread_time()
            d1 = torch.cuda.memory_stats().get("num_device_alloc", -1)
            r1 = res.getrusage(res.RUSAGE_THREAD)
            self.calls.append(dict(w0=w0, w1=w1, cpu_ms=1e3 * (c1 - c0),
                                   nivcsw=r1.ru_nivcsw - r0.ru_nivcsw,
                                   device_allocs=d1 - d0))
            return out
        setattr(owner, name, probed)

    def stop(self):
        if self.saved is not None:
            setattr(*self.saved)
            self.saved = None
        if self._on_gc in self.gc.callbacks:
            self.gc.callbacks.remove(self._on_gc)
        if self.log.closed:
            return
        if self.smi.poll() is None:
            self.smi.terminate()
        self.smi.wait(timeout=10)
        self.log.seek(0)
        lines = self.log.read().splitlines()
        self.log.close()
        for line in lines:
            f = [x.strip() for x in line.split(",")]
            try:
                ts = time.mktime(time.strptime(f[0].split(".")[0],
                                               "%Y/%m/%d %H:%M:%S"))
                ts += float("0." + f[0].split(".")[1])
                self.samples.append((ts, float(f[1]), float(f[2])))
            except (ValueError, IndexError):
                continue

    def summary(self, device_ms):
        """Per call: lists of the wall ms, CPU ms, involuntary switches,
        collector ms, ``cudaMalloc`` calls, and the lowest and mean SM
        clock (MHz) and the mean power (W) over the card's time of the
        call (from its start on the host: the card is idle before it)."""
        out = {k: [] for k in ("wall_ms", "cpu_ms", "involuntary_switches",
                               "gc_ms", "device_allocs", "sm_mhz_min",
                               "sm_mhz_mean", "power_w_mean")}
        for c, ms in zip(self.calls, device_ms):
            out["wall_ms"].append(round(1e3 * (c["w1"] - c["w0"]), 3))
            out["cpu_ms"].append(round(c["cpu_ms"], 3))
            out["involuntary_switches"].append(c["nivcsw"])
            out["gc_ms"].append(round(1e3 * sum(
                max(0.0, min(b, c["w1"]) - max(a, c["w0"]))
                for a, b in self.gc_spans), 3))
            out["device_allocs"].append(c["device_allocs"])
            on = [s for s in self.samples
                  if c["w0"] <= s[0] <= c["w0"] + ms / 1e3]
            out["sm_mhz_min"].append(min((s[1] for s in on), default=None))
            out["sm_mhz_mean"].append(
                round(sum(s[1] for s in on) / len(on), 1) if on else None)
            out["power_w_mean"].append(
                round(sum(s[2] for s in on) / len(on), 1) if on else None)
        return out


class Timing:
    """CUDA events around calls of functions that are looked up by name
    at each call (module functions, methods): ``wrap(owner, name, tag)``
    replaces ``owner.name`` until ``restore()``; ``ms(tag)`` lists the
    milliseconds of every call, ``calls`` the (tag, step) of each."""

    def __init__(self, torch):
        self.torch, self.saved, self.events = torch, [], []
        self.step = -1

    def wrap(self, owner, name, tag):
        fn = getattr(owner, name)
        self.saved.append((owner, name, fn))
        torch, events = self.torch, self.events

        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events.append((tag, self.step, e0, e1))
            return out
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []

    def ms(self, tag, step=None):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for t, s, a, b in self.events
                if t == tag and (step is None or s == step)]


def phase_output_path(torch, n, trac_summary):
    """``tools.trac`` from files on the flagship case with all seven
    writers at full size (float32, the fused path, 21 steps from 0 to
    3600 s, one sort inside): each writer's milliseconds a call by CUDA
    events, ``WRITE_OUTPUT`` a step, the step without its output against
    trac_path's, the files' bytes and contents, peak memory."""
    import numpy as np

    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch import sim as simmod
    from mptrac_tpu_torch.io import output, writers
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.physics import pipeline
    from mptrac_tpu_torch.tools import trac

    tmp = tempfile.mkdtemp(prefix="mptrac_out_")
    try:
        # the particle file in (8 float64 columns); the outputs are small
        n_run, cut = disk_cut(tmp, n, 8 * 8, "output path")
        t0 = time.time()
        obs = write_obs(os.path.join(tmp, "obs.tab"), N_OBS, 0.0, OUT_T_STOP)
        dirlist = flagship.write_case(
            tmp, n_run, GRID, 0.0, OUT_T_STOP, OUT_SORT_DT, DT_MET,
            output_args(obs, OUT_T_STOP, "2"), quantities=OUT_QNT,
            wind_q=OUT_WIND_Q, wind_o3=OUT_WIND_O3)
        setup_s = time.time() - t0
        say(f"[output] {n_run} parcels{cut}; files written in "
            f"{setup_s:.1f} s")

        tm = Timing(torch)
        holder = {}
        advance = simmod.Simulation.advance

        def counted_advance(self, t, write_output=True):
            holder["sim"] = self
            tm.step += 1
            before = (len(self.met.reads), self.nsorts)
            advance(self, t, write_output)
            holder.setdefault("quiet", []).append(
                before == (len(self.met.reads), self.nsorts))

        simmod.Simulation.advance = counted_advance
        host = HostProbe(torch)
        host.wrap(pipeline, "run_timestep")
        tm.wrap(simmod.Simulation, "advance", "step")
        tm.wrap(pipeline, "run_timestep", "timestep")
        tm.wrap(output.OutputManager, "write", "write_output")
        for w in WRITERS:
            tm.wrap(getattr(writers, w), "write", w)
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()              # the path starts here
        t0 = time.time()
        try:
            rc = trac.main(["trac", dirlist, "trac.ctl", "atm_in.bin",
                            "--device", "cuda", "--dtype", "float32"])
        finally:
            tm.restore()
            host.stop()
            simmod.Simulation.advance = advance
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(_cuda.launch_counts)       # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"output path: tools.trac returned {rc}")
        sim = holder["sim"]
        nsteps = int(round(OUT_T_STOP / sim.ctl.dt_mod)) + 1
        step_ms, ts_ms = tm.ms("step"), tm.ms("timestep")
        wo_ms = tm.ms("write_output")
        if not (len(step_ms) == len(ts_ms) == len(wo_ms) == nsteps):
            raise RuntimeError(f"output path: {len(step_ms)} steps, "
                               f"expected {nsteps}")
        if (sim.nsorts != 2 or counts["rk_fused_advect"] != nsteps
                or counts["sfc_interp"] < nsteps):
            raise RuntimeError(f"output path: {sim.nsorts} sorts, launches "
                               f"{counts}")
        # the steps with nothing but the timestep and the per-step
        # writers: no file read, no sort, no grid/ens/csi/vtk output
        # (those fall on the first and the last step)
        ordinary = [i for i in range(1, nsteps - 1) if holder["quiet"][i]]
        bare = [step_ms[i] - wo_ms[i] for i in ordinary]
        per_writer = {}
        for w in WRITERS:
            calls = tm.ms(w)
            per_writer[w] = {
                "calls": len(calls), "ms_mean": float(np.mean(calls)),
                "ms_max": max(calls),
                "ms_ordinary_step_mean": float(np.mean(
                    [sum(tm.ms(w, i)) for i in ordinary])),
                "ms_last_step": sum(tm.ms(w, nsteps - 1)),
                "ms_first_step": sum(tm.ms(w, 0))}
        files = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))
                 if f.split("_")[0].split(".")[0] in (
                     "grid", "ens", "vtk", "csi", "prof", "sample",
                     "station")}
        result = {
            "n_parcels": n_run, "n_parcels_asked": n, "grid": list(GRID),
            "steps": nsteps, "run_s": run_s, "files_written_s": setup_s,
            "n_obs": N_OBS,
            "ms_step_without_output": float(np.mean(bare)),
            "ms_step_without_output_min_max": [min(bare), max(bare)],
            "ms_step_without_output_by_step": [
                round(step_ms[i] - wo_ms[i], 3) for i in range(nsteps)],
            "ordinary_step_indices": ordinary,
            "ms_run_timestep": float(np.mean([ts_ms[i] for i in ordinary])),
            "ms_run_timestep_min_max": [min(ts_ms[i] for i in ordinary),
                                        max(ts_ms[i] for i in ordinary)],
            "ms_run_timestep_median": float(np.median(
                [ts_ms[i] for i in ordinary])),
            "ms_run_timestep_by_step": [round(x, 3) for x in ts_ms],
            "ms_write_output_by_step": [round(x, 3) for x in wo_ms],
            "trac_path_ms_per_step": trac_summary["ms_per_step"],
            "trac_path_ms_per_step_min_max":
                trac_summary["ms_per_step_min_max"],
            "ms_write_output_ordinary": float(np.mean(
                [wo_ms[i] for i in ordinary])),
            "ms_write_output_ordinary_min_max": [
                min(wo_ms[i] for i in ordinary),
                max(wo_ms[i] for i in ordinary)],
            "ms_write_output_first_step": wo_ms[0],
            "ms_write_output_last_step": wo_ms[-1],
            "ordinary_steps": len(ordinary),
            "write_output_host_s": sim.timers.as_dict()["WRITE_OUTPUT"],
            "writers": per_writer, "file_bytes": files,
            "met_files": sim.met.reads,
            "peak_memory_allocated_bytes": peak,
            "trac_path_peak_memory_allocated_bytes": trac_summary["peak"],
            "run_timestep_host_by_step": host.summary(ts_ms),
            "launches": counts}
        say(json.dumps({"output_path": result}))
        check_output_files(tmp, n_run, sim)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_output_files(tmp, n_run, sim):
    """What every writer's file must show at the end of the output path:
    every parcel above the ground in the global grid, every parcel in the
    32 ensemble members, every 100th in the VTK file, a sample row per
    observation, a CSI row per output, the met's H2O and O3 in the
    profiles, a station row per flagged parcel."""
    import numpy as np
    from scipy.io import netcdf_file
    stamp = "2000_01_01_01_00_00"
    # inside the grid by its own float32 arithmetic: (lon + 180) / 1 of a
    # longitude within 2^-15 deg of 180 rounds to 360, the last edge
    a = sim.atm
    z = 7.0 * (1013.25 / a.p).log()
    inside = int(((z >= 0.0) & (z < 50.0) & ((a.lon + 180.0) < 360.0)
                  & ((a.lat + 90.0) < 180.0)).sum())
    nc = netcdf_file(os.path.join(tmp, f"grid_{stamp}.nc"), mmap=False)
    try:
        npc = nc.variables["np"][:].astype(np.int64)
        cd = nc.variables["cd"][:]
        vmr = nc.variables["vmr_impl"][:]
        tmean = nc.variables["t_mean"][:]
        if (int(npc.sum()) != inside or inside < n_run - 1000
                or npc.shape != (1, 50, 180, 360)):
            raise RuntimeError(f"output path: grid holds {int(npc.sum())} "
                               f"parcels in {npc.shape}, expected {inside} "
                               f"of {n_run}")
        has = npc > 0
        if not (np.isfinite(cd[has]).all() and np.isfinite(vmr[has]).all()
                and (vmr[has] > 0).all()
                and np.abs(tmean[has] - 280.0).max() < 1e-2):
            raise RuntimeError("output path: grid cd, vmr_impl or t_mean "
                               "out of range")
    finally:
        nc.close()
    ens = tab_rows(os.path.join(tmp, f"ens_{stamp}.tab"))
    if ens.shape[0] != 32 or (ens[:, -1] != n_run // 32).any():
        raise RuntimeError(f"output path: ensemble rows {ens.shape}, "
                           f"members {ens[:, -1] if ens.size else None}")
    for k in (1, 2):
        pts = vtk_points(os.path.join(tmp, f"vtk_{k:05d}.vtk"))
        if pts != -(-n_run // 100):
            raise RuntimeError(f"output path: vtk_{k:05d} has {pts} points")
    sample = tab_rows(os.path.join(tmp, "sample.tab"))
    if sample.shape[0] != N_OBS or not (sample[:, 6] > 0).any():
        raise RuntimeError(f"output path: {sample.shape[0]} sample rows, "
                           f"expected {N_OBS}")
    csi = tab_rows(os.path.join(tmp, "csi.tab"))
    if csi.shape[0] != 2 or not (csi[:, -1] > 0).all():
        raise RuntimeError(f"output path: CSI rows {csi.shape}")
    prof = tab_rows(os.path.join(tmp, "prof.tab"))
    if (prof.shape[0] == 0
            or np.abs(prof[:, 7] / OUT_WIND_Q - 1.0).max() > 1e-5
            or np.abs(prof[:, 8] / OUT_WIND_O3 - 1.0).max() > 1e-5
            or np.abs(prof[:, 5] - 280.0).max() > 1e-2):
        raise RuntimeError("output path: profile rows without the met's "
                           "T, H2O or O3")
    station = tab_rows(os.path.join(tmp, "station.tab"))
    flagged = int((sim.atm.q["stat"] == 1).sum())
    if station.shape[0] != flagged or flagged == 0:
        raise RuntimeError(f"output path: {station.shape[0]} station rows, "
                           f"{flagged} flagged parcels")


#: card against CPU of every writer's file: the tolerances of
#: tests/test_full_parity.py:168-204 by file, and the columns that count
#: (parcels, members, contingency counts, observations), held exactly
OUT_TOLS = {"ens": (1e-2, 1e-6), "csi": (1e-4, 1e-6),
            "station": (1e-4, 1e-6), "prof": (1e-4, 1e-6),
            "sample": (1e-4, 1e-6)}
OUT_COUNT_COLS = {"ens": [-1], "csi": [2, 3, 4, 5, 6, 19], "prof": [10],
                  "sample": [6]}


def compare_outputs(tag, da, db, names):
    """Every file of ``names`` in ``da`` (card) against ``db`` (CPU);
    returns the largest difference of each."""
    import numpy as np
    from scipy.io import netcdf_file
    errs = {}
    for name in names:
        a, b = os.path.join(da, name), os.path.join(db, name)
        kind = name.split("_")[0].split(".")[0]
        if name.endswith(".nc"):
            na, nb = netcdf_file(a, mmap=False), netcdf_file(b, mmap=False)
            try:
                if int(nb.variables["np"][:].sum()) == 0:
                    raise RuntimeError(f"{tag} {name}: an empty grid")
                worst = 0.0
                for var, vb in nb.variables.items():
                    x = np.asarray(na.variables[var][:], np.float64)
                    y = np.asarray(vb[:], np.float64)
                    exact = var == "np"
                    rtol, atol = (0.0, 0.0) if exact else (1e-4, 1e-9)
                    if x.shape != y.shape or not np.allclose(
                            x, y, rtol=rtol, atol=atol, equal_nan=True):
                        raise RuntimeError(f"{tag} {name}: {var} differs")
                    d = np.abs(x - y)
                    worst = max(worst, float(np.nanmax(d)) if d.size else 0)
                errs[name] = worst
            finally:
                na.close()
                nb.close()
            continue
        if name.endswith(".vtk"):
            from test_full_parity import load_vtk_points
            x, y = load_vtk_points(a), load_vtk_points(b)
            rtol, atol = 1e-4, 1e-4
        else:
            x, y = tab_rows(a), tab_rows(b)
            rtol, atol = OUT_TOLS[kind]
        if x.shape != y.shape:
            raise RuntimeError(f"{tag} {name}: shape {x.shape} vs {y.shape}")
        if y.size == 0:
            errs[name] = 0.0
            continue
        for c in OUT_COUNT_COLS.get(kind, []):
            if not np.array_equal(x[:, c], y[:, c]):
                raise RuntimeError(f"{tag} {name}: counts in column {c} "
                                   "differ")
        if not np.allclose(x, y, rtol=rtol, atol=atol, equal_nan=True):
            raise RuntimeError(f"{tag} {name}: beyond rtol {rtol} atol "
                               f"{atol}")
        errs[name] = float(np.nanmax(np.abs(x - y)))
    return errs


def phase_writers_vs_cpu(torch):
    """The output path's case at the tests' size (2048 parcels, 36x19x8
    met, 10 steps with outputs every 900 s), twice:

    - float64 on the exact path through ``run_trac`` on the card and on
      the CPU: every writer's file agrees at the tolerances of
      tests/test_full_parity.py, counts exactly.  (In float32 the fused
      paths of the two devices end a few 1e-4 deg apart, enough to move
      a parcel across a cell edge; float64 keeps them 1e-7 apart, so a
      count that differs is the writer's.)
    - float32 on the fused path (``TPU_FAST 2``) on the card; then every
      writer, on each device, from that one final state and met pair
      (copied to the CPU), at the run's last time and one step after
      it (the state's times moved on by a step), where the grid,
      ensemble, CSI and VTK outputs fall: the same files at the same
      tolerances, counts exactly."""
    import dataclasses
    import types

    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.io.output import OutputManager
    from mptrac_tpu_torch.sim import run_trac

    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.cpu()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: cpu(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return obj

    kinds = ("grid", "ens", "vtk", "csi", "prof", "sample", "station")

    def outputs(d):
        return sorted(f for f in os.listdir(d)
                      if f.split("_")[0].split(".")[0] in kinds)

    tmp = tempfile.mkdtemp(prefix="mptrac_wcpu_")
    result = {"n_parcels": 2048, "steps": 10}
    try:
        t_stop = 9 * 180.0
        obs = write_obs(os.path.join(tmp, "obs.tab"), N_OBS, 0.0,
                        t_stop + 180.0)
        sims = {}
        for dev, sub, dtype, fast in (
                ("cuda", "card", torch.float64, "0"),
                ("cpu", "host", torch.float64, "0"),
                ("cuda", "card32", torch.float32, "2")):
            d = os.path.join(tmp, sub)
            os.makedirs(d)
            flagship.write_case(d, 2048, (36, 19, 8), 0.0, t_stop, 900,
                                DT_MET, output_args(obs, 900.0, fast),
                                quantities=OUT_QNT, wind_q=OUT_WIND_Q,
                                wind_o3=OUT_WIND_O3)
            sims[sub] = run_trac(d, "trac.ctl", "atm_in.bin", device=dev,
                                 dtype=dtype)
        names = outputs(os.path.join(tmp, "host"))
        if outputs(os.path.join(tmp, "card")) != names or len(names) != 10:
            raise RuntimeError(f"writers vs CPU: files {names}")
        errs = compare_outputs("writers vs CPU", os.path.join(tmp, "card"),
                               os.path.join(tmp, "host"), names)
        if not torch.equal(sims["card"].atm.q["stat"].cpu(),
                           sims["host"].atm.q["stat"]):
            raise RuntimeError("writers vs CPU: station flags differ")
        result["float64"] = {"files": names, "max_abs_err": errs}

        sim = sims["card32"]
        one = {"card32_out": (sim.atm, sim.met.pair),
               "host32_out": (cpu(sim.atm), cpu(sim.met.pair))}
        for sub, (atm, met) in one.items():
            d = os.path.join(tmp, sub)
            os.makedirs(d)
            om = OutputManager(d, sim.ctl)
            for t in (t_stop, t_stop + 180.0):
                om.write(types.SimpleNamespace(pair=met), atm, t)
                atm = atm.replace(time=atm.time + 180.0)
            om.close()
            one[sub] = atm
        names32 = outputs(os.path.join(tmp, "host32_out"))
        if (outputs(os.path.join(tmp, "card32_out")) != names32
                or len(names32) != 7):
            raise RuntimeError(f"writers vs CPU, float32: files {names32}")
        errs32 = compare_outputs(
            "writers vs CPU, float32", os.path.join(tmp, "card32_out"),
            os.path.join(tmp, "host32_out"), names32)
        if not torch.equal(one["card32_out"].q["stat"].cpu(),
                           one["host32_out"].q["stat"]):
            raise RuntimeError("writers vs CPU, float32: station flags "
                               "differ")
        result["float32_one_state"] = {"files": names32,
                                       "max_abs_err": errs32}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"writers_vs_cpu": result}))


# ----------------------------------------------------- golden_chem on card

#: the writers of tests/test_full_parity.py's chem_run
CHEM_WRITERS = (
    "GRID_BASENAME", "grid", "ENS_BASENAME", "ens",
    "STAT_BASENAME", "station",
    "CSI_BASENAME", "csi", "CSI_OBSFILE", "data/obs.tab",
    "PROF_BASENAME", "prof", "PROF_OBSFILE", "data/obs.tab",
    "SAMPLE_BASENAME", "sample", "SAMPLE_OBSFILE", "data/obs.tab",
    "VTK_BASENAME", "atm")


def phase_golden_chem(torch):
    """The port's ``run_trac`` on the card in float64 on a temporary copy
    of ``parity/golden_chem`` (60 steps of the chemistry configuration,
    2000 parcels) with every writer of tests/test_full_parity.py's
    chem_run: every particle file (with the station flag), grid,
    ensemble, CSI, station, profile, sample and VTK file held to the
    golden files at that test's tolerances."""
    import numpy as np
    from test_full_parity import load_vtk_points

    root = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(root, "parity", "golden_chem", "data")
    tmp, data, sim, seconds = run_golden_copy(
        torch, gold, lambda f: f in ("trac.ctl", "atm_split.tab", "obs.tab")
        or f.startswith("met_"),
        ("atm_split.tab", "ATM_BASENAME", "atm") + CHEM_WRITERS
        + clim_overrides(root))
    try:
        nsteps = sim.timers.as_dict()["RUN_TIMESTEP"]["count"]
        if sim.atm.lon.device.type != "cuda" or nsteps != 61:
            raise RuntimeError(f"golden_chem: {nsteps} steps on "
                               f"{sim.atm.lon.device}")
        pos = {0: (0, 0), 1: (0, 1e-5), 2: (0, 1e-5), 3: (0, 1e-5)}
        tols = {"atm": (pos, (1e-4, 1e-9)), "grid": ({}, (1e-4, 1e-9)),
                "ens": ({}, (1e-2, 1e-6)), "csi": ({}, (1e-4, 1e-6)),
                "station": ({}, (1e-4, 1e-6)), "prof": ({}, (1e-4, 1e-6)),
                "sample": ({}, (1e-4, 1e-6))}
        held = {}
        names = sorted(f for f in os.listdir(gold) if f.endswith(".tab")
                       and f.split("_")[0].split(".")[0] in tols
                       and f not in ("atm_init.tab", "atm_split.tab"))
        for f in names:
            kind = f.split("_")[0].split(".")[0]
            errs = hold_tab(f"golden_chem {f}", os.path.join(data, f),
                            os.path.join(gold, f), *tols[kind])
            held[f] = max(errs) if errs else 0.0
        stat = tab_rows(os.path.join(data, "atm_2011_06_05_02_00_00.tab"))
        if not (stat[:, 11] == 1).any():
            raise RuntimeError("golden_chem: no station flag set")
        for k in (1, 2, 3):
            f = f"atm_{k:05d}.vtk"
            x = load_vtk_points(os.path.join(data, f))
            y = load_vtk_points(os.path.join(gold, f))
            if x.shape != y.shape or not np.allclose(x, y, rtol=1e-4,
                                                     atol=1e-4):
                raise RuntimeError(f"golden_chem {f}: points differ")
            held[f] = float(np.abs(x - y).max())
        if len(held) != 26:
            raise RuntimeError(f"golden_chem: {len(held)} files held, "
                               "expected 26")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"golden_chem": {
        "steps": nsteps - 1, "n_parcels": sim.atm.np, "dtype": "float64",
        "seconds": seconds, "files_held": len(held),
        "max_abs_err_by_file": held}}))


# ---------------------------------------------------------- the zeta path

#: CLaMS-convention met of parity/mint_zeta.sh at the flagship's size:
#: 360x181 columns of 61 model levels, two snapshots 6 h apart
ZETA_GRID = (360, 181, 61)
ZETA_T0 = 520646400.0            # 2016-07-01 00:00 UTC
ZETA_STEPS = 12                  # 2 warm-up + 10 timed


def write_clams_met(path, tsec, hh, nx, ny, nz):
    """One CLaMS-convention met file by the recipe of
    parity/mint_zeta.sh (dims (time, lon, lat, lev); PRESS, T, U, V, W,
    ZETA, ZETA_DOT_TOT, GPH, PS), at ``nx`` x ``ny`` columns of ``nz``
    model levels; returns its zeta columns."""
    import numpy as np
    from scipy.io import netcdf_file
    H0, P0, G0 = 7.0, 1013.25, 9.80665
    lon = np.arange(nx) * (360.0 / nx)
    lat = -90.0 + np.arange(ny) * (180.0 / (ny - 1))
    lev = np.arange(1, nz + 1, dtype=np.float64)
    sigma = np.exp(np.linspace(np.log(0.995), np.log(0.001), nz))
    amp = 1.0 + 0.1 * (hh / 6.0)
    la = np.broadcast_to(lat[None, :, None] * np.pi / 180.0,
                         (nx, ny, nz))[None]
    ps2 = 1013.25 * (1.0 - 0.01 * np.sin(2 * la[..., 0]))
    press = ps2[..., None] * sigma[None, None, None, :]
    tt = 210.0 + 70.0 * (np.clip(press, 1e-3, None) / P0) ** 0.28
    u = amp * 35.0 * np.cos(la) * (0.5 + 0.5 * (1.0 - sigma)[None, None,
                                                             None, :])
    v = amp * 3.0 * np.sin(2 * la) * np.ones_like(press)
    zeta = tt * (1000.0 / press) ** 0.286
    zdot = amp * (0.5 - 1.0 * (1.0 - sigma))[None, None, None, :] \
        * np.ones_like(press)
    gph = H0 * np.log(P0 / press) * 1000.0 * G0
    out = netcdf_file(path, "w")
    try:
        out.createDimension("time", 1)
        out.createDimension("lon", nx)
        out.createDimension("lat", ny)
        out.createDimension("lev", nz)
        for name, arr, dims in (("time", np.array([tsec]), ("time",)),
                                ("lev", lev, ("lev",)),
                                ("lat", lat, ("lat",)),
                                ("lon", lon, ("lon",))):
            out.createVariable(name, np.float64, dims)[:] = arr
        dims4 = ("time", "lon", "lat", "lev")
        for name, arr in (("PRESS", press), ("T", tt), ("U", u), ("V", v),
                          ("W", np.zeros_like(press)), ("ZETA", zeta),
                          ("ZETA_DOT_TOT",
                           zdot / 0.00001157407 * (1 / 86400.0)),
                          ("GPH", gph)):
            out.createVariable(name, np.float32, dims4)[:] = \
                arr.astype(np.float32)
        out.createVariable("PS", np.float32, ("time", "lon", "lat"))[:] = \
            (ps2 * 100.0).astype(np.float32)
    finally:
        out.close()
    return zeta[0].astype(np.float32)


def zeta_ctl(root, metbase, t_stop):
    """golden_zeta's control file with the flagship's diffusion
    (DIFFUSION 1 and the default turbulence; the golden zeroes it only to
    isolate the advection), quantities m and zeta, the unfused kernels
    (TPU_FAST 1), a binary particle file and no particle output."""
    skip = ("TURB_", "NQ", "QNT_NAME", "METBASE", "T_STOP", "ATM_DT_OUT")
    lines = [line.strip() for line in open(os.path.join(
        root, "parity", "golden_zeta", "data", "trac.ctl"))
        if line.strip() and not line.startswith(skip)]
    return lines + ["NQ = 2", "QNT_NAME[0] = m", "QNT_NAME[1] = zeta",
                    f"METBASE = {metbase}", f"T_STOP = {t_stop:.2f}",
                    "DIFFUSION = 1", "TPU_FAST = 1", "ATM_TYPE = 1",
                    "ATM_TYPE_OUT = 1", "ATM_BASENAME = -"]


def phase_zeta_path(torch, n):
    """``tools.trac`` from files with diabatic zeta advection at full
    size: two CLaMS met files of 360x181x61 model levels, N parcels with
    m and zeta (drawn within every column's range from seed 0), float32
    on the unfused kernels (the surface and sigma kernels in the
    diffusion), 2 warm-up and 10 timed steps.  Milliseconds a step, of
    each column search and each field interpolated at it, the bytes they
    gather, the K2 and K5 launches, the met files' seconds and peak
    memory."""
    import numpy as np

    from mptrac_tpu_torch import sim as simmod
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.ops import _cuda, interp
    from mptrac_tpu_torch.physics import pipeline
    from mptrac_tpu_torch.tools import trac
    from mptrac_tpu_torch.types import Atm

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mptrac_zeta_")
    try:
        n_run, cut = disk_cut(tmp, n, 6 * 8, "zeta path")
        t0 = time.time()
        cols = [write_clams_met(os.path.join(tmp, f"clams_160701{hh:02d}.nc"),
                                ZETA_T0 + hh * 3600.0, hh, *ZETA_GRID)
                for hh in (0, 6)]
        zlo = max(float(c[..., 0].max()) for c in cols)
        zhi = min(float(c[..., -1].min()) for c in cols)
        t_stop = ZETA_T0 + (ZETA_STEPS - 1) * 180.0
        with open(os.path.join(tmp, "trac.ctl"), "w") as f:
            f.write("\n".join(zeta_ctl(root, os.path.join(tmp, "clams"),
                                       t_stop)) + "\n")
        ctl = read_ctl(os.path.join(tmp, "trac.ctl"))
        rng = np.random.default_rng(0)
        f64 = torch.float64

        def draw(lo, hi):
            return torch.from_numpy(rng.uniform(lo, hi, n_run))

        atm = Atm(time=torch.full((n_run,), ZETA_T0, dtype=f64),
                  p=torch.full((n_run,), 500.0, dtype=f64),
                  lon=draw(-180.0, 180.0), lat=draw(-60.0, 60.0),
                  q={"m": torch.ones(n_run, dtype=f64),
                     "zeta": draw(zlo, zhi)}, np=n_run)
        atm_io.write_atm(os.path.join(tmp, "atm_in.bin"), ctl, atm, ZETA_T0)
        del atm
        with open(os.path.join(tmp, "dirlist"), "w") as f:
            f.write(tmp + "\n")
        setup_s = time.time() - t0
        say(f"[zeta] {n_run} parcels{cut}, zeta in [{zlo:.2f}, {zhi:.2f}] "
            f"K; files written in {setup_s:.1f} s")

        tm = Timing(torch)
        advance = simmod.Simulation.advance
        holder = {}

        def counted_advance(self, t, write_output=True):
            holder["sim"] = self
            tm.step += 1
            advance(self, t, write_output)

        simmod.Simulation.advance = counted_advance
        tm.wrap(simmod.Simulation, "advance", "step")
        tm.wrap(pipeline, "run_timestep", "timestep")
        tm.wrap(interp, "locate_zeta", "search")
        tm.wrap(interp, "interp_zeta", "field")
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()              # the path starts here
        t0 = time.time()
        try:
            rc = trac.main(["trac", os.path.join(tmp, "dirlist"), "trac.ctl",
                            "atm_in.bin", "--device", "cuda", "--dtype",
                            "float32"])
        finally:
            tm.restore()
            simmod.Simulation.advance = advance
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(_cuda.launch_counts)       # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"zeta path: tools.trac returned {rc}")
        sim = holder["sim"]
        steps, ts_ms = tm.ms("step"), tm.ms("timestep")
        if len(steps) != ZETA_STEPS:
            raise RuntimeError(f"zeta path: {len(steps)} steps")
        if (counts["rk_fused_advect"] != 0 or counts["sfc_interp"] < 10
                or counts["meso_sigma"] < 10):
            raise RuntimeError(f"zeta path: launches {counts}")
        a = sim.atm
        for name, x in (("lon", a.lon), ("lat", a.lat), ("p", a.p),
                        ("zeta", a.q["zeta"])):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"zeta path: non-finite {name}")
        if not (float(a.p.min()) > 0.0 and float(a.p.max()) < 1100.0
                and float((a.time - t_stop).abs().max()) == 0.0):
            raise RuntimeError("zeta path: pressure or times out of range")
        searches = tm.ms("search")
        fields = tm.ms("field")
        timed = list(range(2, ZETA_STEPS))
        npl = ZETA_GRID[2]
        probes = 3 + math.ceil(math.log2(npl + 1)) + 2
        # each level evaluated at a parcel gathers 8 float32 values (four
        # corners, two times) through 8-byte indices
        per_level = n_run * 8 * (4 + 8)
        s_ms = [sum(tm.ms("search", i)) for i in timed]
        f_ms = [sum(tm.ms("field", i)) for i in timed]
        n_search = len(tm.ms("search", timed[0]))
        n_field = len(tm.ms("field", timed[0]))
        result = {
            "n_parcels": n_run, "n_parcels_asked": n,
            "grid": list(ZETA_GRID), "steps": ZETA_STEPS,
            "steps_timed": len(timed), "run_s": run_s,
            "files_written_s": setup_s,
            "ms_per_step": float(np.mean([steps[i] for i in timed])),
            "ms_per_step_min_max": [min(steps[i] for i in timed),
                                    max(steps[i] for i in timed)],
            "ms_run_timestep": float(np.mean([ts_ms[i] for i in timed])),
            "column_searches_per_step": n_search,
            "fields_per_step": n_field,
            "interp_4d_zeta_calls_per_step": n_field,
            "ms_per_search": float(np.mean(searches[2:])),
            "ms_per_field": float(np.mean(fields[2:])),
            "ms_zeta_interp_per_step": float(np.mean(
                [s + f for s, f in zip(s_ms, f_ms)])),
            "ms_per_interp_4d_zeta_call": float(np.mean(
                [(s + f) / n_field for s, f in zip(s_ms, f_ms)])),
            "levels_per_search": probes, "levels_per_field": 2,
            "gathered_bytes_per_search": probes * per_level,
            "gathered_bytes_per_field": 2 * per_level,
            "gather_GBps_search": probes * per_level / 1e6 / float(
                np.mean(searches[2:])),
            "met_files": sim.met.reads,
            "peak_memory_allocated_bytes": peak, "launches": counts}
        say(json.dumps({"zeta_path": result}))
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_golden_zeta(torch):
    """The port's ``run_trac`` on the card in float64 on a temporary copy
    of ``parity/golden_zeta`` (120 steps of diabatic zeta advection, 819
    parcels), held at tests/test_zeta_parity.py's tolerances."""
    root = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(root, "parity", "golden_zeta", "data")
    tmp, data, sim, seconds = run_golden_copy(
        torch, gold, lambda f: f in ("trac.ctl", "atm_init.tab")
        or f.startswith("clams_"), ("atm_init.tab", "ATM_BASENAME", "atm"))
    try:
        nsteps = sim.timers.as_dict()["RUN_TIMESTEP"]["count"]
        if sim.atm.lon.device.type != "cuda" or nsteps != 121:
            raise RuntimeError(f"golden_zeta: {nsteps} steps on "
                               f"{sim.atm.lon.device}")
        held = {}
        for stamp in ("00_00_00", "03_00_00", "06_00_00"):
            f = f"atm_2016_07_01_{stamp}.tab"
            errs = hold_tab(f"golden_zeta {f}", os.path.join(data, f),
                            os.path.join(gold, f),
                            {0: (0, 0), 1: (0, 1e-4), 2: (0, 1e-4),
                             3: (0, 1e-4)}, (1e-4, 1e-4))
            held[f] = errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"golden_zeta": {
        "steps": nsteps - 1, "n_parcels": sim.atm.np, "dtype": "float64",
        "seconds": seconds, "max_abs_err_by_column": held}}))


# ------------------------------------------------------------- the probes

PROBE_N = 2_000_000


def phase_probes(torch, n_large):
    """P1-P3: driven through ``perf.probe``'s entry point (the counts
    zeroed before, read after), then each against its plain version on
    every element and timed, at the probe's own n and at ``n_large``."""
    from mptrac_tpu_torch.ops import _cuda
    from mptrac_tpu_torch.perf import probe

    ncell = GRID[0] * GRID[1] * GRID[2]
    _cuda.reset_launch_counts()                  # the probes' path starts
    t0 = time.time()
    rc = probe.main(["lane", "grid", "small", "--n", str(PROBE_N),
                     "--ncell", str(ncell), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)           # ... and ends here
    if rc != 0:
        raise RuntimeError(f"perf.probe returned {rc}")
    for name in ("probe_lane", "probe_grid", "probe_small"):
        if counts[name] < 1:
            raise RuntimeError(f"perf.probe did not launch {name}")
    say(json.dumps({"probe_path": {"n": PROBE_N, "ncell": ncell,
                                   "seconds": time.time() - t0,
                                   "launches": counts}}))

    def lane(n):
        packT, base, w = probe.make_data(n, ncell, device="cuda")
        got = probe.probe_lane(packT, base, w)
        t1 = time.time()
        err = 0.0
        for s in range(0, n, PLAIN_CHUNK):
            e = min(s + PLAIN_CHUNK, n)
            exp = probe.probe_lane_plain(packT, base[s:e], w[:, s:e])
            err = max(err, max_err(got[:, s:e], exp, torch))
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t1)
        if not (float(got[4].min()) == 1.0
                and float(got[5:8].abs().max()) == 0.0):
            raise RuntimeError("P1: served flag or padding rows are off")
        del got, exp
        #: the same float32 operations in the same order without
        #: contraction on both sides (the lane kernels measured 0.0)
        tol = 0.0
        if not err <= tol:
            raise RuntimeError(f"P1 (n {n}): max abs err {err:.3e} > {tol}")
        ms = time_ms(lambda: probe.probe_lane(packT, base, w), torch)
        # 4 B index + 16 B weights + 32 B results a parcel, and each
        # table column that a parcel of this run points at, once
        cells = int(torch.unique(base).numel())
        nbytes = n * 52 + cells * probe.LANES * 4
        b, by, b_bytes, b_ops = bound_ms(nbytes, n * 180)
        return dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b, bound_by=by, bound_bytes_ms=b_bytes,
                    bound_operations_ms=b_ops, library_ms=None,
                    cells_touched=cells, tolerance=tol,
                    table_bytes=packT.numel() * 4)

    def grid(n):
        out = {}
        for G in probe.GRID_GROUPS:
            cp = G * 128
            nchunk = -(-n // cp)
            gen = torch.Generator(device="cuda").manual_seed(3)
            x = torch.rand((8, nchunk * cp), device="cuda", generator=gen)
            got = probe.probe_grid(x, G)
            exact = bool(torch.equal(got, probe.probe_grid_plain(x, G)))
            del got
            if not exact:
                raise RuntimeError(f"P2 (n {n}, G {G}): differs from x * 2")
            ms = time_ms(lambda: probe.probe_grid(x, G), torch)
            plain_ms = time_ms(lambda: probe.probe_grid_plain(x, G), torch)
            lib_ms = time_ms(lambda: x.mul(2.0), torch)
            # every element read once and written once
            b, by, _, _ = bound_ms(x.numel() * 8, x.numel())
            out[G] = dict(n=n, G=G, blocks=nchunk, max_abs_err=0.0, ms=ms,
                          us_per_block=1e3 * ms / nchunk, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b, bound_by=by,
                          tolerance=0.0)
            del x
        return out

    def small(n):
        tab, idx = probe.make_small_data(n, device="cuda")
        got = probe.probe_small(tab, idx)
        exact = bool(torch.equal(got, probe.probe_small_plain(tab, idx)))
        del got
        if not exact:
            raise RuntimeError(f"P3 (n {n}): differs from tab[:, idx]")
        idx64 = idx.to(torch.int64)
        ms = time_ms(lambda: probe.probe_small(tab, idx), torch)
        plain_ms = time_ms(lambda: probe.probe_small_plain(tab, idx), torch)
        lib_ms = time_ms(lambda: torch.index_select(tab, 1, idx64), torch)
        tab_t = tab.T.contiguous()
        rows_ms = time_ms(lambda: tab_t[idx64], torch)
        # 4 B index read, 8 results of 4 B written, the table once
        b, by, _, _ = bound_ms(n * 36 + tab.numel() * 4, 0)
        return dict(n=n, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, library_ms_row_gather=rows_ms,
                    bound_ms=b, bound_by=by, tolerance=0.0)

    kernels = []
    for name, fn, line in (("probe_lane", lane, 203),
                           ("probe_grid", grid, 241),
                           ("probe_small", small, 276)):
        at = {n: fn(n) for n in (PROBE_N, n_large)}
        torch.cuda.empty_cache()
        if name == "probe_grid":
            # the entry's own numbers: the middle block size; all three
            # block sizes at both n beside them
            main = dict(at[PROBE_N][32])
            more = {"by_G": {str(n): {str(G): v for G, v in at[n].items()}
                             for n in at}}
        else:
            main = dict(at[PROBE_N])
            more = {"at_n_large": at[n_large]}
        kernels.append(dict(
            name=name, route="cuda",
            source="mptrac_tpu_torch/csrc/probe.cu",
            replaces=f"perf/probe.py:{line}", launches=counts[name],
            **main, **more))
    return kernels


# ------------------------------------------------ the parallel layer

#: bench_dd's case (bench.py:300-412): DD 4 x 2, halo 4, cap 2N/8 a
#: subdomain, exch_cap cap/8, no diffusion and no decay, the exact path
DD_ZONAL, DD_MERID, DD_HALO = 4, 2, 4
DD_WARMUP, DD_TIMED = 2, 5
#: tests/test_dd.py's case and the stress case of
#: tests/helpers/dd_stress_worker.py (both also in tests/test_torch_dd.py)
DD_TEST_ARGS = ("NQ", "1", "QNT_NAME[0]", "idx", "METBASE", "-",
                "DIFFUSION", "0", "ADVECT", "4", "DD", "1",
                "DD_SUBDOMAINS_ZONAL", "4", "DD_SUBDOMAINS_MERIDIONAL", "2",
                "DD_HALOS_SIZE", "4", "MET_DT_OUT", "0", "T_STOP", "86400",
                "DT_MOD", "1200")
DD_STRESS_ARGS = ("NQ", "1", "QNT_NAME[0]", "idx", "METBASE", "-",
                  "DIFFUSION", "1", "TURB_DX_TROP", "50", "TURB_DZ_TROP",
                  "0.1", "TURB_MESOX", "0.16", "TURB_MESOZ", "0.4",
                  "ADVECT", "2", "MET_DT_OUT", "0", "DD", "1",
                  "DD_SUBDOMAINS_ZONAL", "3", "DD_SUBDOMAINS_MERIDIONAL",
                  "3", "DD_HALOS_SIZE", "4", "T_STOP", "86400",
                  "DT_MOD", "1200")
#: tests/helpers/dd_worker.py's case: 36x19x8 met files an hour apart,
#: 40 parcels, one subdomain a rank, 4 steps of 180 s, exch_cap 16
DIST_FILES = ("wind_2000_01_01_00.nc", "wind_2000_01_01_01.nc")
DIST_N, DIST_CAP, DIST_EXCH, DIST_STEPS = 40, 64, 16, 4
#: seconds a rank process may take (startup included)
DIST_TIMEOUT = 240
#: NCCL's error when two ranks of one communicator share a card
DUPLICATE_GPU = "Duplicate GPU detected"


def dd_step_loop(torch, step, tiles, state, t, dt_mod, steps, n=None):
    """``steps`` DD steps from the state ``[atm, cache]`` at model time
    ``t``: the state, the time, the ms of each step (host clock,
    synchronised), the third output's and the lost counts of each step.
    The list is emptied, so that while the steps run only the step's old
    and new state are held.  With ``n``, checks after every step that
    live + lost == n while nothing overflowed."""
    a, c = state
    state.clear()
    ms, third, lost = [], [], []
    lost_tot = ov_tot = 0
    for _ in range(steps):
        t += dt_mod
        torch.cuda.synchronize()
        t0 = time.time()
        a, c, x, lo = step(tiles, a, c, t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.time() - t0))
        third.append(int(x.sum()))
        lost.append(int(lo.sum()))
        lost_tot += lost[-1]
        if n is not None:
            ov_tot += third[-1]
            if ov_tot == 0 and int(a.np.sum()) + lost_tot != n:
                raise RuntimeError(f"DD: {int(a.np.sum())} live + "
                                   f"{lost_tot} lost != {n}")
    return a, c, t, ms, third, lost


def k3_in_dd_step(torch, ddm, step, tiles, state, t, dt_mod):
    """One more DD step with every K3 call inside it timed by CUDA
    events (the migration's selections in their order: movers and
    stayers of each subdomain, then the received parcels of each); the
    first stayers' call is kept to hold against its plain version.
    Returns (per-call records, kept inputs, state, time)."""
    real = ddm.permute_cols
    calls, kept = [], {}

    def timed(cols32, perm, col64=None, *, plan=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(cols32, perm, col64, plan=plan)
        e1.record()
        calls.append(dict(events=(e0, e1), n=perm.shape[0],
                          cols32=len(cols32), col64=col64 is not None,
                          plan=plan))
        if len(calls) == 2:                 # subdomain 0's stayers
            kept.update(cols=list(cols32), perm=perm, col64=col64,
                        plan=plan, out=out)
        return out

    ddm.permute_cols = timed
    try:
        a, c, t, _, _, _ = dd_step_loop(torch, step, tiles, state, t,
                                        dt_mod, 1)
    finally:
        ddm.permute_cols = real
    torch.cuda.synchronize()
    for rec in calls:
        e0, e1 = rec.pop("events")
        rec["ms"] = e0.elapsed_time(e1)
    return calls, kept, a, c, t


def nbytes(tensors):
    return sum(v.numel() * v.element_size() for v in tensors)


#: what runs after each K3 selection of the DD step, up to the next stage
AFTER_K3 = {"movers": "the send fill",
            "stayers": "copy into the new state (after the last "
                       "subdomain's, the exchange)",
            "received": "copy into the new state, refill"}


def dd_memory_step(torch, ddm, step, tiles, state, t, dt_mod, exch_cap):
    """One more DD step with the allocator read at the edges of its
    stages: each subdomain's physics, each K3 selection (movers, stayers,
    received) and the code between them.  A stage's record holds the
    bytes allocated when it starts and the peak inside it.  Returns (the
    breakdown, state, time)."""
    import weakref

    from mptrac_tpu_torch.physics import pipeline
    real_perm, real_phys = ddm.permute_cols, pipeline.run_timestep
    a, c = state
    ndev = len(a.np)
    stages, cur, n_sel, last = [], {}, [0], [lambda: None]

    def mark(label):
        if cur:
            stages.append(dict(stage=cur["label"], held=cur["held"],
                               peak=torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        cur.update(label=label, held=torch.cuda.memory_allocated())

    def phys(*args, **kw):
        mark("physics")
        out = real_phys(*args, **kw)
        mark("after physics: owner search, masks, mover order")
        return out

    def perm(cols32, idx, col64=None, *, plan=None):
        if last[0]() is not idx:            # a selection's first launch
            n_sel[0] += 1
            last[0] = weakref.ref(idx)
        k = n_sel[0] - 1
        kind = ("received" if k >= 2 * ndev else
                "stayers" if k % 2 else "movers")
        mark(f"K3 {kind}")
        out = real_perm(cols32, idx, col64, plan=plan)
        mark(f"after K3 {kind}: " + AFTER_K3[kind])
        return out

    state_bytes = (nbytes([a.time, a.p, a.lon, a.lat, *a.q.values()])
                   + nbytes([c.uvwp, c.dt, c.iso_var]))
    k32 = sum(1 for x in [a.p, a.lon, a.lat, *a.q.values()]
              if x.dtype == torch.float32) + c.uvwp.shape[0]
    k64 = 1 + sum(1 for x in [a.p, a.lon, a.lat, *a.q.values()]
                  if x.dtype == torch.float64)
    del a, c
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    ddm.permute_cols, pipeline.run_timestep = perm, phys
    try:
        mark("new state and send buffers")
        a, c, t, _, _, _ = dd_step_loop(torch, step, tiles, state, t,
                                        dt_mod, 1)
        mark("end")
    finally:
        ddm.permute_cols, pipeline.run_timestep = real_perm, real_phys
    by = {}
    for r in stages:
        b = by.setdefault(r["stage"], dict(n=0, held_max=0, peak_max=0))
        b["n"] += 1
        b["held_max"] = max(b["held_max"], r["held"])
        b["peak_max"] = max(b["peak_max"], r["peak"])
        b["above_held_max"] = max(b.get("above_held_max", 0),
                                  r["peak"] - r["held"])
    return dict(
        held_at_step_start=held0, state_bytes=state_bytes,
        send_buffer_bytes=ndev * ndev * exch_cap * (4 * k32 + 8 * k64 + 4),
        peak=max(r["peak"] for r in stages), by_stage=by), a, c, t


def phase_dd_path(torch, n):
    """bench_dd's case on the card, nothing cut: the flagship (float32,
    360x181x61, N parcels) without diffusion and decay on the exact path;
    the plain step (``rate_1``), the DD step of 4 x 2 subdomains in the
    local group (cap 2N/8, exch_cap cap/8) and the DD step without the
    exchange, each 2 warm-up + 5 timed steps.  The launch counts are
    zeroed just before the DD steps and read just after; then one more DD
    step times every K3 call in it, and one more breaks its peak memory
    down by stage; the steps without the exchange come last.  While DD
    steps run, only a step's old and new state are held (the plain
    step's peak also holds the initial state that the scatter reads)."""
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.ops import _cuda, slab_interp
    from mptrac_tpu_torch.parallel import dd as ddm
    from mptrac_tpu_torch.physics import pipeline

    t0 = time.time()
    ctl, clim, met01, atm, cache = flagship.make_setup(
        n, *GRID, extra_args=("TPU_FAST", "0"), device="cuda")
    ctl = ctl.replace(diffusion=0, tdec_trop=0.0, tdec_strat=0.0)
    dt_mod = ctl.dt_mod
    torch.cuda.synchronize()
    say(f"[dd_path] set-up of {n} parcels in {time.time() - t0:.1f} s")

    # the plain step on the same card (bench_dd's rate_1)
    torch.cuda.reset_peak_memory_stats()
    a, c, t, ms1 = atm, cache, 0.0, []
    for i in range(DD_WARMUP + DD_TIMED):
        t += dt_mod
        torch.cuda.synchronize()
        t1 = time.time()
        a, c = pipeline.run_timestep(ctl, clim, met01, a, c, t)
        torch.cuda.synchronize()
        ms1.append(1e3 * (time.time() - t1))
    peak1 = torch.cuda.max_memory_allocated()
    del a, c
    ms_1 = sum(ms1[DD_WARMUP:]) / DD_TIMED
    say(f"[dd_path] plain exact step: {ms_1:.3f} ms ({ms1})")

    ctl_dd = ctl.replace(dd=1, dd_subdomains_zonal=DD_ZONAL,
                         dd_subdomains_meridional=DD_MERID,
                         dd_halos_size=DD_HALO)
    dd = ddm.plan_decomposition(ctl_dd, met01, ndev=DD_ZONAL * DD_MERID)
    ndev = dd.ndev
    cap = 2 * n // ndev
    exch_cap = cap // 8
    t0 = time.time()
    tiles = ddm.make_tiles(dd, met01)
    lat_axis = met01.lat[0]
    a, c = ddm.scatter_parcels(dd, atm, cap, lat_axis)
    del atm, cache
    torch.cuda.synchronize()
    tiles_bytes = nbytes(list(tiles.fields3d.values())
                         + list(tiles.fields2d.values()))
    say(f"[dd_path] tiles ({tiles_bytes} B) and scatter in "
        f"{time.time() - t0:.1f} s; counts {a.np.tolist()}")
    group = ddm.local_group(ndev, "cuda")
    step = ddm.make_dd_step(ctl_dd, clim, dd, group, cap, exch_cap,
                            lat_axis)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()              # the path starts here
    state = [a, c]
    del a, c
    a, c, t, ms_dd, ovf, lost = dd_step_loop(
        torch, step, tiles, state, t, dt_mod, DD_WARMUP + DD_TIMED, n=n)
    counts = dict(_cuda.launch_counts)       # ... and ends here
    peak_dd = torch.cuda.max_memory_allocated()
    k3 = {k: counts[f"permute_{k}"] for k in ("count", "gather", "pack",
                                               "rows")}
    want = (DD_WARMUP + DD_TIMED) * 3 * ndev
    if k3["gather"] != want or k3["rows"] or k3["count"]:
        raise RuntimeError(f"dd_path: K3 launches {k3}, expected {want} "
                           "selections on the gather path")
    live, counts_dd = int(a.np.sum()), a.np.tolist()
    if sum(ovf) or live + sum(lost) != n:
        raise RuntimeError(f"dd_path: overflow {sum(ovf)}, live {live} + "
                           f"lost {sum(lost)} != {n}")
    for name, x in (("lon", a.lon), ("lat", a.lat), ("p", a.p)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"dd_path: non-finite {name}")

    # every K3 call of one more step, and the stayers' call against its
    # plain version and index_select
    state = [a, c]
    del a, c
    calls, kept, a, c, t = k3_in_dd_step(torch, ddm, step, tiles, state, t,
                                         dt_mod)
    cols, perm, col64 = kept["cols"], kept["perm"], kept["col64"]
    exp32, exp64 = slab_interp.permute_cols_plain(cols, perm, col64)
    got32, got64 = kept["out"]
    err = max(max_err(got32, exp32, torch), max_err(got64, exp64, torch))
    if err != 0.0:
        raise RuntimeError(f"dd_path: K3 differs from its plain version by "
                           f"{err}")
    del exp32, exp64, got32, got64
    ms_k3 = time_ms(lambda: slab_interp.permute_cols(
        cols, perm, col64, plan=kept["plan"]), torch, repeats=3)
    plain_k3 = time_ms(lambda: slab_interp.permute_cols_plain(
        cols, perm, col64), torch, repeats=3)
    stacked = torch.stack(cols)
    lib_k3 = time_ms(lambda: (torch.index_select(stacked, 1, perm),
                              torch.index_select(col64, 0, perm)),
                     torch, repeats=3)
    del stacked
    nk = perm.shape[0]
    per = 8 + 8 * len(cols) + 16
    b_k3 = bound_ms(nk * per, 0)[0]
    kinds = (["movers", "stayers"] * ndev + ["received"] * ndev)
    by_kind, n_by_kind = {}, {}
    for kind, rec in zip(kinds, calls):
        by_kind.setdefault(kind, []).append(rec["ms"])
        n_by_kind.setdefault(kind, []).append(rec["n"])
    k3_stats = dict(
        launches=k3["gather"] + k3["pack"] + k3["rows"],
        launches_by_kernel=dict(k3), selections_a_step=3 * ndev,
        ms=ms_k3, plain_ms=plain_k3, library_ms=lib_k3, bound_ms=b_k3,
        bound_by="bytes", max_abs_err=err, n=nk, columns_f32=len(cols),
        columns_f64=1, path=kept["plan"],
        ms_in_step_by_kind={k: dict(mean=sum(v) / len(v), min=min(v),
                                    max=max(v), n=len(v))
                            for k, v in by_kind.items()},
        ms_in_step_total=sum(r["ms"] for r in calls),
        n_in_step_by_kind=n_by_kind)
    del kept, cols, perm, col64

    # the peak's breakdown: one more step with the allocator read at the
    # edges of its stages
    state = [a, c]
    del a, c
    memory, a, c, t = dd_memory_step(torch, ddm, step, tiles, state, t,
                                     dt_mod, exch_cap)
    memory["met01_bytes"] = nbytes(list(met01.fields3d.values())
                                   + list(met01.fields2d.values()))
    memory["tiles_bytes"] = tiles_bytes
    say(json.dumps({"dd_path_memory": memory}))

    # the exchange's and compaction's share: the step without them, last,
    # on the state the steps above left; its first step counts the
    # parcels that one step takes out of their subdomains, the later ones
    # add up (nothing migrates)
    pstep = ddm.make_dd_step(ctl_dd, clim, dd, group, cap, exch_cap,
                             lat_axis, exchange=False)
    state = [a, c]
    del a, c
    torch.cuda.reset_peak_memory_stats()
    _, _, _, ms_px, migrated, _ = dd_step_loop(
        torch, pstep, tiles, state, t, dt_mod, DD_WARMUP + DD_TIMED)
    peak_px = torch.cuda.max_memory_allocated()

    ms_full = sum(ms_dd[DD_WARMUP:]) / DD_TIMED
    ms_phys = sum(ms_px[DD_WARMUP:]) / DD_TIMED
    stats = dict(
        n_parcels=n, grid=list(GRID), subdomains=[DD_ZONAL, DD_MERID],
        halo=DD_HALO, cap=cap, exch_cap=exch_cap,
        steps_warmup=DD_WARMUP, steps_timed=DD_TIMED,
        ms_per_step_plain=ms_1, ms_per_step_dd=ms_full,
        ms_per_step_dd_no_exchange=ms_phys,
        ms_exchange_and_compaction=ms_full - ms_phys,
        dd_overhead_one_card=ms_full / ms_1,
        dd_overhead_note=("all 8 subdomains share one card: the ratio of "
                          "the DD step to the plain step on the same card, "
                          "not BASELINE's cross-card scaling"),
        rate_1=1e3 * n / ms_1, rate_dd=1e3 * n / ms_full,
        ms_steps_plain=ms1, ms_steps_dd=ms_dd, ms_steps_no_exchange=ms_px,
        migrated_per_step=migrated[0], outside_owner_by_step=migrated,
        overflow_per_step=ovf,
        lost_per_step=lost, live=live,
        counts=counts_dd, peak_bytes_plain=peak1,
        peak_bytes_dd=peak_dd, peak_bytes_no_exchange=peak_px,
        tiles_bytes=tiles_bytes, launches=counts, k3=k3_stats,
        memory=memory)
    say(json.dumps({"dd_path": stats}))
    return k3_stats


def dd_case(torch, args, n, seed, device, lat=(-60, 60)):
    """(ctl, clim, met01, atm) of tests/test_dd.py's kind on ``device``:
    the tilted wind at 90x46x8, ``n`` parcels from a numpy seed, float64,
    the parcel index as quantity ``idx``."""
    import numpy as np

    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.types import Atm, stack_met

    ctl = read_ctl(None, list(args))
    clim = read_clim(ctl, device=device)
    met01 = stack_met(
        make_wind_met(t0=0.0, nx=90, ny=46, nz=8, alpha=40.0,
                      device=device),
        make_wind_met(t0=86400.0, nx=90, ny=46, nz=8, alpha=40.0,
                      device=device))
    rng = np.random.default_rng(seed)
    f64 = torch.float64

    def col(x):
        return torch.from_numpy(x).to(device)

    lon = col(rng.uniform(0, 360, n))
    lat_ = col(rng.uniform(*lat, n))
    p = col(rng.uniform(300, 900, n))
    atm = Atm(time=torch.zeros(n, dtype=f64, device=device), p=p, lon=lon,
              lat=lat_, q={"idx": torch.arange(n, dtype=f64, device=device)},
              np=n)
    return ctl, clim, met01, atm


def phase_dd_vs_cpu(torch):
    """tests/test_dd.py's case (90x46x8 tilted wind, 200 parcels, DD 4 x 2,
    halo 4, ``ADVECT 4``, 24 steps of 1200 s, float64) on the card and on
    the CPU: every slot at card_vs_cpu's float64 tolerances, the counts,
    overflow and lost exactly; the card's run against the port's plain
    run on the card (dlon < 1e-9, as test_dd.py).  Then the stress case
    on the card: 3 x 3 subdomains, 10,000 parcels, diffusion on,
    conservation every step, overflow detected at exch_cap 1, parcels
    lost on a regional grid."""
    import numpy as np

    from mptrac_tpu_torch.parallel import dd as ddm
    from mptrac_tpu_torch.physics import pipeline
    from mptrac_tpu_torch.types import Cache

    nsteps, cap, exch = 24, 128, 32
    runs = {}
    for dev in ("cuda", "cpu"):
        ctl, clim, met01, atm = dd_case(torch, DD_TEST_ARGS, 200, 5, dev)
        ctl = ctl.replace(t_start=0.0, t_stop=nsteps * 1200.0)
        dd = ddm.plan_decomposition(ctl, met01, ndev=8)
        tiles = ddm.make_tiles(dd, met01)
        a, c = ddm.scatter_parcels(dd, atm, cap, met01.lat[0])
        step = ddm.make_dd_step(ctl, clim, dd, ddm.local_group(8, dev),
                                cap, exch, met01.lat[0])
        per = []
        for i in range(1, nsteps + 1):
            a, c, ov, lo = step(tiles, a, c, i * 1200.0)
            per.append((a.np.tolist(), ov.tolist(), lo.tolist()))
        runs[dev] = (a, c, per, dd, (ctl, clim, met01, atm))
    (ag, cg, pg, dd, inputs), (ac, cc, pc, _, _) = runs["cuda"], runs["cpu"]
    if pg != pc or cg.rng_ctr != cc.rng_ctr:
        raise RuntimeError("dd_vs_cpu: counts, overflow, lost or counters "
                           "differ between card and CPU")
    errs = {}
    for name, x, y in (("lon", ag.lon, ac.lon), ("lat", ag.lat, ac.lat),
                       ("p", ag.p, ac.p), ("uvwp", cg.uvwp, cc.uvwp),
                       ("time", ag.time, ac.time),
                       ("idx", ag.q["idx"], ac.q["idx"])):
        errs[name] = float((x.cpu() - y).abs().max())
        tol = TOLS_F64.get(name, 0.0)
        if not errs[name] <= tol:
            raise RuntimeError(f"dd_vs_cpu: {name} differs by "
                               f"{errs[name]:.3e} > {tol}")
    # the card's DD run against the port's plain run on the card
    ctl, clim, met01, atm = inputs
    ctl1 = ctl.replace(dd=0)
    a1, c1 = atm, Cache.zeros(atm.npmax, device="cuda")
    for i in range(1, nsteps + 1):
        a1, c1 = pipeline.run_timestep(ctl1, clim, met01, a1, c1,
                                       i * 1200.0)
    out = ddm.gather_parcels(dd, ag, cap)
    if out.np != 200:
        raise RuntimeError(f"dd_vs_cpu: {out.np} parcels of 200 left")
    od, o1 = torch.argsort(out.q["idx"]), torch.argsort(a1.q["idx"])
    dlon = float(((out.lon[od] - a1.lon[o1] + 180) % 360 - 180).abs().max())
    dlat = float((out.lat[od] - a1.lat[o1]).abs().max())
    dp = float((out.p[od] - a1.p[o1]).abs().max())
    if not (dlon < 1e-9 and dlat < 1e-9 and dp < 1e-9):
        raise RuntimeError(f"dd_vs_cpu: DD against the plain run: dlon "
                           f"{dlon}, dlat {dlat}, dp {dp}")
    migrated = int(np.abs(np.diff(np.asarray([s[0] for s in pg]),
                                  axis=0)).sum())

    # the stress case on the card
    n = 10_000
    ctl, clim, met01, atm = dd_case(torch, DD_STRESS_ARGS, n, 11, "cuda",
                                    lat=(-55, 55))
    dd = ddm.plan_decomposition(ctl, met01, ndev=9)
    tiles = ddm.make_tiles(dd, met01)
    lat_axis = met01.lat[0].cpu().numpy()
    group = ddm.local_group(9, "cuda")
    a, c = ddm.scatter_parcels(dd, atm, 4096, lat_axis)
    step = ddm.make_dd_step(ctl, clim, dd, group, 4096, 1024, lat_axis)
    lost_tot = 0
    for i in range(1, 25):
        a, c, ov, lo = step(tiles, a, c, i * 1200.0)
        lost_tot += int(lo.sum())
        if int(ov.sum()) or int(a.np.sum()) + lost_tot != n:
            raise RuntimeError(f"dd_vs_cpu stress: step {i}: overflow "
                               f"{int(ov.sum())}, live {int(a.np.sum())} "
                               f"+ lost {lost_tot} != {n}")
    if not (a.np > 0).all():
        raise RuntimeError(f"dd_vs_cpu stress: an empty subdomain {a.np}")
    tiny = ddm.make_dd_step(ctl, clim, dd, group, 4096, 1, lat_axis)
    at, _, ov1, lo1 = tiny(tiles, a, c, 25 * 1200.0)
    dropped = int(ov1.sum())
    if not (dropped > 0 and int(at.np.sum()) + int(lo1.sum()) + dropped
            == int(a.np.sum())):
        raise RuntimeError(f"dd_vs_cpu stress: overflow at exch_cap 1 "
                           f"{dropped}, live {int(at.np.sum())}")
    lat_r = lat_axis[np.abs(lat_axis) <= 60.0]
    dd_reg = ddm.DDGrid(n_zonal=3, n_merid=3, halo=4, nx_glob=dd.nx_glob,
                        ny_glob=lat_r.size, lon0=dd.lon0, dlon=dd.dlon,
                        periodic=dd.periodic)
    rng = np.random.default_rng(11)
    for _ in range(3):
        rng.uniform(0, 1, n)                 # the stress case's draws
    atm2 = atm.replace(lat=torch.from_numpy(rng.uniform(50, 59.5, n)).to(
        "cuda"))
    a2, c2 = ddm.scatter_parcels(dd_reg, atm2, 4096, lat_r)
    step_r = ddm.make_dd_step(ctl, clim, dd_reg, group, 4096, 1024, lat_r)
    reg_lost = 0
    for i in range(1, 13):
        a2, c2, _, lo = step_r(tiles, a2, c2, i * 1200.0)
        reg_lost += int(lo.sum())
    if not (reg_lost > 0 and int(a2.np.sum()) + reg_lost == n):
        raise RuntimeError(f"dd_vs_cpu stress: regional lost {reg_lost}, "
                           f"live {int(a2.np.sum())}")
    say(json.dumps({"dd_vs_cpu": {
        "steps": nsteps, "n_parcels": 200, "max_abs_err": errs,
        "tolerance": {k: TOLS_F64.get(k, 0.0) for k in errs},
        "counts_equal": True, "migrations": migrated,
        "vs_plain_run": {"dlon": dlon, "dlat": dlat, "dp": dp},
        "stress": {"n_parcels": n, "lost": lost_tot,
                   "counts": a.np.tolist(), "overflow_exch_cap_1": dropped,
                   "regional_lost": reg_lost}}}))


def dist_inputs(torch, metdir, nsub, ranks, device):
    """tests/helpers/dd_worker.py's case with ``nsub`` zonal subdomains:
    (ctl, clim, dd, lat_glob, stacked tiles of ``ranks``, atm, the global
    met read) on ``device``."""
    import numpy as np

    from mptrac_tpu_torch.climatology import read_clim
    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.met.build import read_met
    from mptrac_tpu_torch.parallel import dd as ddm
    from mptrac_tpu_torch.types import Atm, stack_met

    ctl = read_ctl(None, [
        "NQ", "1", "QNT_NAME[0]", "m", "METBASE", "-", "DT_MOD", "180",
        "DIFFUSION", "0", "T_STOP", "3600", "MET_TROPO", "0",
        "MET_CAPE", "0", "MET_PBL", "3", "DD", "1",
        "DD_SUBDOMAINS_ZONAL", str(nsub), "DD_SUBDOMAINS_MERIDIONAL", "1",
        "DD_HALOS_SIZE", "2"])
    clim = read_clim(ctl, device=device)
    met_glob = read_met(os.path.join(metdir, DIST_FILES[0]), ctl,
                        device=device)
    dd = ddm.plan_decomposition(ctl, met_glob, ndev=nsub)
    lat_glob = met_glob.lat.cpu().numpy()
    pairs = []
    for r in ranks:
        t = [ddm.read_met_tile(os.path.join(metdir, f), ctl, dd, r, lat_glob,
                               clim, device=device) for f in DIST_FILES]
        pairs.append(stack_met(t[0], t[1]))
    rng = np.random.default_rng(7)
    n = DIST_N
    cols = [torch.from_numpy(rng.uniform(lo, hi, n)).to(device)
            for lo, hi in ((-170, 170), (-60, 60), (300, 800))]
    f64 = torch.float64
    atm = Atm(time=torch.zeros(n, dtype=f64, device=device), p=cols[2],
              lon=cols[0], lat=cols[1],
              q={"m": torch.ones(n, dtype=f64, device=device)}, np=n)
    return ctl, clim, dd, lat_glob, ddm.stack_tiles(pairs), atm, met_glob


def dist_blocks(a, c):
    import numpy as np
    out = {k: getattr(a, k).cpu().numpy() for k in ("time", "p", "lon",
                                                    "lat")}
    out["q_m"] = a.q["m"].cpu().numpy()
    out["uvwp"] = c.uvwp.cpu().numpy()
    out["np"] = np.asarray(a.np)
    out["rng_ctr"] = np.asarray(c.rng_ctr, np.uint64)
    return out


def dd_rank_main(rank, world, port, metdir, backend):
    """One rank of ``dd_dist`` (``chip_smoke.py --dd-rank``): joins the
    process group on ``backend``, holds one subdomain on CUDA device
    ``rank`` modulo the devices present, checks ``read_met_shared``
    against ``read_met``, steps its block and writes it to
    ``metdir/rank<rank>_<backend>_<world>.npz``."""
    import numpy as np
    import torch

    from mptrac_tpu_torch.parallel import dd as ddm
    from mptrac_tpu_torch.parallel import multihost

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    rt = multihost.init_distributed(f"localhost:{port}", world, rank,
                                    local_devices=[dev], backend=backend)
    try:
        ctl, clim, dd, lat_glob, tiles, atm, met_glob = dist_inputs(
            torch, metdir, world, [rank], dev)
        shared = multihost.read_met_shared(
            os.path.join(metdir, DIST_FILES[0]), ctl, rt)
        same = dict(rtol=0, atol=0, equal_nan=True)
        for k in met_glob.fields3d:
            torch.testing.assert_close(shared.fields3d[k],
                                       met_glob.fields3d[k], **same)
        for k in met_glob.fields2d:
            torch.testing.assert_close(shared.fields2d[k],
                                       met_glob.fields2d[k], **same)
        a, c = ddm.scatter_parcels(dd, atm, DIST_CAP, lat_glob)
        a, c = ddm.subdomain_block(a, c, DIST_CAP, [rank])
        step = ddm.make_dd_step(ctl, clim, dd, multihost.global_mesh(rt),
                                DIST_CAP, DIST_EXCH, lat_glob)
        lost = ovf = 0
        for i in range(DIST_STEPS):
            a, c, ov, lo = step(tiles, a, c, (i + 1) * 180.0)
            lost += int(lo.sum())
            ovf += int(ov.sum())
        total = multihost.allsum_scalar(float(a.np.sum()) + lost, rt)
        if multihost.allsum_scalar(float(ovf), rt) != 0 or total != DIST_N:
            raise RuntimeError(f"rank {rank}: overflow, or {total} parcels")
        np.savez(os.path.join(metdir, f"rank{rank}_{backend}_{world}.npz"),
                 **dist_blocks(a, c))
    finally:
        torch.distributed.destroy_process_group()
    print(f"OK rank={rank} backend={rt.backend}", flush=True)


def run_ranks(world, metdir, backend):
    """``world`` rank processes of this script on one process group:
    (all ended with 0, the last lines of each one's errors, each one's
    whole standard error)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, LOGLEV="0")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dd-rank", str(r),
         str(world), str(port), metdir, backend], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    tails, errs, ok = [], [], True
    t_end = time.time() + DIST_TIMEOUT
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                ok = False
                tails.append("timed out")
                continue
            done = p.returncode == 0 and "OK rank=" in out
            ok = ok and done
            errs.append(err or "")
            lines = [x for x in (err or "").strip().splitlines()
                     if "Warning" not in x and "nc.close" not in x]
            tails.append("" if done else " | ".join(lines[-4:])[-600:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ok, tails, errs


def phase_dd_dist(torch):
    """The process-group route on the card, on dd_worker.py's case: one
    NCCL rank per card present, one subdomain each; the ranks' blocks
    against the local group's on the card, bit for bit.  Then two ranks on
    one card: NCCL first; where it refuses them with its duplicate-GPU
    error (and only then), gloo with the ranks' CUDA buffers; each
    attempt's outcome and the backend that carried it are printed, and
    the phase fails unless one carried it equal to the local group."""
    import numpy as np

    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.met.write_nc import write_met_nc
    from mptrac_tpu_torch.parallel import dd as ddm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dd_")
    try:
        for t0, name in zip((0.0, 3600.0), DIST_FILES):
            write_met_nc(os.path.join(tmp, name),
                         make_wind_met(t0=t0, nx=36, ny=19, nz=8,
                                       device="cpu"),
                         drop_wrap_column=True)

        def local(world):
            ctl, clim, dd, lat_glob, tiles, atm, _ = dist_inputs(
                torch, tmp, world, range(world), "cuda")
            a, c = ddm.scatter_parcels(dd, atm, DIST_CAP, lat_glob)
            step = ddm.make_dd_step(ctl, clim, dd,
                                    ddm.local_group(world, "cuda"),
                                    DIST_CAP, DIST_EXCH, lat_glob)
            for i in range(DIST_STEPS):
                a, c, _, _ = step(tiles, a, c, (i + 1) * 180.0)
            return dist_blocks(a, c)

        def held(world, backend):
            want = local(world)
            got = [dict(np.load(os.path.join(
                tmp, f"rank{r}_{backend}_{world}.npz"))) for r in range(world)]
            for k, v in want.items():
                joined = np.concatenate([g[k] for g in got], axis=-1)
                if not np.array_equal(joined, v,
                                      equal_nan=v.dtype.kind == "f"):
                    raise RuntimeError(f"dd_dist ({backend}, {world} "
                                       f"ranks): {k} differs from the local "
                                       "group")
            return int(want["np"].sum())

        report = {}
        world = torch.cuda.device_count()
        t0 = time.time()
        ok, tails, _ = run_ranks(world, tmp, "nccl")
        if not ok:
            raise RuntimeError(f"dd_dist: {world} NCCL rank(s) failed: "
                               f"{tails}")
        report["one_rank_per_card"] = dict(
            ranks=world, backend="nccl", live=held(world, "nccl"),
            seconds=time.time() - t0, equal_to_local_group=True)
        say(f"[dd_dist] {world} rank(s) over NCCL, one a card: equal to "
            "the local group bit for bit")
        two = {}
        for backend in ("nccl", "gloo"):
            t0 = time.time()
            ok, tails, errs = run_ranks(2, tmp, backend)
            two[backend] = dict(ok=ok, seconds=time.time() - t0,
                                errors=[t for t in tails if t])
            say(f"[dd_dist] two ranks on one card over {backend}: "
                + ("carried the exchange" if ok else f"failed: {tails}"))
            if ok:
                two[backend]["live"] = held(2, backend)
                two[backend]["equal_to_local_group"] = True
                two["carried_by"] = backend
                break
            # only NCCL's refusal of two ranks on one card passes on to
            # gloo; any other failure is the route's own
            if backend != "nccl" or not any(DUPLICATE_GPU in e
                                             for e in errs):
                raise RuntimeError(f"dd_dist: two ranks over {backend} "
                                   f"failed: {tails}")
            two[backend]["refused"] = DUPLICATE_GPU
        if "carried_by" not in two:
            raise RuntimeError("dd_dist: no backend carried two ranks")
        report["two_ranks_one_card"] = two
        say(json.dumps({"dd_dist": report}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--np", type=int, default=N_FLAGSHIP,
                    help="parcels of every path (debugging only)")
    ap.add_argument("--steps", type=int, default=TIMED_STEPS,
                    help="timed steps of both paths (debugging only)")
    ap.add_argument("--profile", action="store_true",
                    help="profile two extra steps of each path: time by "
                    "module and by kernel")
    ap.add_argument("--dd-rank", nargs=5, metavar=("RANK", "WORLD", "PORT",
                                                  "DIR", "BACKEND"),
                    help="run one rank of the dd_dist phase (the phase "
                    "starts these itself)")
    args = ap.parse_args()
    if args.dd_rank:
        root = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, root)
        r, w, port, metdir, backend = args.dd_rank
        dd_rank_main(int(r), int(w), port, metdir, backend)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    t_start = time.time()
    seconds = {}

    def phase(name, fn, *a):
        """Run one phase, print its seconds, free what it left cached."""
        t0 = time.time()
        out = fn(*a)
        torch.cuda.empty_cache()
        seconds[name] = round(time.time() - t0, 1)
        say(f"[phase] {name}: {seconds[name]} s")
        return out

    smi = phase("environment", phase_environment, torch)
    usage = phase("build", phase_build)
    sim, counts = phase("main_path", phase_main_path, torch, args.np,
                        args.steps, args.profile)
    kernels = phase("kernels", phase_kernels, torch, sim, counts, usage)
    del sim                     # one simulation is freed before the next
    torch.cuda.empty_cache()
    sim, counts = phase("unfused_path", phase_unfused_path, torch, args.np,
                        args.steps, args.profile)
    kernels += phase("kernels_unfused", phase_kernels_unfused, torch, sim,
                     counts)
    del sim
    torch.cuda.empty_cache()
    phase("card_vs_cpu", phase_card_vs_cpu, torch)
    sim, counts = phase("chem_path", phase_chem_path, torch, args.np,
                        args.steps, args.profile)
    del sim
    torch.cuda.empty_cache()
    sim = phase("pbl_path", phase_pbl_path, torch, args.np, args.steps,
                args.profile)
    del sim
    torch.cuda.empty_cache()
    sim = phase("iso_path", phase_iso_path, torch, args.np, args.steps,
                args.profile)
    del sim
    torch.cuda.empty_cache()
    sim = phase("kpp_path", phase_kpp_path, torch, min(args.np, KPP_N),
                args.profile)
    del sim
    torch.cuda.empty_cache()
    phase("checkpoint", phase_checkpoint, torch, min(args.np, CKPT_N))
    phase("card_vs_cpu_slice", phase_slice_vs_cpu, torch)
    trac = phase("trac_path", phase_trac_path, torch, args.np)
    try:
        # the phases that run on trac_path's case and files
        phase("bin_path", phase_bin_path, torch, trac)
        phase("codec_path", phase_codec_path, torch, trac)
        phase("capi", phase_capi, torch, trac)
    finally:
        shutil.rmtree(trac["tmp"], ignore_errors=True)
    phase("grib_path", phase_grib_path, torch)
    phase("clams_atm", phase_clams_atm, torch, args.np)
    phase("formats_vs_cpu", phase_formats_vs_cpu, torch)
    phase("output_path", phase_output_path, torch, args.np, trac)
    phase("trac_vs_cpu", phase_trac_vs_cpu, torch)
    phase("writers_vs_cpu", phase_writers_vs_cpu, torch)
    phase("golden_long", phase_golden_long, torch)
    phase("golden_chem", phase_golden_chem, torch)
    phase("zeta_path", phase_zeta_path, torch, args.np)
    phase("golden_zeta", phase_golden_zeta, torch)
    kernels += phase("probes", phase_probes, torch, args.np)
    k3_dd = phase("dd_path", phase_dd_path, torch, args.np)
    for k in kernels:
        if k["name"] == "permute_cols":
            k["dd_path"] = k3_dd
    phase("dd_vs_cpu", phase_dd_vs_cpu, torch)
    phase("dd_dist", phase_dd_dist, torch)
    say(json.dumps({"phase_seconds": seconds}))
    say(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
