"""Time K6's sigma mode (``lane_interp.meso_sigma_sorted``) on the
flagship's parcels in three orders, on the card: just sorted by cell;
three unfused steps (``TPU_FAST 1``, 540 s) after that sort, as the
unfused path leaves them between two sorts (parcels that drifted into a
neighbouring cell split their old cell's run); and in a random order.

    python -m mptrac_tpu_torch.perf.lane_sigma [--n N] [--repeats R]

prints one JSON line: the card, N, for each order the parcels a run of
one cell and the milliseconds a call (CUDA events, after a warm-up
call), and the bound (each parcel's cell read and its three sigmas
written once, the 48 wind lanes of each table row that a parcel points
at read once, at 3.35 TB/s).  It uses only functions that earlier
versions of the package have too (``flagship.make_setup``,
``sim.Simulation``, ``lane_interp.build_lane_tables``), so the same
file times another checkout's kernel: run it with that checkout first
on ``PYTHONPATH`` (``cd <checkout> && PYTHONPATH=$PWD python <this
file>``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_BYTES_S = 3.35e12
GRID = (360, 181, 61)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_663_296)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    os.environ.setdefault("LOGLEV", "0")

    import torch
    from mptrac_tpu_torch import flagship
    from mptrac_tpu_torch.ops import interp, lane_interp
    from mptrac_tpu_torch.sim import FixedMet, Simulation

    if not torch.cuda.is_available():
        print("lane_sigma: no CUDA device", file=sys.stderr)
        return 2
    ctl, clim, met01, atm, cache = flagship.make_setup(
        args.n, *GRID, extra_args=("TPU_FAST", "1"), device="cuda")
    sim = Simulation(ctl, atm, clim, met=FixedMet(met01), cache=cache)
    del atm, cache
    ny, npl = met01.ny, met01.npl

    def cells_of(a):
        loc = interp.locate_3d(met01, a.lon, a.lat, a.p)
        return ((loc.ix * ny + loc.iy) * npl + loc.iz).to(torch.int32)

    sim.sort(met01)
    bases = {"sorted": cells_of(sim.atm)}
    sim.run(write_output=False, ts=[180.0 * (i + 1) for i in range(3)])
    bases["drifted"] = cells_of(sim.atm)
    del sim
    gen = torch.Generator(device="cuda").manual_seed(1)
    bases["random"] = bases["sorted"][torch.randperm(
        args.n, device="cuda", generator=gen)]
    torch.cuda.empty_cache()
    lanes = lane_interp.build_lane_tables(met01)
    cells = int(torch.unique(bases["sorted"]).numel())

    def ms(b):
        lane_interp.meso_sigma_sorted(lanes, b)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.repeats):
            lane_interp.meso_sigma_sorted(lanes, b)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.repeats

    orders = {name: {
        "parcels_per_run": args.n / int(torch.unique_consecutive(b).numel()),
        "ms": ms(b)} for name, b in bases.items()}
    nbytes = args.n * 16 + cells * 192
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    bound = 1e3 * nbytes / PEAK_BYTES_S
    print(json.dumps({"lane_sigma": {
        "card": smi, "n": args.n, "grid": list(GRID), "orders": orders,
        "bound_ms": bound, "cells_touched": cells,
        "share_of_bound": {k: bound / v["ms"] for k, v in orders.items()}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
