"""met_sample — sample meteo data at given points
(reference src/met_sample.c).

Usage: python -m mptrac_tpu_torch.tools.met_sample <ctl> <sample.tab>
       <atm_in> [KEY VALUE ...] [--device cuda|cpu]

Reads points (time, z, lon, lat) from an atm file and samples the
standard variable record with full 4-D (two-snapshot) interpolation.
The points that one met pair brackets are sampled in one call on
``--device`` (default cuda), each with its own arithmetic, so the file
is the one a point at a time gives.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.io.atm_io import read_atm
from mptrac_tpu_torch.sim import MetBuffer, _snapshot
from mptrac_tpu_torch.tools._cli import (host_columns, pop_device,
                                         require_args, run_tool)
from mptrac_tpu_torch.tools._met_sample import (MET_HEADER, record_columns,
                                                sample_met, write_records)

_USAGE = "met_sample <ctl> <sample.tab> <atm_in> [--device cuda|cpu]"


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    clim = read_clim(ctl, device=device)
    time, p, lon, lat, _ = host_columns(read_atm(argv[3], ctl,
                                                 device="cpu"))
    n = time.size

    metbuf = MetBuffer(ctl.replace(t_start=float(time.min()),
                                   t_stop=float(time.max()) + 1), clim,
                       device=device)
    with open(argv[2], "w") as out:
        out.write(MET_HEADER)
        out.write("\n")
        i = 0
        while i < n:
            # the run of points that the pair of point i brackets
            pair = metbuf.get(time[i])
            j = i + 1
            while j < n and not metbuf.swap_due(time[j]):
                j += 1
            sel = slice(i, j)
            s0 = sample_met(ctl, clim, _snapshot(pair, 0), p[sel],
                            lon[sel], lat[sel])
            s1 = sample_met(ctl, clim, _snapshot(pair, 1), p[sel],
                            lon[sel], lat[sel])
            # time interpolation: sample both snapshots and lerp
            t0, t1 = pair.time
            wt = ((t1 - time[sel]) / (t1 - t0) if t1 != t0
                  else np.ones(j - i))
            smp = {k: wt * (s0[k] - s1[k]) + s1[k] for k in s0}
            write_records(out, record_columns(
                time[sel], H0 * np.log(P0 / p[sel]), lon[sel], lat[sel],
                p[sel], smp), (1, 1, 1))
            i = j
    metbuf.close()
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
