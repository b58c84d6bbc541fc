"""met_subgrid — subgrid-scale wind variance diagnostics
(reference src/met_subgrid.c).

Usage: python -m mptrac_tpu_torch.tools.met_subgrid <ctl> <subgrid.tab>
       <met0> <met1> [KEY VALUE ...] [--device cuda|cpu]

Reports the local 16-point standard deviations of u/v/w between two
met snapshots (the quantity driving module_diff_meso), area-averaged
on pressure levels.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool


def _cell_sigma(a0, a1):
    """Per-cell 2x2x2x2 stencil standard deviation (the diff_meso
    subgrid variance, reference mptrac.c:4280-4310)."""
    stack = []
    for arr in (a0, a1):
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    stack.append(arr[dx:arr.shape[0] - 1 + dx,
                                     dy:arr.shape[1] - 1 + dy,
                                     dz:arr.shape[2] - 1 + dz])
    s = np.stack(stack)
    var = (s * s).mean(axis=0) - s.mean(axis=0) ** 2
    return np.sqrt(np.maximum(var, 0.0))


_USAGE = ("met_subgrid <ctl> <subgrid.tab> <met0> <met1> "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 5, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    clim = read_clim(ctl, device=device)
    met0 = read_met(argv[3], ctl, clim, device=device)
    met1 = read_met(argv[4], ctl, clim, device=device)
    p = met0.p.cpu().numpy()
    with open(argv[2], "w") as out:
        out.write("# $1 = altitude [km]\n# $2 = pressure [hPa]\n"
                  "# $3 = sigma(u) [m/s]\n# $4 = sigma(v) [m/s]\n"
                  "# $5 = sigma(w) [hPa/s]\n\n")
        sigs = {}
        for name in ("u", "v", "w"):
            sigs[name] = _cell_sigma(
                met0.fields3d[name].cpu().numpy().astype(np.float64),
                met1.fields3d[name].cpu().numpy().astype(np.float64))
        for iz in range(p.size - 1):
            out.write("%g %g %g %g %g\n" % (
                H0 * np.log(P0 / p[iz]), p[iz],
                np.nanmean(sigs["u"][:, :, iz]),
                np.nanmean(sigs["v"][:, :, iz]),
                np.nanmean(sigs["w"][:, :, iz])))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
