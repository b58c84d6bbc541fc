"""met_check_dt — timestep stability diagnostics
(reference src/met_check_dt.c).

Usage: python -m mptrac_tpu_torch.tools.met_check_dt <ctl> <dt_file> <met>
       DX <km> [KEY VALUE ...] [--device cuda|cpu]

Reports the maximum stable model timestep per level from the CFL
criterion (advective Courant number CMAX for the grid spacing DX) and
the diffusion number NMAX for the turbulence coefficients.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool


_USAGE = ("met_check_dt <ctl> <dt_file> <met> [KEY VALUE ...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    dx = 1e3 * s.scan_float("DX")
    c_max = s.scan_float("CMAX", -1, "0.5")
    n_max = s.scan_float("NMAX", -1, "0.3")
    clim = read_clim(ctl, device=device)
    met = read_met(argv[3], ctl, clim, device=device)

    p = met.p.cpu().numpy()
    u = met.fields3d["u"].cpu().numpy().astype(np.float64)
    v = met.fields3d["v"].cpu().numpy().astype(np.float64)
    kx = max(ctl.turb_dx_pbl, ctl.turb_dx_trop, ctl.turb_dx_strat)

    with open(argv[2], "w") as out:
        out.write("# $1 = altitude [km]\n# $2 = pressure [hPa]\n"
                  "# $3 = maximum wind speed [m/s]\n"
                  "# $4 = advective dt limit [s]\n"
                  "# $5 = diffusive dt limit [s]\n\n")
        for iz in range(p.size):
            vmax = float(np.nanmax(np.hypot(u[:, :, iz], v[:, :, iz])))
            dt_adv = c_max * dx / max(vmax, 1e-6)
            dt_diff = n_max * dx * dx / max(2.0 * kx, 1e-6)
            out.write("%g %g %g %g %g\n" % (
                H0 * np.log(P0 / p[iz]), p[iz], vmax, dt_adv, dt_diff))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
