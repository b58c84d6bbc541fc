"""sedi — calculate sedimentation velocity
(reference src/sedi.c).

Usage: python -m mptrac_tpu_torch.tools.sedi <p> <T> <r_p> <rho_p>

p [hPa], T [K], particle radius r_p [microns], density rho_p [kg/m^3].
"""

import sys

from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 5, "sedi <p> <T> <r_p> <rho_p>")
    import torch

    from mptrac_tpu_torch.ops.thermo import sedi_velocity
    p, t, rp, rhop = (torch.tensor(float(a), dtype=torch.float64)
                      for a in argv[1:5])
    v = float(sedi_velocity(p, t, rp, rhop))
    print("v_s= %g m/s" % v)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
