"""cape — point calculation of CAPE/CIN/LCL/LFC/EL from a met file
(reference src/cape.c).

Usage: python -m mptrac_tpu_torch.tools.cape <ctl> <met> <lon> <lat>
       [KEY VALUE ...] [--device cuda|cpu]

The met data and the sampling live on ``--device`` (default cuda).
"""

import sys

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool

_USAGE = "cape <ctl> <met> <lon> <lat> [KEY VALUE ...] [--device cuda|cpu]"


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 5, _USAGE)
    import torch

    from mptrac_tpu_torch.ops import interp
    ctl = read_ctl(argv[1], argv[4:]).replace(met_cape=1)
    met = read_met(argv[2], ctl, device=device)
    lon, lat = float(argv[3]), float(argv[4])

    def point(x):
        return torch.tensor([x], dtype=torch.float64, device=met.lon.device)

    loc = interp.locate_3d(met, point(lon), point(lat), point(500.0))
    for name in ("plcl", "plfc", "pel", "cape", "cin"):
        v = float(interp.interp_2d(met.fields2d[name], loc)[0])
        print(f"{name} = {v:g}")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
