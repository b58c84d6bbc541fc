"""atm_conv — convert between atm file formats
(reference src/atm_conv.c).

Usage: python -m mptrac_tpu_torch.tools.atm_conv <ctl> <atm_in>
       <atm_in_type> <atm_out> <atm_out_type> [KEY VALUE ...]

Types: 0 = ASCII, 1 = binary, 2 = netCDF, 3/4 = CLaMS.
"""

from __future__ import annotations

import sys

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.io.atm_io import read_atm, write_atm
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 6, "atm_conv <ctl> <atm_in> <atm_in_type> "
                          "<atm_out> <atm_out_type> [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    ctl_in = ctl.replace(atm_type=int(argv[3]))
    ctl_out = ctl.replace(atm_type_out=int(argv[5]))
    atm = read_atm(argv[2], ctl_in, device="cpu")
    write_atm(argv[4], ctl_out, atm, 0.0)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
