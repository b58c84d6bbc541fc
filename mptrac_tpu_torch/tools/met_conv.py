"""met_conv — convert meteo data between file formats
(reference src/met_conv.c).

Usage: python -m mptrac_tpu_torch.tools.met_conv <ctl> <met_in>
       <met_in_type> <met_out> <met_out_type> [KEY VALUE ...]

Types: 0 = netCDF, 1-5, 7, 8 = the MPTRAC binary containers.  The met
data are read and written on the host.
"""

import sys

from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 6, "met_conv <ctl> <met_in> <met_in_type> "
                          "<met_out> <met_out_type> [KEY VALUE ...]")
    ctl = read_ctl(argv[1], argv[2:])
    ctl_in = ctl.replace(met_type=int(argv[3]))
    out_type = int(argv[5])
    from mptrac_tpu_torch.met.build import read_met
    met = read_met(argv[2], ctl_in, device="cpu")
    if out_type == 0:
        from mptrac_tpu_torch.met.write_nc import write_met_nc
        write_met_nc(argv[4], met)
    elif out_type in (1, 2, 3, 4, 5, 7, 8):
        from mptrac_tpu_torch.met.bin_io import write_met_bin
        write_met_bin(argv[4], met, met_type=out_type,
                      pck_zstd=bool(ctl.met_pck_zstd),
                      zstd_level=ctl.met_zstd_level)
    else:
        raise SystemExit(f"MET_TYPE {out_type} not implemented!")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
