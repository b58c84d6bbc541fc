"""doy2day — convert day of year to calendar date
(reference src/doy2day.c).

Usage: python -m mptrac_tpu_torch.tools.doy2day <year> <doy>
"""

import sys

from mptrac_tpu_torch.timeutil import doy2day
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 3, "doy2day <year> <doy>")
    mon, day = doy2day(int(argv[1]), int(argv[2]))
    print(f"{mon:d} {day:d}")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
