"""day2doy — convert calendar date to day of year
(reference src/day2doy.c).

Usage: python -m mptrac_tpu_torch.tools.day2doy <year> <mon> <day>
"""

import sys

from mptrac_tpu_torch.timeutil import day2doy
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 4, "day2doy <year> <mon> <day>")
    print("%d" % day2doy(int(argv[1]), int(argv[2]), int(argv[3])))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
