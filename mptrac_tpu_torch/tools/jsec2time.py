"""jsec2time — convert Julian seconds to calendar date
(reference src/jsec2time.c).

Usage: python -m mptrac_tpu_torch.tools.jsec2time <jsec>
"""

import sys

from mptrac_tpu_torch.timeutil import jsec2time
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 2, "jsec2time <jsec>")
    year, mon, day, hour, minute, sec, remain = jsec2time(float(argv[1]))
    print(f"{year:d} {mon:d} {day:d} {hour:d} {minute:d} {sec:d} "
          f"{remain:g}")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
