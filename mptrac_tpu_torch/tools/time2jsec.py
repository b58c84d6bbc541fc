"""time2jsec — convert calendar date to Julian seconds
(reference src/time2jsec.c).

Usage: python -m mptrac_tpu_torch.tools.time2jsec <year> <mon> <day>
       <hour> <min> <sec> <remain>
"""

import sys

from mptrac_tpu_torch.timeutil import time2jsec
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 8,
                 "time2jsec <year> <mon> <day> <hour> <min> <sec> <remain>")
    jsec = time2jsec(int(argv[1]), int(argv[2]), int(argv[3]),
                     int(argv[4]), int(argv[5]), int(argv[6]),
                     float(argv[7]))
    print("%.2f" % jsec)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
