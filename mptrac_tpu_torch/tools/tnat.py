"""tnat — calculate NAT existence temperature
(reference src/tnat.c).

Usage: python -m mptrac_tpu_torch.tools.tnat <p> <h2o> <hno3>

p [hPa], h2o and hno3 volume mixing ratios [ppv].
"""

import sys

from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 4, "tnat <p> <h2o> <hno3>")
    import torch

    from mptrac_tpu_torch.ops.thermo import nat_temperature
    p, h2o, hno3 = (torch.tensor(float(a), dtype=torch.float64)
                    for a in argv[1:4])
    t = float(nat_temperature(p, h2o, hno3))
    print("p= %s hPa, q_H2O= %s ppv, q_HNO3= %s ppv, T_NAT= %g K"
          % (argv[1], argv[2], argv[3], t))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
