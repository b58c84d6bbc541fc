"""Run one cell of the benchmark of ``mptrac_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints one JSON line (the result) as the
last line of standard output, and the numbers compared with their
limits as the last lines of standard error.  Exits 2 without a result
where there is no CUDA card, or too few for the cell.
"""

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), so that the
    set-up time counts the interpreter's start as well."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of a run lives at a fixed path inside the
# checkout (the program's own nvcc library goes to <checkout>/build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, "cache", sub)
os.environ["LOGLEV"] = "0"
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark import harness
    sys.exit(harness.main(t_start=T_START))
