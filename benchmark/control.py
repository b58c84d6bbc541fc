"""Readings for the limits of ``correct``: the program's numbers and the
control's on the same captured states, seed after seed, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 2 [--out readings.jsonl]

The control is the reference put in the program's place and computed in
bfloat16, the precision below the float32 that the configurations
state: from each checked step's captured state, the reference's step in
bfloat16 against its step in float64.  The benchmark's own runs do not
run it.  One JSON line a seed: the program's numbers (``program``), the
control's (``control``) and whether the run was correct.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))
os.environ.setdefault("LOGLEV", "0")


def readings(cell: str, seeds, seconds: float, device: str = "cuda",
             sizes=None):
    """Yield one dict of readings a seed."""
    from benchmark import harness
    for seed in seeds:
        out = harness.run(cell, seed, seconds, False, device=device,
                          sizes=sizes, control=True)
        yield {"cell": cell, "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"],
               "program": out["numbers"],
               "control": out["control"],
               "card": out["window"]["card"]}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    sink = open(a.out, "a") if a.out else None
    try:
        for rec in readings(a.workload, seeds, a.seconds):
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
