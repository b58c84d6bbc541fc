"""trac: the main simulation CLI.

Usage mirrors the reference (trac.c:78) and the JAX package's tool:

    python -m mptrac_tpu_torch.tools.trac <dirlist> <ctl> <atm_in>
        [KEY VALUE ...] [--device cuda|cpu] [--dtype float64|float32]

Each line of <dirlist> names a working directory containing the control
and particle files; tasks run sequentially (the reference distributes
them over MPI ranks: set MPTRAC_NTASK / MPTRAC_RANK for a job array, or
MPTRAC_WORKERS for a local process pool).

The control file's ``MET_TYPE`` (0 netCDF, 1-5, 7, 8 the binary
containers, 6 GRIB) and ``ATM_TYPE``/``ATM_TYPE_OUT`` (0 ASCII, 1
binary, 2 netCDF, 3 and 4 CLaMS) choose the file formats.
``--device`` defaults to ``cuda`` and the run raises without a GPU;
``--device cpu`` runs the plain PyTorch versions of the kernels.
``--dtype`` is the compute mode: ``float64`` (default, the
reference-parity mode) or ``float32``, in which ``TPU_FAST 1`` and ``2``
run the CUDA kernels.
"""

from __future__ import annotations

import os
import sys

from mptrac_tpu_torch.tools._cli import (pop_device, pop_option,
                                         require_args, run_tool)

_USAGE = ("trac <dirlist> <ctl> <atm_in> [KEY VALUE ...] "
          "[--device cuda|cpu] [--dtype float64|float32]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    dtype_name = pop_option(argv, "--dtype", "float64",
                            ("float64", "float32"), _USAGE)
    require_args(argv, 4, _USAGE)
    import torch

    from mptrac_tpu_torch.sim import run_trac
    dtype = getattr(torch, dtype_name)
    with open(argv[1]) as f:
        dirnames = [line.strip() for line in f if line.strip()]
    # Ensemble task farm (reference trac.c:86-94 distributes dirlist
    # tasks rank-strided over MPI)
    ntask = int(os.environ.get("MPTRAC_NTASK", "1"))
    rank = int(os.environ.get("MPTRAC_RANK", "0"))
    mine = dirnames[rank::ntask] if ntask > 1 else dirnames
    workers = int(os.environ.get("MPTRAC_WORKERS", "0"))
    if workers > 1 and len(mine) > 1:
        import subprocess
        import time
        procs = []
        for dirname in mine:
            env = dict(os.environ, MPTRAC_WORKERS="0")
            with open(os.path.join(dirname, "trac.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mptrac_tpu_torch.tools.trac",
                     "/dev/stdin", argv[2], argv[3], *argv[4:],
                     "--device", device, "--dtype", dtype_name],
                    stdin=subprocess.PIPE, stdout=log, stderr=log,
                    env=env, text=True))
                procs[-1].stdin.write(dirname + "\n")
                procs[-1].stdin.close()
            while sum(p.poll() is None for p in procs) >= workers:
                time.sleep(0.2)
        rcs = [p.wait() for p in procs]
        return max(rcs) if rcs else 0
    for dirname in mine:
        run_trac(dirname, argv[2], argv[3], argv[4:], device=device,
                 dtype=dtype)
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
