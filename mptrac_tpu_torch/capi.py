"""Python side of the C binding (``bindings/mptrac_c.c``).

Counterpart of the JAX package's ``capi.py``.  The C shim embeds the
interpreter and calls these module-level functions with plain
scalars and strings; the simulation state lives in a handle registry
here.  This is the analog of the reference Fortran wrapper
(mptrac_fortran.f90:123-807), which exposes the ``mptrac_*`` library
calls to foreign code.  ``create``'s ``KEY VALUE`` list may hold
``--device cuda|cpu`` (default ``cuda``) and ``--dtype float64|float32``
(default ``float64``), as the ``trac`` tool's command line.

``build_shim`` compiles ``bindings/mptrac_c.c`` into ``libmptrac_c.so``
and ``bindings/demo_trac.c`` into ``demo_trac`` with ``gcc`` and the
interpreter's own embedding flags (``sysconfig``, as ``python3-config
--embed`` gives them), at first use, into
``build/mptrac_tpu_torch/<hash>/`` beside the package.  ``demo_env``
is the environment in which a C host finds this package and the
interpreter's packages.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from typing import Dict, Optional

_handles: Dict[int, dict] = {}
_ids = itertools.count(1)

_PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_PKG)
BINDINGS = os.path.join(_PKG, "bindings")
BUILD_ROOT = os.path.join(ROOT, "build", "mptrac_tpu_torch")

CC = "gcc"
CFLAGS = ("-O2", "-Wall", "-Wextra")


def create(dirname: str, ctl_file: str, atm_file: str,
           args: Optional[list] = None) -> int:
    """mptrac_read_ctl + read_atm + mptrac_init; returns a handle."""
    import torch

    from mptrac_tpu_torch.config import read_ctl
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.sim import Simulation
    from mptrac_tpu_torch.tools._cli import pop_device, pop_option
    from mptrac_tpu_torch.tools.trac import _USAGE

    args = list(args or ())
    device = pop_device(args, _USAGE)
    dtype = getattr(torch, pop_option(args, "--dtype", "float64",
                                      ("float64", "float32"), _USAGE))
    ctl = read_ctl(os.path.join(dirname, ctl_file), args)
    atm = atm_io.read_atm(os.path.join(dirname, atm_file), ctl, dtype=dtype,
                          device=device)
    sim = Simulation(ctl, atm, dirname=dirname, dtype=dtype)
    h = next(_ids)
    _handles[h] = {"sim": sim, "times": sim.times(), "t": float("nan")}
    return h


def t_start(h: int) -> float:
    return float(_handles[h]["sim"].ctl.t_start)


def t_stop(h: int) -> float:
    return float(_handles[h]["sim"].ctl.t_stop)


def time(h: int) -> float:
    return _handles[h]["t"]


def step(h: int, write_output: bool = True) -> int:
    """Advance one model timestep (mptrac_get_met +
    mptrac_run_timestep + mptrac_write_output).  Returns 1 while
    stepping, 0 when the time loop is exhausted."""
    st = _handles[h]
    t = next(st["times"], None)
    if t is None:
        st["sim"].close()
        return 0
    st["sim"].advance(t, bool(write_output))
    st["t"] = float(t)
    return 1


def run(h: int, write_output: bool = True) -> int:
    """Run the remaining time loop to completion."""
    while step(h, write_output):
        pass
    return 0


def n_parcels(h: int) -> int:
    return int(_handles[h]["sim"].atm.np)


def get_positions(h: int, lon_addr: int, lat_addr: int, p_addr: int,
                  cap: int) -> int:
    """Copy parcel positions into caller-owned buffers (addresses of
    double[cap]); the mptrac_update_host analog.  Returns the parcel
    count written."""
    import ctypes

    import numpy as np

    sim = _handles[h]["sim"]
    n = min(int(sim.atm.np), cap)
    for addr, col in ((lon_addr, sim.atm.lon), (lat_addr, sim.atm.lat),
                      (p_addr, sim.atm.p)):
        buf = (ctypes.c_double * n).from_address(addr)
        np.frombuffer(buf, np.float64)[:] = col[:n].detach().cpu().numpy()
    return n


def write_atm(h: int, path: str) -> int:
    """mptrac_write_atm analog: dump current particle state."""
    from mptrac_tpu_torch.io import atm_io

    st = _handles[h]
    atm_io.write_atm(path, st["sim"].ctl, st["sim"].atm, st["t"])
    return 0


def destroy(h: int) -> int:
    st = _handles.pop(h, None)
    if st is not None:
        st["sim"].close()
        st["sim"].met.close()
    return 0


# ------------------------------------------------------------- the shim

def _embed_flags():
    """(compile flags, link flags) of the running interpreter for an
    embedding host."""
    cfg = sysconfig.get_config_var
    inc = ["-I" + sysconfig.get_paths()["include"]]
    libdir = cfg("LIBDIR") if cfg("Py_ENABLE_SHARED") else cfg("LIBPL")
    link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{cfg('LDVERSION')}"]
    link += (cfg("LIBS") or "").split() + (cfg("SYSLIBS") or "").split()
    return inc, link


def shim_dir() -> str:
    """The build directory of the shim for the current sources, flags
    and interpreter."""
    inc, link = _embed_flags()
    h = hashlib.sha256(" ".join((CC,) + CFLAGS + tuple(inc + link)
                                + (sys.version,)).encode())
    for name in ("mptrac_c.c", "mptrac_c.h", "demo_trac.c"):
        h.update(name.encode())
        with open(os.path.join(BINDINGS, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_shim() -> Dict[str, str]:
    """Compile ``libmptrac_c.so`` and ``demo_trac`` if missing; returns
    their paths.  Raises with the compiler's output on a failure."""
    out = shim_dir()
    paths = {"lib": os.path.join(out, "libmptrac_c.so"),
             "demo": os.path.join(out, "demo_trac")}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    cc = shutil.which(CC)
    if cc is None:
        raise RuntimeError(f"{CC} not found on PATH: the C API of "
                           "mptrac_tpu_torch cannot be built")
    inc, link = _embed_flags()
    os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp_build_", dir=out)
    try:
        lib = os.path.join(tmp, "libmptrac_c.so")
        demo = os.path.join(tmp, "demo_trac")
        for cmd in (
                [cc, *CFLAGS, "-shared", "-fPIC", *inc,
                 os.path.join(BINDINGS, "mptrac_c.c"), *link, "-o", lib],
                [cc, *CFLAGS, "-I" + BINDINGS,
                 os.path.join(BINDINGS, "demo_trac.c"), f"-L{tmp}",
                 "-lmptrac_c", "-Wl,-rpath,$ORIGIN", *link, "-o", demo]):
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{CC} failed ({proc.returncode}) building the C API:\n"
                    f"$ {' '.join(cmd)}\n{proc.stdout}")
        # the demo first: a reader that sees the library sees both
        os.replace(demo, paths["demo"])
        os.replace(lib, paths["lib"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def demo_env(extra: Optional[dict] = None) -> Dict[str, str]:
    """The environment of a C host that embeds this interpreter: the
    repository and this interpreter's ``sys.path`` on ``PYTHONPATH`` (an
    embedded interpreter does not see a virtual environment), and
    ``MPTRAC_TPU_ROOT``."""
    path = [ROOT] + [p for p in sys.path if p and os.path.isdir(p)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
               MPTRAC_TPU_ROOT=ROOT)
    env.update(extra or {})
    return env
