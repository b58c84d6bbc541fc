"""The C API of the port (``mptrac_tpu_torch/bindings``,
``mptrac_tpu_torch.capi``): the shim and the demo program are built from
the port's own sources, and the demo runs the port on the CPU through
the C surface to the particle file that ``run_trac`` writes (the analog
of the reference Fortran-wrapper test, trac_fortran.f90, and of
tests/test_capi.py for the JAX package)."""

import os
import subprocess

import pytest
import torch

from mptrac_tpu_torch import capi, flagship
from mptrac_tpu_torch.sim import run_trac

os.environ.setdefault("LOGLEV", "0")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

OUT = "_2000_01_01_01_15_00.bin"


@pytest.fixture(scope="module")
def demo():
    return capi.build_shim()["demo"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_demo_matches_run_trac(demo, tmp_path, dtype):
    """``demo_trac <dir> trac.ctl atm_in.bin ... --device cpu --dtype D``
    steps the flagship case (36x19x8, 2048 parcels, the fused path in
    float32) to the end and writes the particle file of ``run_trac`` on
    the same case, byte for byte."""
    d = str(tmp_path)
    flagship.write_case(d, 2048, (36, 19, 8), 2700.0, 4500.0, 900,
                        extra_ctl=("TPU_FAST", "2"))
    r = subprocess.run(
        [demo, d, "trac.ctl", "atm_in.bin", "ATM_BASENAME", "capi",
         "--device", "cpu", "--dtype", dtype],
        env=capi.demo_env({"LOGLEV": "0", "OMP_NUM_THREADS": "1"}),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 11 steps, 2048 parcels at t=4500" in r.stdout
    run_trac(d, "trac.ctl", "atm_in.bin", ("ATM_BASENAME", "py"),
             device="cpu", dtype=getattr(torch, dtype))
    with open(os.path.join(d, "capi" + OUT), "rb") as a, \
            open(os.path.join(d, "py" + OUT), "rb") as b:
        assert a.read() == b.read()


def test_create_options_and_positions(tmp_path):
    """The Python side as the shim calls it: ``--device`` and ``--dtype``
    in the KEY VALUE list, the time range, stepping, the positions copied
    into caller buffers, ``write_atm`` and ``destroy``; a wrong option
    value names the choices."""
    import ctypes

    import numpy as np

    from mptrac_tpu_torch.tools._cli import UsageError
    d = str(tmp_path)
    flagship.write_case(d, 64, (36, 19, 8), 2700.0, 3240.0, 900)
    with pytest.raises(UsageError, match="cuda, cpu"):
        capi.create(d, "trac.ctl", "atm_in.bin", ["--device", "tpu"])
    h = capi.create(d, "trac.ctl", "atm_in.bin",
                    ["ATM_BASENAME", "-", "--device", "cpu", "--dtype",
                     "float32"])
    sim = capi._handles[h]["sim"]
    assert sim.atm.lon.dtype == torch.float32 and sim.atm.lon.device.type == "cpu"
    assert (capi.t_start(h), capi.t_stop(h)) == (2700.0, 3240.0)
    assert capi.step(h, 0) == 1 and capi.time(h) == 2700.0
    assert capi.run(h, 0) == 0 and capi.time(h) == 3240.0
    bufs = [(ctypes.c_double * 10)() for _ in range(3)]
    assert capi.get_positions(h, *(ctypes.addressof(b) for b in bufs),
                              10) == 10
    np.testing.assert_array_equal(np.frombuffer(bufs[0], np.float64),
                                  sim.atm.lon[:10].double().numpy())
    assert capi.n_parcels(h) == 64
    capi.write_atm(h, os.path.join(d, "out.bin"))
    assert os.path.getsize(os.path.join(d, "out.bin")) == 8 + 64 * 6 * 8 + 4
    assert capi.destroy(h) == 0 and h not in capi._handles
