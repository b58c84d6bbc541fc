"""The plain versions of the probe kernels P1-P3 against the JAX probes.

``perf/probe.py`` is loaded from its path as it is.  Its two small
kernels (the grid-step doubling and the small-table gather) run in Pallas
interpret mode on the CPU: the test hands ``pl.pallas_call`` the
``interpret`` flag and takes the result out of the probe's own
``timeit``.  The lane kernel's plain version is held to
``ops.lane_interp._interp_rows`` on the rows ``packT.T[base]``, which is
the check the JAX probe makes of itself."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mptrac_tpu.ops.lane_interp import _interp_rows
from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.perf import probe as tprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "jax_perf_probe", os.path.join(ROOT, "perf", "probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(jprobe, monkeypatch):
    """The JAX probe with its kernels in interpret mode; every call that
    it times is made once and recorded as (arguments, result).  A test
    may queue its own arguments in ``given`` to take the place of the
    probe's."""
    calls, given = [], []
    pl = jprobe.pl

    class Pl:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(*a, **k):
            return pl.pallas_call(*a, interpret=True, **k)

    def timeit(fn, *args, **kw):
        if given:
            args = given.pop(0)
        out = fn(*args)
        calls.append((args, out))
        return 1.0, out

    monkeypatch.setattr(jprobe, "pl", Pl())
    monkeypatch.setattr(jprobe, "timeit", timeit)
    return jprobe, calls, given


@pytest.mark.parametrize("G", [8, 32, 64])
def test_probe_grid_plain_equals_pallas(interpreted, G):
    """P2: a product by 2 is exact in float32: bit-equal.  n is not a
    multiple of the tile, so the last tile is padded on both sides.  The
    probe's own input is all ones; a random one takes its place."""
    jprobe, calls, given = interpreted
    n = 3 * G * 128 - 77
    rng = np.random.default_rng(G)
    xr = rng.uniform(-3, 3, (8, 3 * G * 128)).astype(np.float32)
    given.append((jnp.asarray(xr),))
    jprobe.probe_grid(n, 0, G)
    (x,), out = calls[0]
    assert x.shape == xr.shape and len(calls) == 1
    got = tprobe.probe_grid_plain(torch.from_numpy(xr), G).numpy()
    np.testing.assert_array_equal(got, np.asarray(out))
    # the wrapper takes the plain version for a CPU tensor, and counts
    # no launch
    before = dict(_cuda.launch_counts)
    np.testing.assert_array_equal(
        tprobe.probe_grid(torch.from_numpy(xr), G).numpy(), got)
    assert dict(_cuda.launch_counts) == before


def test_probe_small_plain_equals_pallas(interpreted):
    """P3: a gather moves values: bit-equal to the Pallas kernel and to
    the XLA row gather beside it."""
    jprobe, calls, _ = interpreted
    n = 128 * 64 + 500            # two grid steps, the second padded
    jprobe.probe_small(n)
    (tab, idx), out = calls[0]
    (_, _), rows = calls[1]
    assert tab.shape == (8, 128) and idx.shape == (n,)
    ttab = torch.from_numpy(np.array(tab))
    tidx = torch.from_numpy(np.array(idx))
    assert tidx.dtype == torch.int32
    got = tprobe.probe_small_plain(ttab, tidx).numpy()
    assert got.shape == (8, n)
    np.testing.assert_array_equal(got, np.asarray(out)[:, :n])
    np.testing.assert_array_equal(got.T, np.asarray(rows))
    np.testing.assert_array_equal(tprobe.probe_small(ttab, tidx).numpy(), got)


def test_probe_lane_plain_equals_interp_rows(jprobe):
    """P1: the JAX probe's data, its reference ``_interp_rows`` on the
    rows ``packT.T[base]``.  float32, the same operations in the same
    order; XLA on the CPU may contract a product and a sum into one
    multiply-add, PyTorch does not: 2 ulp of the largest value (50:
    ulp 3.8e-6), atol 8e-6 (the lane tests of tests/test_torch_lane.py
    use 2e-6 on values of a few tens)."""
    n, ncell = 3000, 5000
    packT, base, w = jprobe.make_data(n, ncell)
    assert packT.shape == (64, 5120) and base.shape == (n,)
    rows = jnp.take(packT.T, base, axis=0)
    uvw, tt = _interp_rows(rows, w)
    tp, tb, tw = (torch.from_numpy(np.array(a)) for a in (packT, base, w))
    got = tprobe.probe_lane_plain(tp, tb, tw).numpy()
    assert got.shape == (8, n) and got.dtype == np.float32
    np.testing.assert_allclose(got[0:3], np.asarray(uvw), rtol=0, atol=8e-6)
    np.testing.assert_allclose(got[3], np.asarray(tt), rtol=0, atol=8e-6)
    np.testing.assert_array_equal(got[4], np.ones(n, np.float32))
    np.testing.assert_array_equal(got[5:8], np.zeros((3, n), np.float32))
    np.testing.assert_array_equal(tprobe.probe_lane(tp, tb, tw).numpy(), got)


def test_probe_lane_plain_is_the_row_major_kernel_plain():
    """On the port's own data: the column gather from ``[64, ncell]``
    gives what ``ops.lane_interp.interp_uvwt_plain`` gives from the
    row-major ``[ncell, 64]`` table, bit for bit."""
    from mptrac_tpu_torch.ops.lane_interp import interp_uvwt_plain
    packT, base, w = tprobe.make_data(4000, 7000, device="cpu")
    assert packT.shape == (64, 7040) and base.dtype == torch.int32
    assert int(base.min()) >= 0 and int(base.max()) <= 7000 - 2
    assert int((base[1:] < base[:-1]).sum()) > 0      # jittered, not sorted
    got = tprobe.probe_lane_plain(packT, base, w)
    exp = interp_uvwt_plain(packT.T[:7000].contiguous(), base, w)
    assert torch.equal(got[0:4], exp)


def test_probe_wrappers_check_shapes():
    with pytest.raises(ValueError, match=r"\[64, ncell\]"):
        tprobe.probe_lane(torch.zeros(8, 128), torch.zeros(4, dtype=torch.int32),
                          torch.zeros(4, 4))
    with pytest.raises(ValueError, match="1024"):
        tprobe.probe_grid(torch.zeros(8, 1000), 8)
    with pytest.raises(ValueError, match="table"):
        tprobe.probe_small(torch.zeros(8, 64), torch.zeros(4, dtype=torch.int32))


def test_probe_cli_on_the_cpu(capsys):
    """The entry point with ``--device cpu`` runs every probe on the plain
    versions and says that its times are no device times."""
    rc = tprobe.main(["--n", "3000", "--ncell", "2000", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + 1 + 3 + 3 + 1
    assert all("no device time" in line for line in out)
    lane = [line for line in out if line.startswith("lane")]
    assert len(lane) == 1 and "served=1.0000" in lane[0] \
        and "maxerr=0.00e+00" in lane[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tprobe.main(["small", "--n", "100"])
