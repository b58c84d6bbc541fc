"""Which version of the turbulent diffusion a call takes, on the CPU.

``module_diff_turb`` launches its kernel (``csrc/diff_turb.cu``) only for
a float32 state on the card with the Squares generator and a surface
table (``kernel_takes``); CPU tensors, float64, threefry and the exact
path without a table take ``module_diff_turb_plain``.  The kernel's
launch wrapper is checked here with the launch replaced: what reaches
the C entry point, and what it refuses.  The kernel itself runs in
``tests/test_torch_cuda.py -m cuda``."""

import os
import re
from types import SimpleNamespace

import pytest
import torch

from helpers import interp_cases
from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.physics import diffusion

SRC = os.path.join(os.path.dirname(_cuda.__file__), os.pardir, "csrc",
                   "diff_turb.cu")
N = 700


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(interp_cases.bits(a),
                                              interp_cases.bits(b))


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail any load of the kernel library or launch of a kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA kernels")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "call", refuse)


@pytest.mark.parametrize("what", ["float32", "float64", "threefry",
                                  "no table"])
def test_cpu_calls_take_the_plain_body(no_kernel, what):
    """CPU calls in either precision, with either generator, with or
    without a surface table, are the plain body's bit for bit."""
    dtype = torch.float64 if what == "float64" else torch.float32
    ctl, cache, clim, met, atm, sfcT = interp_cases.diff_turb_case(
        "down-irr-lonlat", N, "cpu", dtype=dtype)
    if what == "threefry":
        ctl = ctl.replace(rng_type=2)
    if what == "no table":
        sfcT = None
    got, gc = diffusion.module_diff_turb(ctl, cache, clim, met, atm, sfcT)
    exp, ec = diffusion.module_diff_turb_plain(ctl, cache, clim, met, atm,
                                               sfcT)
    assert gc.rng_ctr == ec.rng_ctr
    for k in ("lon", "lat", "p"):
        assert _same(getattr(got, k), getattr(exp, k)), k
    assert bool((got.lon != atm.lon).any())


@pytest.mark.parametrize("is_cuda,dtype,rng_type,table,takes", [
    (True, torch.float32, 1, True, True),
    (True, torch.float32, 0, True, True),
    (False, torch.float32, 1, True, False),
    (True, torch.float64, 1, True, False),
    (True, torch.float32, 2, True, False),
    (True, torch.float32, 1, False, False)])
def test_kernel_takes_device_dtype_generator_and_table(is_cuda, dtype,
                                                       rng_type, table,
                                                       takes):
    """The kernel is chosen by the state's device and dtype, the
    generator and the surface table's presence, and by nothing else."""
    atm = SimpleNamespace(lon=SimpleNamespace(is_cuda=is_cuda, dtype=dtype))
    ctl = SimpleNamespace(rng_type=rng_type)
    assert diffusion.kernel_takes(ctl, atm, object() if table else None) \
        is takes


def _entry_params():
    with open(SRC) as f:
        src = f.read()
    m = re.search(r'extern "C" int diff_turb\(([^)]*)\)', src)
    assert m
    return len(m.group(1).split(","))


@pytest.fixture
def launches(monkeypatch):
    """The launches made, as (name, device, args, counters), none run;
    a launch that takes the kernel's path on CPU tensors."""
    calls = []
    monkeypatch.setattr(_cuda, "call",
                        lambda name, dev, *args, counters=None: calls.append(
                            (name, dev, args, counters)))
    monkeypatch.setattr(_cuda, "load", lambda: pytest.fail("loaded"))
    monkeypatch.setattr(diffusion, "kernel_takes", lambda *a: True)
    return calls


@pytest.mark.parametrize("case,part", [("base", None),
                                       ("utm", (40, 3 * N)),
                                       ("pbl_scheme", None)])
def test_call_makes_one_launch_with_what_the_entry_takes(launches, case,
                                                         part):
    """One launch of ``diff_turb`` under its own counter and nothing
    else (no draw, no locate, no surface lookup): the state's and the
    tables' pointers, the grid's sizes and flags, the time weight, the
    climatology's sizes, the control parameters, the draw's counter and
    columns; new lon, lat and p; the counter advanced by the draw."""
    ctl, cache, clim, met, atm, sfcT = interp_cases.diff_turb_case(
        "up-irr-cartesian", N, "cpu", case, part=part)
    got, gc = diffusion.module_diff_turb(ctl, cache, clim, met, atm, sfcT)
    assert [(c[0], c[3]) for c in launches] == [("diff_turb", None)]
    _, dev, args, _ = launches[0]
    assert dev == atm.lon.device and len(args) + 1 == _entry_params()
    first, total = (0, N) if part is None else part
    nx, ny, npl = (interp_cases.NX, interp_cases.NY, interp_cases.NZ)
    assert args[:7] == (atm.lon.data_ptr(), atm.lat.data_ptr(),
                        atm.p.data_ptr(), atm.time.data_ptr(),
                        cache.dt.data_ptr(), N, N - N // 10)
    assert args[10:16] == (nx, ny, npl, 1, 0, 0)
    assert args[16:21] == (sfcT.data_ptr(), 1, 0, interp_cases.T1,
                           1.0 / (interp_cases.T1 - interp_cases.T0))
    assert args[21:27] == (clim.tropo_time.data_ptr(),
                           clim.tropo_lat.data_ptr(),
                           clim.tropo.data_ptr(), 12, 73,
                           int(case == "utm"))
    assert args[27:36] == (ctl.met_utm_ref_lat,
                           int(case == "pbl_scheme"), 0.3, 50.0, 50.0,
                           5.0, 20.0, 2.0, 0.1)
    assert args[36:39] == ((1 << 64) - 7, first, total)
    assert args[39:] == tuple(getattr(got, k).data_ptr()
                              for k in ("lon", "lat", "p"))
    assert gc.rng_ctr == (cache.rng_ctr + 3 * total + 1) % (1 << 64)
    for t, a in zip(_cuda.ENTRIES["diff_turb"].argtypes, args):
        t.from_param(a)


def _refusals():
    """(state change, message) of arguments the kernel does not take."""
    def tables(clim, dtype):
        return clim.replace(**{k: getattr(clim, k).to(dtype) for k in (
            "tropo_time", "tropo_lat", "tropo")})

    def wide(met):
        """``met`` on a longitude axis of the kernel's whole limit."""
        lon = torch.linspace(-180.0, 180.0, diffusion.SMEM_AXIS_FLOATS,
                             dtype=met.lon.dtype)
        return met.replace(lon=lon.expand(*met.lon.shape[:-1], -1))

    return {
        "float64 lat": (lambda s: s.update(atm=s["atm"].replace(
            lat=s["atm"].lat.double())), "lat must be"),
        "strided lon": (lambda s: s.update(atm=s["atm"].replace(
            lon=s["atm"].lon.repeat(2)[::2])), "lon must be"),
        "float64 dt": (lambda s: s.update(cache=s["cache"].replace(
            dt=s["cache"].dt.double())), "dt must be"),
        "short table": (lambda s: s.update(sfcT=s["sfcT"][:-1]),
                        "sfcT must be"),
        "float64 climatology": (lambda s: s.update(clim=tables(
            s["clim"], torch.float64)), "tropo_time must be"),
        "axes past shared memory": (lambda s: s.update(met=wide(s["met"])),
                                    "12288 at most"),
        "part past its draw": (lambda s: s.update(cache=s["cache"].replace(
            rng_part=(5, N))), "parcels"),
    }


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_call_refuses_what_the_kernel_does_not_take(launches, what):
    """A dtype, shape, layout or draw the kernel does not take raises
    before any launch: on the card nothing falls back."""
    ctl, cache, clim, met, atm, sfcT = interp_cases.diff_turb_case(
        "down-reg-lonlat", N, "cpu")
    s = dict(cache=cache, clim=clim, met=met, atm=atm, sfcT=sfcT)
    change, match = _refusals()[what]
    change(s)
    with pytest.raises(ValueError, match=match):
        diffusion.module_diff_turb(ctl, s["cache"], s["clim"], s["met"],
                                   s["atm"], s["sfcT"])
    assert launches == []


def test_kernel_is_built_and_counted():
    """The source is built with the others, and each launch is counted
    under ``diff_turb`` and stamped with its device function."""
    assert "diff_turb.cu" in _cuda.SOURCES
    assert _cuda.DEVICE_FUNCTIONS["diff_turb"] == "diff_turb_kernel"
    assert "diff_turb" in _cuda.launch_counts
    with open(SRC) as f:
        assert re.search(r"__global__ void __launch_bounds__\(BLOCK\) "
                         r"diff_turb_kernel\(", f.read())


def test_axis_limit_is_the_kernels():
    """The wrapper refuses axes past the number of nodes that the
    kernel stages in shared memory, which the shared header declares."""
    hdr = os.path.join(os.path.dirname(SRC), "interp_common.cuh")
    with open(hdr) as f:
        m = re.search(r"constexpr int SMEM_AXIS_FLOATS = (\d+);", f.read())
    assert m and int(m.group(1)) == diffusion.SMEM_AXIS_FLOATS
