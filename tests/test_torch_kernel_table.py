"""The table of the CUDA library's C entry points (``ops/_cuda.ENTRIES``),
held on the CPU against the sources and against the wrappers that
launch.

For every entry: its argument types, and the stream of a launch, are the
parameters of its ``extern "C"`` prototype, type for type; each device
function it names is a ``__global__`` of its source; each counter is a
launch count.  The sources are the kernel files of ``csrc/``.  For every
entry that launches, its wrapper's CUDA branch runs on CPU tensors with
``_cuda.call`` recorded: it makes the launches the table names, with
arguments that the entry's argument types take.  The kernels themselves
run in ``tests/test_torch_cuda.py -m cuda``."""

import contextlib
import ctypes
import dataclasses
import functools
import os
import re
from types import SimpleNamespace

import pytest
import torch

from helpers import interp_cases
from mptrac_tpu_torch.ops import (_cuda, interp, lane_interp, pallas_interp,
                                  rk_fused, rng, slab_interp)
from mptrac_tpu_torch.perf import probe
from mptrac_tpu_torch.physics import diffusion
from mptrac_tpu_torch.utils import timers

LAUNCHING = sorted(k for k, e in _cuda.ENTRIES.items() if e.kernels)
CPU = torch.device("cpu")

#: the ctypes of a C parameter's type
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "unsigned long long": ctypes.c_ulonglong,
           "float": ctypes.c_float, "double": ctypes.c_double}


@functools.lru_cache(maxsize=None)
def _source(name):
    with open(os.path.join(_cuda.CSRC, name)) as f:
        return f.read()


def _prototype(name):
    """The parameters of the entry point ``name``, as written."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                  _source(_cuda.ENTRIES[name].source))
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _ctype(param):
    """The ctypes that a C parameter ``param`` (type and name) takes."""
    stars = param.count("*")
    if stars:
        return (ctypes.c_void_p if stars == 1
                else ctypes.POINTER(ctypes.c_void_p))
    return C_TYPES[param.rsplit(" ", 1)[0]]


@pytest.mark.parametrize("name", sorted(_cuda.ENTRIES))
def test_entry_is_its_prototype(name):
    """The argument types (and a launch's stream) are the prototype's
    parameters; each device function is a ``__global__`` of the source;
    each counter is a launch count."""
    e = _cuda.ENTRIES[name]
    params = _prototype(name)
    stream = [ctypes.c_void_p] if e.kernels else []
    assert [_ctype(p) for p in params] == list(e.argtypes) + stream
    assert params[-1].endswith(" stream") == bool(e.kernels)
    for counter, fn in e.kernels.items():
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\) )?"
                         + fn + r"\(", _source(e.source)), fn
        assert counter in _cuda.launch_counts
        assert _cuda.DEVICE_FUNCTIONS[counter] == fn


def test_sources_are_the_kernel_files():
    """The library builds every ``.cu`` file of ``csrc/``, and each C
    entry point of them is in the table."""
    files = sorted(f for f in os.listdir(_cuda.CSRC) if f.endswith(".cu"))
    assert sorted(_cuda.SOURCES) == files
    declared = {m for f in files for m in re.findall(
        r'extern "C" int (\w+)\(', _source(f))}
    assert declared == set(_cuda.ENTRIES)


# ------------------------------------------------------------ the call

def test_call_counts_stamps_and_raises(monkeypatch):
    """``call`` counts and stamps each counter just before the launch
    (its entry's own by default), appends the device's current stream,
    raises on a refused launch; an entry that launches nothing takes its
    arguments alone and counts nothing."""
    got = []

    def entry(code):
        return lambda *args: got.append(args) or code

    lib = SimpleNamespace(permute_cols=entry(0), meso_sigma=entry(7),
                          rk_fused_attributes=entry(0))
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=99))
    before = dict(_cuda.launch_counts)
    prev = timers.tracing(True)
    try:
        timers.reset()
        _cuda.call("permute_cols", CPU, 1, 2,
                   counters=("permute_pack", "permute_rows"))
        stamps = [k for k, _ in timers.launch_stamps()]
        with pytest.raises(RuntimeError, match="meso_sigma was refused"):
            _cuda.call("meso_sigma", CPU, 3)
        _cuda.call("rk_fused_attributes", None, 4, 5)
    finally:
        timers.tracing(prev)
        timers.reset()
    assert got == [(1, 2, 99), (3, 99), (4, 5)]
    assert stamps == ["pack_kernel", "rows_kernel"]
    assert {k: v - before[k] for k, v in _cuda.launch_counts.items()
            if v != before[k]} == {"permute_pack": 1, "permute_rows": 1,
                                   "meso_sigma": 1}


# ---------------------------------------------- the wrappers' launches

N = 37                      # parcels
NX, NY, NPL = 5, 4, 3       # a grid


def _f32(*shape):
    return torch.rand(shape)


def _i32(n=N, high=NX * NY):
    return torch.randint(0, high, (n,), dtype=torch.int32)


def _w(k):
    return tuple(_f32(N) for _ in range(k))


def _pack():
    return rk_fused.CellPack(table=_f32(NPL, NX, NY, 8), lat_axis=_f32(NY),
                             p_axis=_f32(NPL), nx=NX, ny=NY, npl=NPL)


@functools.lru_cache(maxsize=1)
def _interp_case():
    met = interp_cases.make_met("down-irr-lonlat", "cpu")
    lon, lat, p, ts = interp_cases.make_parcels(met, 500)
    return met, lon, lat, p, ts, interp.locate_3d_plain(met, lon, lat, p)


def _axes(met):
    return tuple(a[0] for a in (met.lon, met.lat, met.p))


def _interp_time(name):
    met, lon, lat, p, ts, loc = _interp_case()
    field = (met.fields3d["t"] if name == "interp_time3d"
             else met.fields2d["ps"])
    interp._interp_time_cuda(name, met, field, ts, loc)


@functools.lru_cache(maxsize=1)
def _diff_turb_case():
    return interp_cases.diff_turb_case("down-reg-lonlat", 500, "cpu")


def _diff_turb(**kw):
    """The diffusion's kernel branch on its CPU case, the state's members
    ``kw`` replaced."""
    ctl, cache, clim, met, atm, sfcT = _diff_turb_case()
    return diffusion._diff_turb_cuda(ctl, cache, clim, met,
                                     atm.replace(**kw), sfcT)


def _permute():
    cols, perm = [_f32(N) for _ in range(3)], torch.randperm(N)
    col64 = torch.rand(N, dtype=torch.float64)
    slab_interp._permute_cuda(cols, perm, col64, "gather")
    slab_interp._permute_cuda(cols, perm, None, "rows")
    return [("permute_gather",), ("permute_pack", "permute_rows")]


#: entry point -> a run of its wrapper's CUDA branch on CPU tensors,
#: which returns the counters of each launch when they are not the
#: entry's own
DRIVERS = {
    "rk_fused_advect": lambda: rk_fused._rk_cuda(_pack(), 4, *_w(5)),
    "sfc_interp": lambda: slab_interp._sfc_cuda(
        _f32(NX, NY, 2, 16), _i32(), *_w(3), (0, 3, 15)),
    "permute_count": lambda: slab_interp._sectors_cuda(torch.randperm(N)),
    "permute_cols": _permute,
    "uvwt_interp": lambda: slab_interp._uvwt_cuda(
        _pack().table, _i32(high=NX * NY * NPL), *_w(4)),
    "meso_sigma_table": lambda: slab_interp._sigma_table_cuda(_pack().table),
    "meso_sigma": lambda: slab_interp._meso_cuda(
        _i32(high=NX * NY * NPL), _f32(NX * NY * NPL, 4)),
    "lane_interp_uvwt": lambda: lane_interp._uvwt_cuda(
        _f32(NX * NY, 64), _i32(), _f32(4, N)),
    "lane_meso_sigma": lambda: lane_interp._sigma_cuda(_f32(NX * NY, 64),
                                                       _i32()),
    "uvw_rows_interp": lambda: pallas_interp._uvw_cuda(
        _f32(NX * NY * NPL, 8), _i32(), _f32(N, 4), NY * NPL, NPL),
    "probe_lane": lambda: probe._lane_cuda(_f32(64, 128), _i32(high=128),
                                           _f32(4, N)),
    "probe_grid": lambda: probe._grid_cuda(_f32(8, 2 * 1024), 1024),
    "probe_small": lambda: probe._small_cuda(_f32(8, 128), _i32(high=73)),
    "squares_normal3": lambda: rng._normal3_f32_cuda(-5, N, CPU, 2, 3 * N),
    "squares_uniform": lambda: rng._uniform_f32_cuda(2 ** 64 + 5, N, CPU,
                                                     3),
    "squares_pairs": lambda: rng._normal_f32_cuda(5, N, CPU, 1),
    "interp_locate3d": lambda: interp._locate_3d_cuda(
        _interp_case()[0], *_axes(_interp_case()[0]), *_interp_case()[1:4]),
    "interp_time3d": lambda: _interp_time("interp_time3d"),
    "interp_time2d": lambda: _interp_time("interp_time2d"),
    "diff_turb": _diff_turb,
}


@pytest.fixture
def launches(monkeypatch):
    """The calls of the entry points, as (name, device, args, counters),
    none run."""
    calls = []
    monkeypatch.setattr(
        _cuda, "call", lambda name, dev, *args, counters=None: calls.append(
            (name, dev, args, counters)))
    return calls


@pytest.mark.parametrize("name", LAUNCHING)
def test_wrapper_makes_the_launches_the_table_names(launches, name):
    """The wrapper launches its entry on the tensors' device with as many
    arguments as the entry's types, each of which its type takes (as
    ctypes converts it at the call); the counters of the launches are
    the entry's, every one of them counted."""
    assert name in DRIVERS, f"{name}: no wrapper run in DRIVERS"
    e = _cuda.ENTRIES[name]
    counters = DRIVERS[name]()
    want = counters if isinstance(counters, list) else [None]
    assert [(c[0], c[3]) for c in launches] == [(name, c) for c in want]
    for _, dev, args, _ in launches:
        assert dev == CPU
        assert len(args) == len(e.argtypes)
        for t, a in zip(e.argtypes, args):
            t.from_param(a)
    counted = [k for c in want for k in (e.kernels if c is None else c)]
    assert sorted(set(counted)) == sorted(e.kernels)


def _refusals():
    """(wrapper call, label in the message) of arguments no kernel
    takes: a dtype, a shape, a layout or a device."""
    pack = _pack()
    return {
        "rk float64 lat": (lambda: rk_fused._rk_cuda(
            pack, 2, _f32(N), _f32(N).double(), *_w(3)), "lat"),
        "rk short axis": (lambda: rk_fused._rk_cuda(
            dataclasses.replace(pack, p_axis=_f32(NPL - 1)), 2, *_w(5)),
                          "p_axis"),
        "sfc int64 basexy": (lambda: slab_interp._sfc_cuda(
            _f32(NX, NY, 2, 16), _i32().long(), *_w(3), (0,)), "basexy"),
        "count int32 perm": (lambda: slab_interp._sectors_cuda(
            torch.randperm(N).int()), "perm"),
        "permute strided column": (lambda: slab_interp._permute_cuda(
            [_f32(2 * N)[::2]], torch.randperm(N), None, "gather"),
                                   "column 0"),
        "permute float32 col64": (lambda: slab_interp._permute_cuda(
            [_f32(N)], torch.randperm(N), _f32(N), "gather"), "col64"),
        "uvwt int64 cell": (lambda: slab_interp._uvwt_cuda(
            pack.table, _i32().long(), *_w(4)), "cell"),
        "sigma float64 table": (lambda: slab_interp._sigma_table_cuda(
            pack.table.double()), "table"),
        "meso cell elsewhere": (lambda: slab_interp._meso_cuda(
            _i32().to("meta"), _f32(NX * NY, 4)), "cell"),
        "lane weights transposed": (lambda: lane_interp._uvwt_cuda(
            _f32(NX * NY, 64), _i32(), _f32(N, 4).T), "weights"),
        "rows weights [4, n]": (lambda: pallas_interp._uvw_cuda(
            _f32(NX * NY, 8), _i32(), _f32(4, N), NY, 1), "weights"),
        "probe int64 idx": (lambda: probe._small_cuda(
            _f32(8, 128), _i32(high=73).long()), "idx"),
        "diff_turb float32 time": (lambda: _diff_turb(
            time=_diff_turb_case()[4].time.float()), "time"),
        "diff_turb strided lat": (lambda: _diff_turb(
            lat=_diff_turb_case()[4].lat.repeat(2)[::2]), "lat"),
    }


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_wrappers_refuse_what_the_kernels_do_not_take(launches, what):
    """The one argument check refuses, naming the entry and the
    argument, before any launch."""
    call, label = _refusals()[what]
    with pytest.raises(ValueError, match=r"\w+: " + re.escape(label)
                       + " must be"):
        call()
    assert launches == []
