"""Which version of the plain interpolation a call takes, on the CPU.

``locate_3d``, ``interp_time_3d`` and ``interp_time_2d`` launch a
kernel of ``csrc/plain_interp.cu`` only for float32 CUDA tensors (with a
float64 time); CPU tensors, float64 and mixed dtypes take the plain
versions.  The kernels' own launch wrappers are checked here with the
launch replaced: what reaches the C entry point, and what they refuse.
The kernels themselves run in ``tests/test_torch_cuda.py -m cuda``."""

import os
import re

import pytest
import torch

from helpers import interp_cases
from mptrac_tpu_torch.ops import _cuda, interp

SRC = os.path.join(os.path.dirname(_cuda.__file__), os.pardir, "csrc",
                   "plain_interp.cu")
KERNELS = {"interp_locate3d": "locate3d_kernel",
           "interp_time3d": "interp3d_time_kernel",
           "interp_time2d": "interp2d_time_kernel"}


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(interp_cases.bits(a),
                                              interp_cases.bits(b))


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail any load of the kernel library or launch of an interp
    kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA kernels")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "call", refuse)


@pytest.mark.parametrize("dtypes", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("kind", interp_cases.KINDS)
def test_cpu_calls_take_the_plain_versions(no_kernel, kind, dtypes):
    """CPU tensors in either precision, and float64 coordinates on a
    float32 met, run the plain versions' arithmetic bit for bit."""
    mdt = torch.float64 if dtypes == "float64" else torch.float32
    met = interp_cases.make_met(kind, "cpu", mdt)
    lon, lat, p, ts = interp_cases.make_parcels(
        met, 3000, dtype=torch.float64 if dtypes != "float32" else None)
    loc = interp.locate_3d(met, lon, lat, p)
    exp = interp.locate_3d_plain(met, lon, lat, p)
    for k in ("ix", "iy", "iz", "wx", "wy", "wz"):
        assert _same(getattr(loc, k), getattr(exp, k)), k
    assert loc.ix.dtype == torch.int32
    assert loc.wx.dtype == (torch.float32 if dtypes == "float32"
                            else torch.float64)
    for name in interp_cases.FIELDS3:
        assert _same(interp.interp_time_3d(met, name, ts, loc),
                     interp.interp_time_3d_plain(met, name, ts, loc)), name
    for name in interp_cases.FIELDS2:
        assert _same(interp.interp_time_2d(met, name, ts, loc),
                     interp.interp_time_2d_plain(met, name, ts, loc)), name


def _entry_params(name):
    """The parameter count of the C entry point ``name``."""
    with open(SRC) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    return len(m.group(1).split(","))


@pytest.fixture
def launches(monkeypatch):
    """The launches the wrappers make, as (name, device, args), none run."""
    calls = []
    monkeypatch.setattr(_cuda, "call",
                        lambda name, dev, *args, counters=None: calls.append(
                            (name, dev, args)))
    return calls


@pytest.fixture(scope="module")
def case():
    met = interp_cases.make_met("down-irr-lonlat", "cpu")
    lon, lat, p, ts = interp_cases.make_parcels(met, 500)
    return met, lon, lat, p, ts, interp.locate_3d_plain(met, lon, lat, p)


def _axes(met):
    return tuple(a[0] for a in (met.lon, met.lat, met.p))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_wrappers_pass_what_the_entry_takes(case, launches, name):
    """Each wrapper makes one launch with the C entry point's arguments
    (its stream added at the launch): the tensors' pointers, the grid's
    sizes and flags, the time weight's t1 and float64 reciprocal; an
    empty call launches nothing."""
    met, lon, lat, p, ts, loc = case
    n = lon.numel()
    if name == "interp_locate3d":
        got = interp._locate_3d_cuda(met, *_axes(met), lon, lat, p)
        args = launches[0][2]
        assert args[:6] == tuple(t.data_ptr() for t in (lon, lat, p)
                                 + _axes(met))
        assert args[6:12] == (interp_cases.NX, interp_cases.NY,
                              interp_cases.NZ, 0, 1, 0)
        assert args[12:] == tuple(getattr(got, k).data_ptr() for k in (
            "ix", "iy", "iz", "wx", "wy", "wz")) + (n,)
        assert got.ix.dtype == torch.int32 and got.wz.dtype == torch.float32
        interp._locate_3d_cuda(met, *_axes(met), lon[:0], lat[:0], p[:0])
    else:
        three = name == "interp_time3d"
        field = met.fields3d["t"] if three else met.fields2d["ps"]
        members = ("ix", "iy", "iz", "wx", "wy", "wz") if three else (
            "ix", "iy", "wx", "wy")
        out = interp._interp_time_cuda(name, met, field, ts, loc)
        args = launches[0][2]
        k = len(members)
        assert args[:k + 2] == (field.data_ptr(), *(
            getattr(loc, m).data_ptr() for m in members), ts.data_ptr())
        assert args[k + 2:] == (1, interp_cases.T1,
                                1.0 / (interp_cases.T1 - interp_cases.T0),
                                out.data_ptr(), n, *field.shape[1:])
        assert out.shape == lon.shape and out.dtype == torch.float32
        interp._interp_time_cuda(name, met, field, ts[:1], loc)
        assert launches[1][2][k + 2] == 0              # one time for all
        empty = interp.Locator(*(getattr(loc, m)[:0] for m in (
            "ix", "iy", "iz", "wx", "wy", "wz")))
        interp._interp_time_cuda(name, met, field, ts[:0], empty)
    assert [c[0] for c in launches] == [name] * (1 if name ==
                                                 "interp_locate3d" else 2)
    assert all(c[1] == lon.device for c in launches)
    assert len(launches[0][2]) + 1 == _entry_params(name)


def _refusals():
    """(wrapper call on the case, message) of arguments no kernel takes."""
    def loc_with(loc, **kw):
        d = {k: getattr(loc, k) for k in ("ix", "iy", "iz", "wx", "wy",
                                          "wz")}
        return interp.Locator(**{**d, **kw})

    def t3(met, ts, loc, field=None):
        return interp._interp_time_cuda(
            "interp_time3d", met, met.fields3d["t"] if field is None
            else field, ts, loc)

    def t2(met, ts, loc):
        return interp._interp_time_cuda("interp_time2d", met,
                                        met.fields2d["ps"], ts, loc)

    return {
        "strided axis": (lambda met, lon, lat, p, ts, loc:
                         interp._locate_3d_cuda(
                             met, torch.arange(2 * interp_cases.NX,
                                               dtype=torch.float32)[::2],
                             *_axes(met)[1:], lon, lat, p), "lons"),
        "one node": (lambda met, lon, lat, p, ts, loc:
                     interp._locate_3d_cuda(met, met.lon[0], met.lat[0],
                                            met.p[0, :1], lon, lat, p),
                     "two"),
        "float64 coordinate": (lambda met, lon, lat, p, ts, loc:
                               interp._locate_3d_cuda(
                                   met, *_axes(met), lon, lat.double(), p),
                               "lat"),
        "float64 field": (lambda met, lon, lat, p, ts, loc:
                          t3(met, ts, loc, met.fields3d["t"].double()),
                          "field"),
        "strided field": (lambda met, lon, lat, p, ts, loc:
                          t3(met, ts, loc,
                             met.fields3d["t"].transpose(1, 2).contiguous()
                             .transpose(1, 2)), "field"),
        "no pair": (lambda met, lon, lat, p, ts, loc:
                    t3(met, ts, loc, met.fields3d["t"][:1]), "pair"),
        "2-D field as 3-D": (lambda met, lon, lat, p, ts, loc:
                             t3(met, ts, loc, met.fields2d["ps"]), "pair"),
        "int64 index": (lambda met, lon, lat, p, ts, loc:
                        t3(met, ts, loc_with(loc, iy=loc.iy.long())), "iy"),
        "weight elsewhere": (lambda met, lon, lat, p, ts, loc:
                             t3(met, ts, loc_with(loc, wz=loc.wz.to(
                                 "meta"))), "wz"),
        "float32 time": (lambda met, lon, lat, p, ts, loc:
                         t2(met, ts.float(), loc), "ts"),
        "short time": (lambda met, lon, lat, p, ts, loc:
                       t3(met, ts[:-1], loc), "ts"),
    }


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, launches,
                                                             what):
    """A dtype, shape, layout or device the kernel does not read raises
    before any launch (on the card the public functions never fall back
    to the plain versions)."""
    call, match = _refusals()[what]
    with pytest.raises(ValueError, match=match):
        call(*case)
    assert launches == []


def test_interp_kernels_are_built_and_counted():
    """The source is built with the others, and each launch is counted
    under its entry point and stamped with its device function."""
    assert "plain_interp.cu" in _cuda.SOURCES
    with open(SRC) as f:
        src = f.read()
    for name, fn in KERNELS.items():
        assert _cuda.DEVICE_FUNCTIONS[name] == fn
        assert name in _cuda.launch_counts
        assert re.search(r"__global__ void __launch_bounds__\(BLOCK\) "
                         + fn + r"\(", src), fn
