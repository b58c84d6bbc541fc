"""The binary met containers of the port against the JAX package:
``met/bin_io`` (MET_TYPE 1, 2 with and without MET_PCK_ZSTD, 4, 8 and
the lossy 3, 5, 7 of ``met/lossy``, with and without MET_LOSSY_SCALE),
``met/lz4``, the decode-ahead of ``native_loader`` and ``sim.MetBuffer``,
and ``run_trac`` from binary met files against the JAX ``run_trac`` and
against the port's own netCDF run of the same case."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mptrac_tpu as mt
import mptrac_tpu_torch as mtt
from mptrac_tpu.met import bin_io as jbin
from mptrac_tpu.met import lz4 as jlz4
from mptrac_tpu.sim import run_trac as jrun_trac
from mptrac_tpu.types import Met as JMet
from mptrac_tpu_torch import flagship, native_loader
from mptrac_tpu_torch.met import bin_io as tbin
from mptrac_tpu_torch.met import lz4 as tlz4
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.met.synthetic import make_wind_met
from mptrac_tpu_torch.sim import MetBuffer, run_trac

os.environ.setdefault("LOGLEV", "0")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, NZ = 36, 19, 8

#: (MET_TYPE, MET_PCK_ZSTD) of every container
CONTAINERS = [(1, 0), (2, 0), (2, 1), (3, 0), (4, 0), (5, 0), (7, 0), (8, 0)]


def _args(met_type, zstd=0, scale=0):
    args = ["MET_TYPE", str(met_type), "METBASE", "-", "MET_PCK_ZSTD",
            str(zstd)]
    for i in range(13):
        args += [f"MET_LOSSY_SCALE[{i}]", str(scale)]
    return args


def _ctls(*a):
    return mt.read_ctl(None, _args(*a)), mtt.read_ctl(None, _args(*a))


@pytest.fixture(scope="module")
def mets():
    """One snapshot in both packages: the solid-body wind with seeded
    noise on every field (NaN-free), float32."""
    met = make_wind_met(t0=3600.0, nx=NX, ny=NY, nz=NZ, alpha=30.0, q=1e-5,
                        o3=1e-6, device="cpu")
    rng = np.random.default_rng(1)

    def noisy(v):
        return torch.from_numpy((np.nan_to_num(v.numpy())
                                 + rng.normal(0, 1, v.shape)).astype(
                                     np.float32))
    met = met.replace(fields2d={k: noisy(v) for k, v in met.fields2d.items()},
                      fields3d={k: noisy(v) for k, v in met.fields3d.items()})
    jmet = JMet(time=jnp.asarray(met.time), lon=jnp.asarray(met.lon.numpy()),
                lat=jnp.asarray(met.lat.numpy()),
                p=jnp.asarray(met.p.numpy()),
                hybrid=jnp.asarray(met.hybrid.numpy()),
                fields2d={k: jnp.asarray(v.numpy())
                          for k, v in met.fields2d.items()},
                fields3d={k: jnp.asarray(v.numpy())
                          for k, v in met.fields3d.items()})
    return met, jmet


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _assert_raw_equal(traw, jraw):
    """Every field bit for bit, the axes and the time equal."""
    assert traw["time"] == jraw["time"]
    for k in ("lon", "lat", "p", "hybrid"):
        np.testing.assert_array_equal(traw[k], jraw[k], k)
    for kind in ("fields2d", "fields3d"):
        assert sorted(traw[kind]) == sorted(jraw[kind])
        for k, v in traw[kind].items():
            x, y = v.cpu().numpy(), np.asarray(jraw[kind][k])
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, k
            np.testing.assert_array_equal(_bits(x), _bits(y), k)


@pytest.mark.parametrize("scale", [0, 1], ids=["unscaled", "lossy_scale"])
@pytest.mark.parametrize("met_type,zstd", CONTAINERS,
                         ids=[f"type{t}" + ("_zstd" if z else "")
                              for t, z in CONTAINERS])
def test_container_equals_jax(tmp_path, mets, met_type, zstd, scale):
    """The port's ``write_met_bin`` writes the JAX writer's file: byte for
    byte where the container holds no ZSTD frame (1, 2, 8); with ZSTD
    frames (whose compressed bytes depend on the zstd release: the port
    binds the system's libzstd, the JAX package its module's own) the JAX
    reader reads it to the fields of the JAX writer's file, bit for bit.
    The port's ``read_met_bin`` (torch on the CPU) reads the JAX file to
    the JAX reader's fields, bit for bit."""
    met, jmet = mets
    jctl, tctl = _ctls(met_type, zstd, scale)
    fj, ft = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jbin.write_met_bin(fj, jmet, met_type, pck_zstd=bool(zstd), ctl=jctl)
    stats = []
    tbin.write_met_bin(ft, met, met_type, pck_zstd=bool(zstd), ctl=tctl,
                       stats=stats)
    if met_type in (1, 8) or (met_type == 2 and not zstd):
        with open(fj, "rb") as a, open(ft, "rb") as b:
            assert a.read() == b.read()
    else:
        jraw = jbin.read_met_bin(fj, jctl)
        _assert_raw_equal(tbin.read_met_bin(fj, tctl, device="cpu"), jraw)
        again = jbin.read_met_bin(ft, jctl)
        for kind in ("fields2d", "fields3d"):
            for k, v in again[kind].items():
                np.testing.assert_array_equal(_bits(np.asarray(v)),
                                              _bits(np.asarray(jraw[kind][k])))
    assert len(stats) == (13 if met_type != 1 else 0)
    timings = {}
    traw = tbin.read_met_bin(fj, tctl, device="cpu", timings=timings)
    _assert_raw_equal(traw, jbin.read_met_bin(fj, jctl))
    assert set(timings) <= set(tbin.STAGES) and timings["read"] > 0


def test_codec_error_within_guarantee(tmp_path, mets):
    """What each lossy container gives back against the stored fields:
    PCK within half its step a level, SQZ within its step / 2; ZFP within
    27 half-steps of its coefficients (each inverse Haar axis adds three
    coefficient errors; a step is 2**-prec of the block's power of two,
    at most twice the largest magnitude); CMS within (1 + 3 levels) half
    steps (each pyramid level adds three detail errors to its
    approximation's); each plus the float32 rounding of the decoded value
    (one ulp of the level's largest magnitude)."""
    met, _ = mets
    for met_type, bound in ((2, "pck"), (7, "sqz"), (3, "zfp"), (5, "cms")):
        _, tctl = _ctls(met_type)
        fn = str(tmp_path / f"m{met_type}.bin")
        tbin.write_met_bin(fn, met, met_type, ctl=tctl)
        raw = tbin.read_met_bin(fn, tctl, device="cpu")
        for name, lo, hi in tbin.BIN_3D:
            ref = met.fields3d[name].double().clamp(lo, hi).reshape(-1, NZ)
            got = raw["fields3d"][name].double().reshape(-1, NZ)
            err = (got - ref).abs().max(dim=0).values
            rng = ref.max(dim=0).values - ref.min(dim=0).values
            absmax = ref.abs().max(dim=0).values
            mv = [n for n, _, _ in tbin.BIN_3D].index(name)
            if bound == "pck":
                limit = rng / 65533.0 / 2
            elif bound == "sqz":
                limit = rng * 0.5 ** tctl.met_sz3_prec[mv] / 2
            elif bound == "zfp":
                limit = 27 * absmax.max() * 2.0 ** -tctl.met_zfp_prec[mv]
            else:
                limit = ((1 + 3 * tctl.met_cms_maxlev)
                         * tctl.met_cms_eps[mv] * rng / 2)
            limit = limit + absmax * 2.0 ** -23
            assert bool((err <= limit).all()), (met_type, name)


def test_reader_refuses_a_wrong_container(tmp_path, mets):
    met, _ = mets
    _, tctl1 = _ctls(1)
    _, tctl2 = _ctls(2)
    fn = str(tmp_path / "m.bin")
    tbin.write_met_bin(fn, met, 1)
    with pytest.raises(ValueError, match="Wrong MET_TYPE"):
        tbin.read_met_bin(fn, tctl2, device="cpu")
    with open(fn, "r+b") as f:
        f.seek(-4, 2)
        f.write(struct.pack("<i", 998))
    with pytest.raises(ValueError, match="Error while reading"):
        tbin.read_met_bin(fn, tctl1, device="cpu")


# ----------------------------------------------------------- ZSTD, LZ4

def test_zstd_frames_against_the_zstandard_module():
    """The port's ZSTD (the system's libzstd) and the JAX package's
    ``zstandard`` module decode each other's frames to the same bytes;
    with the same zstd release they also write the same bytes."""
    import zstandard

    from mptrac_tpu_torch.met import zstd
    rng = np.random.default_rng(4)
    same_release = zstd.version() == ".".join(map(str, zstandard.ZSTD_VERSION))
    for data in (b"", rng.bytes(3000),
                 np.repeat(rng.normal(size=5000), 5).astype("<f4").tobytes()):
        for level in (-3, 3):
            ours = zstd.compress(data, level)
            theirs = zstandard.ZstdCompressor(level=level).compress(data)
            assert zstandard.ZstdDecompressor().decompress(ours) == data
            assert zstd.decompress(theirs, len(data)).tobytes() == data
            if same_release:
                assert ours == theirs
    with pytest.raises(IOError, match="ZSTD"):
        zstd.decompress(b"not a frame", 100)
    with pytest.raises(IOError, match="exceeds"):
        zstd.decompress(zstd.compress(bytes(1000)), 999)


def test_lz4_native_against_plain_and_jax():
    """The native codec of the port's host library against the plain
    Python codec (both directions) and against the JAX module's bytes."""
    rng = np.random.default_rng(3)
    smooth = np.repeat(rng.normal(size=2000).astype(np.float32), 7)
    for data in (b"", b"abc", rng.bytes(5000), smooth.tobytes(),
                 bytes(70000)):
        comp = tlz4.compress(data)
        assert comp == jlz4.compress(data)
        assert tlz4._decompress_py(comp, len(data)) == data
        assert tlz4.decompress(comp, len(data)).tobytes() == data
        assert tlz4.decompress(tlz4._compress_py(data),
                               len(data)).tobytes() == data
    assert len(tlz4.compress(smooth.tobytes())) < smooth.nbytes // 2
    with pytest.raises(IOError):
        tlz4.decompress(tlz4.compress(smooth.tobytes()), smooth.nbytes + 4)


# --------------------------------------------------------- decode-ahead

def _write_raw_type1(path, met, out_of_bounds):
    """A MET_TYPE 1 file written by hand (the writers clamp; this one
    does not): ``out_of_bounds`` puts values beyond ``BIN_3D``'s bounds
    into the stored 3-D fields."""
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 1, 104))
        f.write(struct.pack("<d", float(met.time)))
        f.write(struct.pack("<iii", met.nx, met.ny, met.npl))
        for ax in (met.lon, met.lat, met.p):
            ax.numpy().astype("<f8").tofile(f)
        for name in tbin.BIN_2D:
            met.fields2d[name].numpy().astype("<f4").tofile(f)
        for name, lo, hi in tbin.BIN_3D:
            a = met.fields3d[name].numpy().astype("<f4").reshape(-1)
            if out_of_bounds:
                a = a.copy()
                a[::5] = lo - 7.5 if lo == 0 else -3e34
                a[1::5] = hi + 2.0 if hi == 1 else 4e34
            a.tofile(f)
        f.write(struct.pack("<i", 999))


@pytest.mark.parametrize("kind", ["type1", "type2", "type1_beyond_bounds"])
def test_decode_ahead_equals_python_reader(tmp_path, mets, kind):
    """The native loader's fields, clamped on the device, equal the
    Python reader's bit for bit, every field, for MET_TYPE 1 and 2 and
    for a file whose stored values lie beyond ``BIN_3D``'s bounds."""
    met, _ = mets
    met_type = 2 if kind == "type2" else 1
    _, tctl = _ctls(met_type)
    fn = str(tmp_path / "m.bin")
    if kind == "type1_beyond_bounds":
        _write_raw_type1(fn, met, out_of_bounds=True)
    else:
        tbin.write_met_bin(fn, met, met_type)
    loader = native_loader.AsyncMetLoader()
    try:
        loader.prefetch(fn, met_type)
        timings = {}
        native = tbin.finish_raw(loader.wait(timings), "cpu",
                                 tbin.read_stages(timings, "cpu"))
    finally:
        loader.close()
    assert {"wait", "copy", "upload", "decode_device"} <= set(timings)
    python = tbin.read_met_bin(fn, tctl, device="cpu")
    _assert_raw_equal(native, dict(python, fields2d={
        k: v.numpy() for k, v in python["fields2d"].items()},
        fields3d={k: v.numpy() for k, v in python["fields3d"].items()}))
    if kind == "type1_beyond_bounds":
        assert float(native["fields3d"]["cc"].max()) == 1.0
        assert float(native["fields3d"]["t"].min()) == 0.0


def test_jax_loader_does_not_clamp(tmp_path, mets):
    """Reference-side finding: the JAX package's native loader returns
    the stored values of a file beyond ``BIN_3D``'s bounds, where its
    Python reader clamps them; the port clamps after either route."""
    if not os.path.exists(os.path.join(ROOT, "native", "libmetloader.so")):
        pytest.skip("the JAX package's native loader is not built")
    from mptrac_tpu.native_loader import AsyncMetLoader as JLoader
    met, _ = mets
    jctl, _ = _ctls(1)
    fn = str(tmp_path / "m.bin")
    _write_raw_type1(fn, met, out_of_bounds=True)
    loader = JLoader()
    loader.prefetch(fn, 1)
    jnative = loader.wait()
    loader.close()
    jpython = jbin.read_met_bin(fn, jctl)
    assert float(np.max(jnative["fields3d"]["cc"])) > 1.0
    assert float(np.max(jpython["fields3d"]["cc"])) == 1.0
    assert float(np.min(jnative["fields3d"]["t"])) < 0.0


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A failed build raises naming the compiler and its output, for the
    codec and for the met buffer; nothing falls back."""
    monkeypatch.setattr(native_loader, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native_loader, "CXX_FLAGS",
                        native_loader.CXX_FLAGS + ("-fno-such-option",))
    native_loader.get_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
            tlz4.compress(b"x" * 100)
        assert "no-such-option" in str(err.value)
        _, tctl = _ctls(1)
        with pytest.raises(RuntimeError, match="no-such-option"):
            MetBuffer(tctl, None, device="cpu")
        assert not os.listdir(os.path.join(
            tmp_path, os.listdir(tmp_path)[0]))
    finally:
        native_loader.get_library.cache_clear()


# ------------------------------------------------- run_trac from files

@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The flagship case (``flagship.write_case``, 36x19x8, 512 parcels,
    7 steps across the met swap at 3600 s) as netCDF files, and
    converted into MET_TYPE 1 and 2 containers."""
    out = {}
    for kind, met_type in (("nc", 0), ("bin", 1), ("pck", 2)):
        d = str(tmp_path_factory.mktemp(kind))
        flagship.write_case(d, 512, (NX, NY, NZ), 3600.0 - 540.0,
                            3600.0 + 540.0, 900, extra_ctl=("TPU_FAST", "2"))
        if met_type:
            flagship.convert_case(d, met_type)
        out[kind] = d
    return out


def _states_equal(a, b):
    for k in ("time", "lon", "lat", "p"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert sorted(a.q) == sorted(b.q)
    for k in a.q:
        assert torch.equal(a.q[k], b.q[k]), k


@pytest.mark.parametrize("dtype,fast", [("float64", "0"), ("float64", "2"),
                                        ("float32", "0"), ("float32", "2")])
def test_binary_run_equals_netcdf_run(cases, dtype, fast):
    """``run_trac`` from the MET_TYPE 1 files equals the run from the
    netCDF files they were converted from, bit for bit (the container
    stores the preprocessed float32 fields), on the exact and on the
    fused path; the first file goes through the Python reader, the later
    ones through the decode-ahead, as in the JAX buffer."""
    args = ("TPU_FAST", fast, "ATM_BASENAME", "-")
    dt = getattr(torch, dtype)
    a = run_trac(cases["nc"], "trac.ctl", "atm_in.bin", args, device="cpu",
                 dtype=dt)
    b = run_trac(cases["bin"], "trac.ctl", "atm_in.bin", args, device="cpu",
                 dtype=dt)
    _states_equal(a.atm, b.atm)
    assert [r["route"] for r in b.met.reads] == ["python", "native",
                                                 "native"]
    assert [r["route"] for r in a.met.reads] == ["python"] * 3
    assert a.met.pair.time == b.met.pair.time == (3600.0, 7200.0)


#: position tolerance [deg] of a float64 run against the JAX run, with
#: the mesoscale diffusion on (tests/test_torch_trac.py ``ATOL_DEG``)
ATOL_DEG = 5e-5


@pytest.mark.parametrize("kind,fast", [("bin", "0"), ("pck", "2")])
def test_binary_run_agrees_with_jax(cases, kind, fast):
    """``run_trac`` of both packages (float64) on the same MET_TYPE 1
    and 2 files, at the tolerances of tests/test_torch_trac.py; the JAX
    buffer takes the same files through its own decode-ahead."""
    args = ("TPU_FAST", fast, "ATM_BASENAME", "-")
    ja = jrun_trac(cases[kind], "trac.ctl", "atm_in.bin", list(args)).atm
    ta = run_trac(cases[kind], "trac.ctl", "atm_in.bin", args,
                  device="cpu").atm
    np.testing.assert_array_equal(ta.time.numpy(), np.asarray(ja.time))
    for name in ("lon", "lat"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), rtol=0,
                                   atol=ATOL_DEG, err_msg=name)
    np.testing.assert_allclose(ta.p.numpy(), np.asarray(ja.p), rtol=1e-6,
                               atol=0)
    for q in ta.q:
        np.testing.assert_allclose(ta.q[q].numpy(), np.asarray(ja.q[q]),
                                   rtol=1e-5, atol=1e-12, err_msg=q)


def test_jax_buffer_takes_the_second_file_from_its_loader(cases,
                                                          monkeypatch):
    """The JAX buffer reads the first file through Python, then queues the
    next: the second and third files come from its loader (the second
    with no integration to overlap).  The port's routes above follow it."""
    if not os.path.exists(os.path.join(ROOT, "native", "libmetloader.so")):
        pytest.skip("the JAX package's native loader is not built")
    from mptrac_tpu import native_loader as jnl
    from mptrac_tpu.config import read_ctl as jread_ctl
    from mptrac_tpu.sim import MetBuffer as JMetBuffer
    waits = []
    wait = jnl.AsyncMetLoader.wait
    monkeypatch.setattr(jnl.AsyncMetLoader, "wait",
                        lambda self: waits.append(1) or wait(self))
    ctl = jread_ctl(os.path.join(cases["bin"], "trac.ctl"))
    buf = JMetBuffer(ctl, None)
    buf.get(3600.0 - 540.0)
    assert len(waits) == 1
    buf.get(3600.0 + 180.0)
    assert len(waits) == 2


def test_met_buffer_records_routes_and_reads(cases):
    """``MetBuffer.reads`` names each file's route and its stages (PCK
    through the decode-ahead too); with ``MET_PCK_ZSTD`` the buffer has
    no decode-ahead, as the JAX one; a container's ``Met`` keeps
    ``lon_periodic`` False, as the JAX ``_to_met`` leaves it."""
    ctl = mtt.read_ctl(os.path.join(cases["pck"], "trac.ctl"))
    buf = MetBuffer(ctl, None, device="cpu")
    buf.get(3600.0 - 540.0)
    buf.get(3600.0 + 180.0)
    buf.close()
    assert [r["route"] for r in buf.reads] == ["python", "native", "native"]
    for r in buf.reads:
        assert r["wait"] >= 0.0 and r["upload"] > 0.0
    met = read_met(os.path.join(cases["pck"], "met_2000_01_01_01.pck"), ctl,
                   device="cpu")
    assert met.lon_periodic is False and met.reg_lon
    zctl = mtt.read_ctl(os.path.join(cases["pck"], "trac.ctl"),
                        ["MET_PCK_ZSTD", "1"])
    assert MetBuffer(zctl, None, device="cpu")._loader is None


@pytest.mark.parametrize("met_type,zstd,atm_type", [
    (1, 0, 3), (2, 0, 4), (2, 1, 1), (3, 0, 1), (4, 0, 3), (5, 0, 1),
    (7, 0, 4), (8, 0, 1)],
    ids=["type1_clams3", "type2_clams4", "type2_zstd", "type3", "type4_clams3",
         "type5", "type7_clams4", "type8"])
def test_tool_runs_every_container(tmp_path, met_type, zstd, atm_type):
    """``tools.trac --device cpu`` from each container (converted from the
    flagship case's netCDF files), some with CLaMS particle output
    (ATM_TYPE_OUT 3 or 4) read back as the next run's input.  The lossless
    containers give the netCDF run's parcels; the lossy ones stay near
    them."""
    from mptrac_tpu_torch.io import atm_io
    from mptrac_tpu_torch.tools import trac
    d = str(tmp_path)
    dirlist = flagship.write_case(d, 256, (NX, NY, NZ), 3600.0 - 360.0,
                                  3600.0 + 360.0, 900,
                                  extra_ctl=("TPU_FAST", "2"))
    ref = run_trac(d, "trac.ctl", "atm_in.bin", ("ATM_BASENAME", "-"),
                   device="cpu", dtype=torch.float32).atm
    flagship.convert_case(d, met_type, ("MET_PCK_ZSTD", str(zstd)))
    out = ("ATM_TYPE_OUT", str(atm_type), "ATM_BASENAME", "out")
    assert trac.main(["trac", dirlist, "trac.ctl", "atm_in.bin", *out,
                      "--device", "cpu", "--dtype", "float32"]) == 0
    ctl = mtt.read_ctl(os.path.join(d, "trac.ctl"),
                       ["ATM_TYPE", str(atm_type)])
    name = [f for f in os.listdir(d) if f.startswith("out_")]
    assert len(name) == 1
    back = atm_io.read_atm(os.path.join(d, name[0]), ctl, device="cpu")
    tol = 0.0 if met_type in (1, 4, 8) else 0.05
    for k in ("lon", "lat"):
        err = float((getattr(back, k) - getattr(ref, k).double()).abs().max())
        assert err <= tol, (k, err)
    if atm_type in (3, 4):
        # the CLaMS file as the next run's input
        again = trac.main(["trac", dirlist, "trac.ctl", name[0], "ATM_TYPE",
                           str(atm_type), "ATM_BASENAME", "-", "T_STOP",
                           "4320.0", "--device", "cpu"])
        assert again == 0
