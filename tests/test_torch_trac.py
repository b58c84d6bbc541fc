"""The whole path from files: ``run_trac`` in both packages.

The golden control files switch on the chemistry step
(tests/test_torch_golden.py runs them); this file writes its own control
file (transport, diffusion, decay, meteo sampling with
the climatological quantities) and runs both packages on a copy of the
first three met files of ``parity/golden_long/data`` (two hours apart)
with a seeded particle file, 65 steps of 120 s across the met swap at
7200 s, particle output every 20 minutes."""

import glob
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mptrac_tpu.sim import run_trac as jrun_trac
from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import read_ctl
from mptrac_tpu_torch.io import atm_io
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.ops.sort import module_sort
from mptrac_tpu_torch.physics import pipeline
from mptrac_tpu_torch.sim import Simulation, build_pack
from mptrac_tpu_torch.sim import run_trac as trun_trac
from mptrac_tpu_torch.timeutil import time2jsec
from mptrac_tpu_torch.types import Cache, astype_state, stack_met

os.environ.setdefault("LOGLEV", "0")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "parity", "golden_long", "data")
T0 = time2jsec(2011, 6, 5, 0, 0, 0, 0)
T_END = T0 + 7800.0                 # 65 steps of 120 s
NPARCELS = 300
QNT = ("t", "u", "v", "w", "zg", "ps", "m", "hno3", "tice", "tnat", "tsts")
STAMPS = ("00_00", "00_20", "00_40", "01_00", "01_20", "01_40", "02_00",
          "02_10")


def make_case(tmp, direction=1, meso=True):
    """A working directory with the three met files, ``trac.ctl`` and
    ``atm_in.tab`` (300 parcels from a numpy seed, all at the start
    time).  ``meso=False`` switches the mesoscale diffusion off and
    leaves the turbulent diffusion on."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(GOLDEN, "met_2011_06_05_0[024].nc"))):
        shutil.copy(f, tmp)
    t_start, t_stop = (T0, T_END) if direction == 1 else (T_END, T0)
    lines = [f"NQ = {len(QNT)}"] + [
        f"QNT_NAME[{i}] = {n}" for i, n in enumerate(QNT)]
    lines += [f"METBASE = {tmp}/met", "MET_TROPO = 3", "DIFFUSION = 1",
              "TDEC_TROP = 259200", "TDEC_STRAT = 259200", "DT_MET = 7200",
              "DT_MOD = 120", "ATM_BASENAME = atm", "ATM_DT_OUT = 1200",
              f"DIRECTION = {direction}", f"T_STOP = {t_stop:.2f}"]
    if not meso:
        lines += ["TURB_MESOX = 0", "TURB_MESOZ = 0"]
    with open(os.path.join(tmp, "trac.ctl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    rng = np.random.default_rng(5)
    with open(os.path.join(tmp, "atm_in.tab"), "w") as f:
        for _ in range(NPARCELS):
            f.write("%.2f %g %g %g" % (
                t_start, rng.uniform(1, 25), rng.uniform(-180, 180),
                rng.uniform(-85, 85)) + " 0" * 6 + " 1" + " 0" * 4 + "\n")
    with open(os.path.join(tmp, "dirlist"), "w") as f:
        f.write(tmp + "\n")
    return tmp


def outputs(dirname, base="atm"):
    return sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(dirname, base + "_2011_*.tab")))


def load(dirname, name):
    return np.loadtxt(os.path.join(dirname, name))


#: position tolerance [deg] of the float64 runs.  Without the mesoscale
#: diffusion the two packages differ by what Box-Muller's single-precision
#: cos and sin leave (measured 2.6e-9 deg after 65 steps): 1e-6.  With it
#: both accumulate the 16-point wind variance in float32 in the reference's
#: order, ``msq/16 - (mean/16)**2`` cancels from ~400 m2/s2 to the subgrid
#: variance of a smooth wind field, and the last bit of ``msq`` (XLA may
#: contract ``msq + val*val`` into one multiply-add, PyTorch rounds twice)
#: decides between sigma = 0 and 5e-3 m/s in a quiet cell: 0.1 m a step,
#: measured 7.4e-6 deg (0.8 m) after 65 correlated steps, in longitude
#: only (latitude 1.5e-7): 5e-5.
ATOL_DEG = {True: 5e-5, False: 1e-6}


@pytest.fixture(scope="module", params=[(1, True), (-1, False)],
                ids=["forward", "backward-no-meso"])
def both(request, tmp_path_factory):
    """``run_trac`` of the JAX package and of the port (float64, exact
    interpolation) on the same files, one directory each: forward with
    every ported module on, backward without the mesoscale diffusion (and
    so at the strict tolerance)."""
    direction, meso = request.param
    jdir = make_case(tmp_path_factory.mktemp("jax"), direction, meso)
    tdir = make_case(tmp_path_factory.mktemp("torch"), direction, meso)
    jsim = jrun_trac(jdir, "trac.ctl", "atm_in.tab")
    tsim = trun_trac(tdir, "trac.ctl", "atm_in.tab", device="cpu")
    return (direction, meso), jdir, tdir, jsim, tsim


def test_run_trac_outputs_agree_with_jax(both):
    """Every particle file of the run.  The ASCII format holds six
    significant digits (``%g``), so a difference shows as a step of the
    last digit where a value sits on a rounding edge.  Positions to
    ATOL_DEG + one unit of the sixth digit (1e-4 of a longitude up to
    180), the altitude column (``H0 ln(P0/p)``, p to 1e-6 relative) and
    the quantities to 1e-5 relative."""
    (direction, meso), jdir, tdir, jsim, tsim = both
    names = outputs(jdir)
    assert names == outputs(tdir)
    # (a backward run starts at 02:10, which is no output time)
    stamps = STAMPS if direction == 1 else STAMPS[:-1]
    assert names == [f"atm_2011_06_05_{s}_00.tab" for s in stamps]
    for name in names:
        a, b = load(jdir, name), load(tdir, name)
        assert a.shape == b.shape == (NPARCELS, 4 + len(QNT))
        np.testing.assert_array_equal(b[:, 0], a[:, 0], name)
        np.testing.assert_allclose(b[:, 2:4], a[:, 2:4], rtol=0,
                                   atol=ATOL_DEG[meso] + 1e-4, err_msg=name)
        np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        for iq, q in enumerate(QNT):
            np.testing.assert_allclose(
                b[:, 4 + iq], a[:, 4 + iq], rtol=1e-5, atol=1e-12,
                err_msg=f"{name} {q}")
    # the files hold a run: parcels moved, meteo and climatology sampled
    first, last = load(tdir, names[0]), load(tdir, names[-1])
    assert float(np.abs(last[:, 2] - first[:, 2]).max()) > 0.1
    col = {q: 4 + i for i, q in enumerate(QNT)}
    assert float(last[:, col["hno3"]].max()) > 0.0
    assert 150.0 < float(last[:, col["tnat"]].min())
    # 65 steps of decay; a backward run has dt < 0 and undoes it
    m_want = math.exp(-direction * 120.0 / 259200.0) ** 65
    final = last if direction == 1 else first
    np.testing.assert_allclose(final[:, col["m"]], m_want, rtol=1e-5)


def test_run_trac_states_agree_with_jax(both):
    """The final states, without the ASCII rounding: float64, positions
    to ATOL_DEG, pressure to 1e-6 relative (measured 3.5e-10), quantities
    to 1e-5 relative."""
    (direction, meso), jdir, tdir, jsim, tsim = both
    ja, ta = jsim.atm, tsim.atm
    assert ta.lon.dtype == torch.float64 and int(ja.np) == ta.np == NPARCELS
    np.testing.assert_array_equal(ta.time.numpy(), np.asarray(ja.time))
    np.testing.assert_allclose(ta.lon.numpy(), np.asarray(ja.lon), rtol=0,
                               atol=ATOL_DEG[meso])
    np.testing.assert_allclose(ta.lat.numpy(), np.asarray(ja.lat), rtol=0,
                               atol=ATOL_DEG[meso])
    np.testing.assert_allclose(ta.p.numpy(), np.asarray(ja.p), rtol=1e-6,
                               atol=0)
    for q in QNT:
        np.testing.assert_allclose(ta.q[q].numpy(), np.asarray(ja.q[q]),
                                   rtol=1e-5, atol=1e-12, err_msg=q)
    assert tsim.cache.rng_ctr == int(jsim.cache.rng_ctr)


def test_run_crossed_the_met_swap(both):
    """Both buffers end on the pair of the far side of the middle
    snapshot, three files read, the pair rebuilt once."""
    (direction, _), jdir, tdir, jsim, tsim = both
    want = (T0 + 7200.0, T0 + 14400.0) if direction == 1 else (T0, T0 + 7200.0)
    assert tsim.met.pair.time == want
    assert tuple(float(x) for x in np.asarray(jsim.metbuf.pair.time)) == want
    assert len(tsim.met.reads) == 3
    assert {"READ_ATM", "GET_MET", "RUN_TIMESTEP", "WRITE_OUTPUT"} <= set(
        tsim.timers.as_dict())
    assert tsim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 66


# ------------------------------------------------------- float32 modes

def manual_loop(dirname, fast, args=()):
    """The in-memory step loop on the pairs that ``read_met`` +
    ``astype_state`` give: sort when due, one ``run_timestep`` per step,
    the pack rebuilt for the second pair."""
    f32 = torch.float32
    ctl = read_ctl(os.path.join(dirname, "trac.ctl"),
                   ("TPU_FAST", str(fast), "SORT_DT", "1800") + tuple(args))
    clim = read_clim(ctl, device="cpu")
    atm = atm_io.read_atm(os.path.join(dirname, "atm_in.tab"), ctl,
                          dtype=f32, device="cpu")
    sim = Simulation(ctl, atm, clim, dirname=dirname)    # for ctl and times
    ctl, clim = sim.ctl, sim.clim
    mets = [astype_state(met=read_met(
        os.path.join(dirname, f"met_2011_06_05_0{h}.nc"), ctl, clim,
        device="cpu"), dtype=f32) for h in (0, 2, 4)]
    pairs = [stack_met(mets[0], mets[1]), stack_met(mets[1], mets[2])]
    packs = [build_pack(ctl, p) for p in pairs]
    cache = Cache.zeros(atm.npmax, f32, iso_npmax=1, device="cpu")
    nsort = 0
    for i, t in enumerate(sim.times()):
        k = 0 if t <= T0 + 7200.0 else 1
        if i == 0:
            atm, cache = pipeline.init_modules(ctl, clim, pairs[k], atm,
                                               cache)
        if math.fmod(t, ctl.sort_dt) == 0:
            atm, cache = module_sort(pairs[k], atm, cache)
            nsort += 1
        atm, cache = pipeline.run_timestep(
            ctl, clim, pairs[k], atm, cache, t, sim._flags(t), packs[k])
    return atm, cache, nsort


@pytest.fixture(scope="module")
def fcase(tmp_path_factory):
    return make_case(tmp_path_factory.mktemp("f32"))


@pytest.mark.parametrize("fast", [1, 2])
def test_float32_run_trac_equals_in_memory_loop(fcase, fast):
    """``run_trac(dtype=float32)`` with ``TPU_FAST 1`` (the unfused
    kernels' path) and ``2`` (the fused kernel's) from files equals the
    in-memory step loop bit for bit, the met swap and the sorts
    included."""
    sim = trun_trac(fcase, "trac.ctl", "atm_in.tab",
                    ("TPU_FAST", str(fast), "SORT_DT", "1800",
                     "ATM_BASENAME", f"f32_{fast}"), device="cpu",
                    dtype=torch.float32)
    atm, cache, nsort = manual_loop(fcase, fast)
    assert sim.atm.lon.dtype == torch.float32
    assert sim.atm.time.dtype == torch.float64
    assert sim.pack is not None and (sim.pack.cell is not None) == (fast == 2)
    assert sim.nsorts == nsort == 5
    for name in ("time", "lon", "lat", "p"):
        assert torch.equal(getattr(sim.atm, name), getattr(atm, name)), name
    for q in QNT:
        assert torch.equal(sim.atm.q[q], atm.q[q]), q
    assert torch.equal(sim.cache.uvwp, cache.uvwp)
    assert sim.cache.rng_ctr == cache.rng_ctr
    assert len(outputs(fcase, f"f32_{fast}")) == 8


@pytest.mark.parametrize("fast", [1, 2])
def test_float32_stays_near_float64_without_diffusion(fcase, fast):
    """With the random displacements off, 65 float32 steps on the
    kernels' paths stay within 1e-3 deg and 1e-3 relative in pressure of
    the float64 exact run (a float32 longitude carries 1.5e-5 deg a
    step).  The float32 run sorts its parcels; a quantity of its own
    carries the order of the particle file."""
    off = ("DIFFUSION", "0", "ATM_BASENAME", "-")
    ref = trun_trac(fcase, "trac.ctl", "atm_in.tab", off, device="cpu")
    ctl = read_ctl(os.path.join(fcase, "trac.ctl"), off + (
        "TPU_FAST", str(fast), "SORT_DT", "1800", "NQ", str(len(QNT) + 1),
        f"QNT_NAME[{len(QNT)}]", "idx"))
    atm = atm_io.read_atm(os.path.join(fcase, "atm_in.tab"), ctl,
                          dtype=torch.float32, device="cpu")
    atm = atm.replace(q=dict(atm.q, idx=torch.arange(
        atm.npmax, dtype=torch.float32)))
    sim = Simulation(ctl, atm, dirname=fcase)
    sim.run(write_output=False)
    assert ref.nsorts == 0 and sim.nsorts == 5
    order = torch.argsort(sim.atm.q["idx"])
    assert not torch.equal(order, torch.arange(NPARCELS))

    def col(x):
        return x[order].numpy().astype(np.float64)

    dlon = (col(sim.atm.lon) - ref.atm.lon.numpy() + 180.0) % 360.0 - 180.0
    assert float(np.abs(dlon).max()) < 1e-3
    assert float(np.abs(col(sim.atm.lat) - ref.atm.lat.numpy()).max()) < 1e-3
    np.testing.assert_allclose(col(sim.atm.p), ref.atm.p.numpy(), rtol=1e-3)
    start_lon = np.loadtxt(os.path.join(fcase, "atm_in.tab"))[:, 2]
    assert float(np.abs(ref.atm.lon.numpy() - start_lon).max()) > 0.1


# ------------------------------------------------------------ the tool

def test_cli_writes_the_files_of_run_trac(tmp_path):
    """``python -m mptrac_tpu_torch.tools.trac ... --device cpu`` in a
    process of its own writes the files that ``run_trac`` writes, byte for
    byte, and imports neither jax nor the JAX package."""
    tdir = make_case(tmp_path / "run_trac")
    trun_trac(tdir, "trac.ctl", "atm_in.tab", device="cpu")
    cdir = make_case(tmp_path / "tool")
    code = ("import sys\n"
            "from mptrac_tpu_torch.tools import trac\n"
            "rc = trac.main(sys.argv)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mptrac_tpu' or "
            "m.startswith('mptrac_tpu.')]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, LOGLEV="0")
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(cdir, "dirlist"),
         "trac.ctl", "atm_in.tab", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = outputs(cdir)
    assert names == outputs(tdir) and len(names) == 8
    for name in names:
        with open(os.path.join(cdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_cli_usage_and_defaults(tmp_path, capsys):
    """Too few arguments print the usage; ``--device`` defaults to the
    card and raises without one; a wrong value names the choices."""
    from mptrac_tpu_torch.tools import trac
    from mptrac_tpu_torch.tools._cli import UsageError, run_tool
    assert run_tool(trac.main, ["trac", "dirlist"]) != 0
    assert "--device cuda|cpu" in capsys.readouterr().err
    with pytest.raises(UsageError, match="float64, float32"):
        trac.main(["trac", "d", "c", "a", "--dtype", "bfloat16"])
    cdir = make_case(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            trac.main(["trac", os.path.join(cdir, "dirlist"), "trac.ctl",
                       "atm_in.tab"])
        with pytest.raises(RuntimeError, match="cuda"):
            trun_trac(cdir, "trac.ctl", "atm_in.tab")


# ------------------------------------------------- what is not ported

@pytest.mark.parametrize("args,match", [
    (("MET_TYPE", "9"), "no such meteo data type"),
])
def test_unported_gate_raises_by_name(fcase, args, match):
    """The gate that remains: a MET_TYPE that names no reader.  (MET_TYPE
    1 and ATM_TYPE_OUT 3 were cases here while the binary met readers and
    the CLaMS particle files raised; tests/test_torch_met_bin.py and
    test_torch_atm_io.py hold them now.  ``DD 1`` was one until the
    domain decomposition was ported: test_ported_module_runs_and_agrees_
    with_jax holds it.)"""
    with pytest.raises(NotImplementedError, match=match):
        trun_trac(fcase, "trac.ctl", "atm_in.tab",
                  args + ("ATM_BASENAME", "gate", "T_STOP",
                          f"{T0 + 240.0:.2f}"), device="cpu")


@pytest.fixture
def one_torch_thread():
    """A few hundred parcels: more intra-op threads would only spin, on
    the cores of the other test workers (KPP's loop runs ~1000 small
    steps a call)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _particles_with(dirname, columns):
    """Rewrite the case's particle file with the quantity columns
    ``columns`` (index: value) set."""
    path = os.path.join(dirname, "atm_in.tab")
    rows = np.loadtxt(path, ndmin=2)
    for k, v in columns.items():
        rows[:, 4 + k] = v
    np.savetxt(path, rows, fmt="%.10g")


@pytest.mark.parametrize("args", [
    ("OH_CHEM_REACTION", "2"),
    ("MIXING_TROP", "1e-3", "MIXING_STRAT", "1e-6"),
    ("DRY_DEPO_VDEP", "0.15"),
    ("BOUND_P0", "1e10", "BOUND_P1", "-1e10", "BOUND_LAT0", "-90",
     "BOUND_LAT1", "90"),
    ("TURB_PBL_SCHEME", "1"),
    ("QNT_NAME[9]", "rp", "QNT_NAME[10]", "rhop"),
    ("ISOSURF", "1"),
    ("RADIO_DECAY", "1"),
    ("KPP_CHEM", "1"),
    ("RNG_TYPE", "2"),
    ("DD", "1"),
], ids=["chem_grid", "mixing", "dry_depo", "bound_cond", "pbl", "sedi",
        "isosurf", "radio_decay", "kpp", "rng_type_2", "dd"])
def test_ported_module_runs_and_agrees_with_jax(tmp_path, args,
                                                one_torch_thread):
    """Control parameters that reach the chemistry grid and the OH
    chemistry, the mixing, the dry deposition, the boundary conditions,
    the PBL scheme, sedimentation (of 1 um particles of 2500 kg/m^3), the
    isosurface, radioactive decay, KPP chemistry, the threefry
    generator and ``DD 1`` (whose only effect in ``run_trac``, in both
    packages, is that module_timesteps skips the local-domain freeze):
    ``run_trac`` runs to the end in both packages (float64, the
    case of ``make_case``, three steps) and the final states agree at the
    tolerances of test_run_trac_states_agree_with_jax.  (These were the
    cases of test_unported_gate_raises_by_name while the modules raised;
    tests/test_torch_chem.py, test_torch_pbl.py, test_torch_kpp.py and
    test_torch_rng.py hold each module's effect.)"""
    run = args + ("ATM_BASENAME", "-", "T_STOP", f"{T0 + 240.0:.2f}")
    jdir = make_case(tmp_path / "jax")
    tdir = make_case(tmp_path / "torch")
    if "rp" in args:
        for d in (jdir, tdir):
            _particles_with(d, {9: 1.0, 10: 2500.0})
    ja = jrun_trac(jdir, "trac.ctl", "atm_in.tab", list(run)).atm
    tsim = trun_trac(tdir, "trac.ctl", "atm_in.tab", run, device="cpu")
    ta = tsim.atm
    assert tsim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 3
    np.testing.assert_array_equal(ta.time.numpy(), np.asarray(ja.time))
    for name in ("lon", "lat"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), rtol=0,
                                   atol=ATOL_DEG[True], err_msg=name)
    np.testing.assert_allclose(ta.p.numpy(), np.asarray(ja.p), rtol=1e-6,
                               atol=0)
    assert set(ta.q) == set(ja.q) and len(ta.q) == len(QNT)
    for q in ta.q:
        np.testing.assert_allclose(ta.q[q].numpy(), np.asarray(ja.q[q]),
                                   rtol=1e-5, atol=1e-12, err_msg=q)
    assert bool(torch.isfinite(ta.p).all())


def _obs_file(path, rng, n=240):
    """Observations over the globe at the first three step times of the
    case (the CSI, profile and sample writers read them)."""
    t = np.sort(T0 + rng.choice([0.0, 120.0, 240.0], n))
    rows = np.stack([t, rng.uniform(1.0, 25.0, n), rng.uniform(-180, 180, n),
                     rng.uniform(-85, 85, n), 10.0 ** rng.uniform(-9, -3, n)],
                    axis=-1)
    np.savetxt(path, rows, fmt="%.10g")
    return str(path)


#: every output writer as the writer cases run them (golden_chem's
#: station, a coarse grid, observations over the globe); ``stat`` and
#: ``ens`` take the places of the case's last two quantities
WRITER_ARGS = (
    "QNT_NAME[9]", "stat", "QNT_NAME[10]", "ens", "MOLMASS", "64.066",
    "GRID_BASENAME", "grid", "GRID_DT_OUT", "240", "GRID_NX", "36",
    "GRID_NY", "18", "GRID_NZ", "5", "GRID_Z0", "0", "GRID_Z1", "25",
    "ENS_BASENAME", "ens", "ENS_DT_OUT", "240",
    "CSI_BASENAME", "csi", "CSI_OBSFILE", "OBS", "CSI_DT_OUT", "240",
    "CSI_NX", "36", "CSI_NY", "18", "CSI_OBSMIN", "1e-6",
    "CSI_MODMIN", "1e-13",
    "PROF_BASENAME", "prof", "PROF_OBSFILE", "OBS", "PROF_NX", "36",
    "PROF_NY", "18", "PROF_NZ", "25", "PROF_Z1", "25",
    "SAMPLE_BASENAME", "sample", "SAMPLE_OBSFILE", "OBS",
    "SAMPLE_DX", "1000", "SAMPLE_DZ", "5",
    "STAT_BASENAME", "station", "STAT_LON", "-72", "STAT_LAT", "-40.5",
    "STAT_R", "4000", "VTK_BASENAME", "vtk", "VTK_DT_OUT", "240")


@pytest.fixture(scope="module")
def writer_runs(tmp_path_factory):
    """Both packages' ``run_trac`` with every writer on (float64, the case
    of ``make_case`` without the mesoscale diffusion, three steps)."""
    tmp = tmp_path_factory.mktemp("writers")
    obs = _obs_file(tmp / "obs.tab", np.random.default_rng(9))
    run = tuple(obs if a == "OBS" else a for a in WRITER_ARGS) + (
        "ATM_BASENAME", "-", "T_STOP", f"{T0 + 240.0:.2f}")
    jdir = make_case(tmp / "jax", meso=False)
    tdir = make_case(tmp / "torch", meso=False)
    jrun_trac(jdir, "trac.ctl", "atm_in.tab", list(run))
    tsim = trun_trac(tdir, "trac.ctl", "atm_in.tab", run, device="cpu")
    assert tsim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 3
    return jdir, tdir, tsim


@pytest.mark.parametrize("base", ["grid", "ens", "csi", "prof", "sample",
                                  "station", "vtk"])
def test_writer_runs_and_agrees_with_jax(writer_runs, base):
    """Each output writer through ``run_trac`` in both packages: the same
    files, and in them the same numbers at the precision of their ``%g``
    print (rtol 1e-5) and the same counts.  These were cases of
    test_unported_gate_raises_by_name while the writers raised;
    tests/test_torch_output.py holds each writer on one state at rtol
    1e-12."""
    from test_full_parity import load_tab, load_vtk_points
    jdir, tdir, tsim = writer_runs
    names = sorted(f for f in os.listdir(jdir) if f.startswith(base))
    assert names and sorted(f for f in os.listdir(tdir)
                            if f.startswith(base)) == names
    rows = 0
    for name in names:
        a, b = os.path.join(tdir, name), os.path.join(jdir, name)
        if name.endswith(".vtk"):
            x, y = load_vtk_points(a), load_vtk_points(b)
        else:
            x, y = load_tab(a), load_tab(b)
        assert x.shape == y.shape, name
        rows += y.shape[0]
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-12,
                                   equal_nan=True, err_msg=name)
    assert rows > 0
    if base == "station":
        assert int((tsim.atm.q["stat"] == 1).sum()) == rows


def test_checkpoint_writes_and_resumes(fcase, tmp_path, one_torch_thread):
    """``checkpoint_file`` (the gate of test_checkpoint_raises_by_name
    while checkpoints were not ported): on the case's files a run to
    240 s writes its checkpoint, and a fresh Simulation resumed from it
    ends where the uninterrupted run to 600 s ends, bit for bit, across
    the met file's parcels and the sort of neither (float64)."""
    ck = str(tmp_path / "ckpt.npz")
    args = ("ATM_BASENAME", "-")

    def sim(t_stop, **kw):
        ctl = read_ctl(os.path.join(fcase, "trac.ctl"),
                       args + ("T_STOP", f"{T0 + t_stop:.2f}"))
        atm = atm_io.read_atm(os.path.join(fcase, "atm_in.tab"), ctl,
                              device="cpu")
        return Simulation(ctl, atm, dirname=fcase, **kw)

    full = sim(600.0)
    full.run()
    sim(240.0, checkpoint_file=ck, checkpoint_dt=120.0).run()
    resumed = sim(600.0).resume(ck)
    resumed.run()
    assert resumed.timers.as_dict()["RUN_TIMESTEP"]["count"] == 3
    for name in ("time", "lon", "lat", "p"):
        assert torch.equal(getattr(resumed.atm, name),
                           getattr(full.atm, name)), name
    for name in full.atm.q:
        assert torch.equal(resumed.atm.q[name], full.atm.q[name]), name
    assert torch.equal(resumed.cache.uvwp, full.cache.uvwp)
    assert resumed.cache.rng_ctr == full.cache.rng_ctr


def test_scan_argument_is_accepted(fcase):
    """``run(scan=...)`` exists for the JAX package's signature and
    changes nothing."""
    args = ("ATM_BASENAME", "-", "T_STOP", f"{T0 + 600.0:.2f}")
    ctl = read_ctl(os.path.join(fcase, "trac.ctl"), args)
    ends = []
    for scan in (True, False):
        atm = atm_io.read_atm(os.path.join(fcase, "atm_in.tab"), ctl,
                              device="cpu")
        sim = Simulation(ctl, atm, dirname=fcase)
        ends.append(sim.run(scan=scan))
    assert torch.equal(ends[0].lon, ends[1].lon)
    assert float((ends[0].time - (T0 + 600.0)).abs().max()) == 0.0


@pytest.mark.parametrize("mode,fast", [("float32", "2"), ("float32", "1"),
                                       ("float64", "0")])
def test_flagship_case_through_files(tmp_path, mode, fast):
    """``flagship.write_case`` (three synthetic met files an hour apart,
    a binary particle file, the flagship's control parameters) through
    ``run_trac``: 10 steps across the met swap on each of the three
    paths; the binary output holds the final state, the mass has decayed
    by ten steps, T is the met's uniform 280 K."""
    from mptrac_tpu_torch import flagship
    n = 2048
    flagship.write_case(str(tmp_path), n, (36, 19, 8), 2700.0, 4500.0, 900,
                        extra_ctl=("TPU_FAST", fast))
    dtype = getattr(torch, mode)
    sim = trun_trac(str(tmp_path), "trac.ctl", "atm_in.bin", device="cpu",
                    dtype=dtype)
    assert [r["file"] for r in sim.met.reads] == [
        f"met_2000_01_01_0{h}.nc" for h in range(3)]
    assert sim.met.pair.time == (3600.0, 7200.0) and sim.nsorts == 3
    assert (sim.pack is None) == (fast == "0")
    back = atm_io.read_atm(
        os.path.join(str(tmp_path), "atm_2000_01_01_01_15_00.bin"), sim.ctl,
        device="cpu")
    assert back.np == n
    assert torch.equal(back.lon.to(dtype), sim.atm.lon)
    assert torch.equal(back.q["m"].to(dtype), sim.atm.q["m"])
    assert float((back.time - 4500.0).abs().max()) == 0.0
    np.testing.assert_allclose(back.q["m"].numpy(),
                               math.exp(-180.0 / 259200.0) ** 10, rtol=1e-5)
    np.testing.assert_allclose(back.q["t"].numpy(), 280.0, atol=1e-2)
    start = np.random.default_rng(0).uniform(-180, 180, n)
    assert float(np.abs(back.lon.numpy()).max()) <= 180.0
    assert 1e-3 < float(np.abs(
        (np.sort(back.lon.numpy()) - np.sort(start))).max())
