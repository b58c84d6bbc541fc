"""Golden parity of the port end to end: ``mptrac_tpu_torch.sim.run_trac``
on the CPU in float64 on the committed golden sets of the reference model,
held to the JAX package's own golden tests.

* ``parity/golden_long``: 1020 steps of 120 s of the chemistry
  configuration (SO2 with OH / H2O2 / tracer chemistry, convection,
  mixing, boundary conditions, decay, dry deposition), staged at steps
  60, 300 and 1020 with the tolerances of ``tests/test_long_parity.py``
  (``STAGES``) and its below-a-cell check.
* ``parity/golden_chem``: the same physics for 60 steps with every
  output writer on, as ``tests/test_full_parity.py`` runs it: the
  particle files at 00:10, 01:00 and 02:00 (with the station flag
  ``stat`` that the station writer sets), the grid files at 00, 01 and
  02 h, the ensemble files at 01 and 02 h, the CSI, station, profile
  and sample tables and the third VTK file, each at the tolerances of
  its test there.

The golden control files name climatology files of a reference checkout;
both runs pass ``CLIM_*`` overrides that point at the copies in
``mptrac_tpu_torch/data`` (the same six keys the control files set).
"""

import os
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

import test_long_parity as long_parity
from test_full_parity import assert_tab_close, load_tab, load_vtk_points
from mptrac_tpu_torch.sim import run_trac

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "mptrac_tpu_torch" / "data"
GOLD_LONG = REPO / "parity" / "golden_long" / "data"
GOLD_CHEM = REPO / "parity" / "golden_chem" / "data"

#: the climatology files of the golden control files, in this package
CLIM_OVERRIDES = (
    "CLIM_PHOTO", str(DATA / "clams_photolysis_rates.nc"),
    "CLIM_OH_FILENAME", str(DATA / "clams_radical_species_vmr.nc"),
    "CLIM_H2O2_FILENAME", str(DATA / "cams_H2O2.nc"),
    "CLIM_HO2_FILENAME", str(DATA / "clams_radical_species_vmr.nc"),
    "CLIM_O1D_FILENAME", str(DATA / "clams_radical_species_vmr.nc"),
    "CLIM_CCL3F_TIMESERIES", str(DATA / "noaa_gml_cfc11.tab"),
)

#: tolerances of tests/test_full_parity.py::test_chem_atm (inline there,
#: so repeated here): positions to 1e-5, the rest at %g precision
CHEM_COL_TOL = {0: (0, 0), 1: (0, 1e-5), 2: (0, 1e-5), 3: (0, 1e-5)}
CHEM_DEFAULT = (1e-4, 1e-9)

#: the writers of tests/test_full_parity.py's chem_run, with its
#: observation file
CHEM_WRITERS = (
    "GRID_BASENAME", "grid", "ENS_BASENAME", "ens",
    "STAT_BASENAME", "station",
    "CSI_BASENAME", "csi", "CSI_OBSFILE", "data/obs.tab",
    "PROF_BASENAME", "prof", "PROF_OBSFILE", "data/obs.tab",
    "SAMPLE_BASENAME", "sample", "SAMPLE_OBSFILE", "data/obs.tab",
    "VTK_BASENAME", "atm")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """2000 parcels a step: more intra-op threads would only spin, on
    the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_golden(tmpdir, golden, extra=()):
    """The port's run_trac on a copy of a golden set, laid out as the
    JAX package's tests/test_full_parity.py:run_ours lays it out;
    returns (output directory, simulation, seconds)."""
    data = tmpdir / "data"
    data.mkdir()
    for f in ("trac.ctl", "atm_split.tab", "obs.tab"):
        if (golden / f).exists():
            shutil.copy(golden / f, data / f)
    for f in sorted(golden.glob("met_*.nc")):
        shutil.copy(f, data / f.name)
    cwd = os.getcwd()
    os.chdir(tmpdir)
    try:
        t0 = time.perf_counter()
        sim = run_trac("data", "trac.ctl", "atm_split.tab",
                       ("ATM_BASENAME", "atm") + tuple(extra)
                       + CLIM_OVERRIDES, device="cpu")
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return data, sim, seconds


@pytest.fixture(scope="module")
def long_run(tmp_path_factory):
    data, sim, seconds = run_golden(tmp_path_factory.mktemp("torch_long"),
                                    GOLD_LONG)
    print(f"golden_long: 1020 steps in {seconds:.1f} s")
    return data, sim


@pytest.fixture(scope="module")
def chem_run(tmp_path_factory):
    data, sim, seconds = run_golden(tmp_path_factory.mktemp("torch_chem"),
                                    GOLD_CHEM, CHEM_WRITERS)
    print(f"golden_chem: 60 steps in {seconds:.1f} s")
    return data, sim


@pytest.mark.parametrize("stamp,step,col_tol,default", long_parity.STAGES,
                         ids=[f"step{s[1]}" for s in long_parity.STAGES])
def test_long_atm(long_run, stamp, step, col_tol, default):
    data, _ = long_run
    f = f"atm_{stamp}.tab"
    assert_tab_close(data / f, GOLD_LONG / f, col_tol=col_tol,
                     default=default)


def test_long_divergence_below_cell(long_run):
    data, sim = long_run
    long_parity.test_long_divergence_below_cell(data)
    # the run went through the chemistry step: the physics that the
    # control file switches on, the met swaps and every step
    ctl = sim.ctl
    assert ctl.oh_chem_reaction == 3 and ctl.h2o2_chem_reaction == 1
    assert ctl.tracer_chem and ctl.conv_cape >= 0 and ctl.mixing_trop >= 0
    assert sim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 1021
    assert len(sim.met.reads) == 18


@pytest.mark.parametrize("stamp", ["00_10_00", "01_00_00", "02_00_00"])
def test_chem_atm(chem_run, stamp):
    """Every column, the station flag ``stat`` (column 11) included: the
    station writer sets it on the device state after the particle file
    of the same time is written, so a file shows the flags of the
    previous writes."""
    data, _ = chem_run
    f = f"atm_2011_06_05_{stamp}.tab"
    ours, ref = load_tab(data / f), load_tab(GOLD_CHEM / f)
    assert ours.shape == ref.shape
    stat = 4 + 7
    assert np.any(ref[:, stat] == 1.0)
    np.testing.assert_array_equal(ours[:, stat], ref[:, stat])
    assert_tab_close(data / f, GOLD_CHEM / f, col_tol=CHEM_COL_TOL,
                     default=CHEM_DEFAULT)


# ----------------------- golden_chem's writers, as test_full_parity.py

@pytest.mark.parametrize("stamp", ["00_00_00", "01_00_00", "02_00_00"])
def test_chem_grid_output(chem_run, stamp):
    data, _ = chem_run
    f = f"grid_2011_06_05_{stamp}.tab"
    assert_tab_close(data / f, GOLD_CHEM / f, default=(1e-4, 1e-9))


@pytest.mark.parametrize("stamp", ["01_00_00", "02_00_00"])
def test_chem_ens_output(chem_run, stamp):
    data, _ = chem_run
    f = f"ens_2011_06_05_{stamp}.tab"
    # sigma columns accumulate mean-of-squares cancellation; 1%
    assert_tab_close(data / f, GOLD_CHEM / f, default=(1e-2, 1e-6))


@pytest.mark.parametrize("name", ["csi", "station", "prof", "sample"])
def test_chem_table_output(chem_run, name):
    data, _ = chem_run
    assert_tab_close(data / f"{name}.tab", GOLD_CHEM / f"{name}.tab",
                     default=(1e-4, 1e-6))


def test_chem_vtk(chem_run):
    data, _ = chem_run
    ours = load_vtk_points(data / "atm_00003.vtk")
    ref = load_vtk_points(GOLD_CHEM / "atm_00003.vtk")
    assert ours.shape == ref.shape and ref.size > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
