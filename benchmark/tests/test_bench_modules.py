"""The harness finds a configuration's met generator and reference and
a workload's driver by name (``manifest``), with ``wind``, ``plain`` and
``single`` where none is named: on the CPU at a tiny size.

* The three cells read, bit for bit, what the harness read before the
  three kinds of module were split out of it (``PINNED``: the numbers
  compared and the control's, recorded with that harness at ``TINY``
  sizes, seed ``SEED``, one period).
* A configuration and cell that exist only here (in a temporary copy of
  the manifest's directories) bring their own met, reference and
  driver, and read ``correct``; with a reference that is wrong on
  purpose they read ``correct`` false.
* An unknown name, a control key that the reference does not model, a
  dtype that the driver does not run and a met source that is neither
  ``memory`` nor ``files`` are refused with ``RunError`` before the run;
  a reference that loads a module of JAX is refused after it.
"""

import json
import shutil
import sys

import pytest

from benchmark import checks, harness, manifest
from benchmark.tests.conftest import TINY

SEED = 2 ** 31 + 4242

PINNED = {
    "base.mem": {
        "numbers": {
            "pos_km": "0x1.12eba1d3854b5p-9",
            "p_rel": "0x1.fdf32865a4671p-25",
            "m_rel": "0x1.43a1182b891d6p-27",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.e75cb96800000p-23",
            "time_abs": "0x0.0p+0",
            "sort_bad": "0x0.0p+0",
        },
        "control": {
            "pos_km": "0x1.e5bacc6f34fc0p+5",
            "p_rel": "0x1.196f41b5758a6p-8",
            "m_rel": "0x1.51c44703ac7e5p-9",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.8e827302bf069p-1",
            "time_abs": "0x0.0p+0",
        },
    },
    "chem.mem": {
        "numbers": {
            "pos_km": "0x1.2700a2e9021a9p-9",
            "p_rel": "0x1.2113f9cddfa04p-24",
            "m_rel": "0x1.041af0b6ce099p-23",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.02d8157500000p-22",
            "time_abs": "0x0.0p+0",
            "sort_bad": "0x0.0p+0",
        },
        "control": {
            "pos_km": "0x1.eb82ed8a703e1p+5",
            "p_rel": "0x1.a136a92f85340p-8",
            "m_rel": "0x1.59f513cf6bfccp-7",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.aaabc9a6215a4p-1",
            "time_abs": "0x0.0p+0",
        },
    },
    "base.hourly_nc": {
        "numbers": {
            "pos_km": "0x1.2a1d8e0586688p-9",
            "p_rel": "0x1.f1e38341328a8p-25",
            "m_rel": "0x1.5517283188bb9p-25",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.efd662e300000p-23",
            "time_abs": "0x0.0p+0",
            "sort_bad": "0x0.0p+0",
            "met_rel": "0x1.a897782008225p-25",
            "met_time": "0x0.0p+0",
        },
        "control": {
            "pos_km": "0x1.ea63febef8942p+5",
            "p_rel": "0x1.33ac135900732p-8",
            "m_rel": "0x1.5ec562047f1e7p-9",
            "t_abs": "0x0.0p+0",
            "uvw_abs": "0x1.d7cc63e67a2b3p-1",
            "time_abs": "0x0.0p+0",
            "met_rel": "0x1.94e5716d8bc1cp-9",
            "met_time": "0x0.0p+0",
        },
    },
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_numbers_equal_the_harness_before_the_split(cell):
    out = harness.run(cell, SEED, 0.0, False, device="cpu", sizes=TINY,
                      control=True)
    assert out["correct"]
    for part in ("numbers", "control"):
        got = {k: float(v).hex() for k, v in out[part].items()}
        assert got == PINNED[cell][part], part


#: the test's own modules, beside copies of the benchmark's
SUBSIDING = """
import numpy as np
from benchmark import manifest

_wind = manifest.met_generator({})
CTL, filename = _wind.CTL, _wind.filename


def snapshots(grid, met, times):
    lon, lat, p, f2, f3 = _wind.snapshots(grid, met, times[:1])[0]
    f3 = dict(f3, w=np.full_like(f3["w"], -0.005))  # subsidence [hPa/s]
    return [(lon, lat, p, f2, f3) for _ in times]
"""

REFERENCE = """
from benchmark import manifest

_plain = manifest.reference({})
MODELS, PATH_KEYS, INGESTED = _plain.MODELS, _plain.PATH_KEYS, _plain.INGESTED
params, load_clim, met_pair = _plain.params, _plain.load_clim, _plain.met_pair
step, ingest = _plain.step, _plain.ingest
SHIFT = %r                  # degrees of longitude added to every parcel


def step_versions(*args, **kw):
    return [dict(v, lon=v["lon"] + SHIFT)
            for v in _plain.step_versions(*args, **kw)]
"""

JAXY = """
import sys
import types

from benchmark import manifest

_plain = manifest.reference({})
MODELS, PATH_KEYS, INGESTED = _plain.MODELS, _plain.PATH_KEYS, _plain.INGESTED
params, load_clim, met_pair = _plain.params, _plain.load_clim, _plain.met_pair
step, ingest = _plain.step, _plain.ingest


def step_versions(*args, **kw):
    # stands for an ``import flax`` inside the reference's step
    sys.modules.setdefault("flax", types.ModuleType("flax"))
    return _plain.step_versions(*args, **kw)
"""

RELAY = """
from benchmark import manifest

_single = manifest.driver({})


class Driver(_single.Driver):
    \"\"\"single's driver, stepping through a method of its own.\"\"\"

    def step(self, t):
        super().step(t)
"""


@pytest.fixture
def own(tmp_path, monkeypatch):
    """A copy of the manifest's directories with the test's own modules;
    returns a function that adds a configuration and a cell and lists
    the modules the harness loads."""
    for kind in ("configs", "workloads", "mets", "references", "drivers"):
        shutil.copytree(f"{manifest.HERE}/{kind}", tmp_path / kind)
    (tmp_path / "mets" / "subsiding.py").write_text(SUBSIDING)
    (tmp_path / "references" / "mine.py").write_text(REFERENCE % 0.0)
    (tmp_path / "references" / "wrong.py").write_text(REFERENCE % 0.01)
    (tmp_path / "references" / "jaxy.py").write_text(JAXY)
    (tmp_path / "drivers" / "relay.py").write_text(RELAY)
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    loaded = []
    module = manifest._module

    def spy(kind, name):
        loaded.append((kind, name))
        return module(kind, name)

    monkeypatch.setattr(manifest, "_module", spy)

    def add(name, cfg_changes, wl_changes, like="base.mem"):
        cfg = dict(manifest.config("base"), **cfg_changes)
        cfg.pop("name")
        wl = dict(manifest.workload(like), config=name, **wl_changes)
        wl.pop("name")
        cell = name + like[like.index("."):]
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        return cell

    return add, loaded


def _run(cell):
    return harness.run(cell, 2 ** 31 + 77, 0.0, False, device="cpu",
                       sizes=TINY)


@pytest.mark.parametrize("reference, correct", [("mine", True),
                                                ("wrong", False)])
def test_own_met_reference_and_driver(own, reference, correct):
    add, loaded = own
    cell = add("mine", {"generator": "subsiding", "reference": reference},
               {"driver": "relay"})
    out = _run(cell)
    assert out["correct"] is correct, out["checks"]
    assert {("mets", "subsiding"), ("references", reference),
            ("drivers", "relay")} <= set(loaded)
    if not correct:
        assert out["checks"]["pos_km"]["value"] > 0.5


@pytest.mark.parametrize("kind, key, where", [
    ("mets", "generator", 0), ("references", "reference", 0),
    ("drivers", "driver", 1)])
def test_unknown_name_is_refused(own, kind, key, where):
    add, _ = own
    changes = [{}, {}]
    changes[where][key] = "nosuch"
    cell = add("unknown", *changes)
    with pytest.raises(harness.RunError, match=f"{kind}/nosuch.py"):
        _run(cell)


def test_unmodelled_key_is_refused_before_the_run(own):
    add, loaded = own
    base = manifest.config("base")
    cell = add("rk4", {"ctl": base["ctl"] + ["ADVECT", "4"]}, {})
    with pytest.raises(harness.RunError, match="ADVECT 4"):
        _run(cell)
    assert [k for k, _ in loaded] == ["references"]


def test_dtype_other_than_float32_is_refused(own):
    add, _ = own
    cell = add("f64", {"dtype": "float64"}, {})
    with pytest.raises(harness.RunError, match="float64"):
        _run(cell)


def test_what_the_plain_reference_models():
    plain = manifest.reference({})
    for name in ("base", "chem"):
        assert checks.unmodelled(manifest.config(name), plain) == []
    path = ["TPU_FAST", "1", "SORT_DT", "-999", "DT_MOD", "360",
            "ADVECT", "2.0", "SPECIES", "SO2"]
    assert checks.unmodelled({"ctl": path}, plain) == []
    assert checks.unmodelled(
        {"ctl": ["ADVECT", "4", "DIFFUSION", "0", "WET_DEPO_PRE[0]", "0.5",
                 "SPECIES", "NH3"],
         "clim_files": {"CLIM_PHOTO": "photo.nc"}}, plain) == [
        "ADVECT 4", "DIFFUSION 0", "WET_DEPO_PRE[0] 0.5", "SPECIES NH3",
        "CLIM_PHOTO photo.nc"]


def test_jax_loaded_by_the_reference_is_refused(own):
    add, loaded = own
    assert "flax" not in sys.modules
    cell = add("jaxy", {"reference": "jaxy"}, {})
    try:
        with pytest.raises(harness.RunError, match="'flax' is loaded"):
            _run(cell)
        assert ("references", "jaxy") in loaded
    finally:
        sys.modules.pop("flax", None)


@pytest.mark.parametrize("source", ["files", "netcdf"])
def test_met_files_named_by_files_or_the_generators_format(own, source):
    add, _ = own
    wl = manifest.workload("base.hourly_nc")
    cell = add("series", {}, {"met": dict(wl["met"], source=source)},
               like="base.hourly_nc")
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert "met_rel" in out["checks"]


def test_unknown_met_source_is_refused_before_the_run(own):
    add, loaded = own
    wl = manifest.workload("base.hourly_nc")
    cell = add("grib", {}, {"met": dict(wl["met"], source="grib")},
               like="base.hourly_nc")
    with pytest.raises(harness.RunError, match="met source 'grib'"):
        _run(cell)
    assert ("drivers", "single") not in loaded
