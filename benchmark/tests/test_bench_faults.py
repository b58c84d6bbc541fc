"""A run with the timed path broken underneath reads ``correct`` false,
for each fault the cells can have (on the CPU at a tiny size; the look
for a card is skipped by running on the CPU).  No cell runs across
cards, so there is no exchange to leave out."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import TINY

CELLS = ["base.mem", "chem.mem", "base.hourly_nc"]


def _run(cell):
    return harness.run(cell, 2 ** 31 + 99, 0.2, False, device="cpu",
                       sizes=TINY)


def _break_step(monkeypatch, broken):
    from mptrac_tpu_torch.physics import pipeline
    orig = pipeline.run_timestep

    def run_timestep(ctl, clim, met01, atm, cache, t, *a, **k):
        new_atm, new_cache = orig(ctl, clim, met01, atm, cache, t, *a, **k)
        return broken(atm, cache, new_atm, new_cache)

    monkeypatch.setattr(pipeline, "run_timestep", run_timestep)


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_changes_nothing(cell, monkeypatch):
    _break_step(monkeypatch, lambda atm, cache, a2, c2: (atm, cache))
    out = _run(cell)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_parcels_left_out(cell, monkeypatch):
    def half(atm, cache, a2, c2):
        n = atm.lon.shape[0] // 2

        def mix(new, old):
            return torch.cat([new[..., :n], old[..., n:]], dim=-1)

        q = {k: mix(a2.q[k], atm.q[k]) for k in atm.q}
        return (a2.replace(time=mix(a2.time, atm.time),
                           lon=mix(a2.lon, atm.lon), lat=mix(a2.lat, atm.lat),
                           p=mix(a2.p, atm.p), q=q),
                c2.replace(uvwp=mix(c2.uvwp, cache.uvwp)))

    _break_step(monkeypatch, half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    """Every 16th parcel's longitude is off by 0.01 degree (~1 km)."""
    def altered(atm, cache, a2, c2):
        lon = a2.lon.clone()
        lon[::16] += 0.01
        return a2.replace(lon=lon), c2

    _break_step(monkeypatch, altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["pos_km"]["value"] > out["checks"]["pos_km"][
        "limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_sort_that_duplicates_a_parcel(cell, monkeypatch):
    from mptrac_tpu_torch import sim
    orig = sim.module_sort

    def bad_sort(met, atm, cache):
        a2, c2 = orig(met, atm, cache)
        lon = a2.lon.clone()
        lon[1] = lon[0]
        return a2.replace(lon=lon), c2

    monkeypatch.setattr(sim, "module_sort", bad_sort)
    out = _run(cell)
    assert not out["correct"] and out["checks"]["sort_bad"]["value"] > 0


def test_met_field_altered_in_ingest(monkeypatch):
    """A read whose boundary-layer pressure is off by 1 hPa."""
    from mptrac_tpu_torch import sim
    orig = sim.read_met

    def bad_read(*a, **k):
        met = orig(*a, **k)
        met.fields2d["pbl"] += 1.0
        return met

    monkeypatch.setattr(sim, "read_met", bad_read)
    out = _run("base.hourly_nc")
    assert not out["correct"]
    assert out["checks"]["met_rel"]["value"] > out["checks"]["met_rel"][
        "limit"]
