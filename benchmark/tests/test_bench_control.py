"""The control (the reference in bfloat16 in the program's place) fails
the limits of every cell: on the CPU at a tiny size, and on the card at
a size a test run holds."""

import pytest

from benchmark import control, manifest
from benchmark.tests.conftest import TINY

CELLS = ["base.mem", "chem.mem", "base.hourly_nc"]


def _fails(rec, limits):
    return any(v > limits[k] for k, v in rec["control"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    limits = manifest.workload(cell)["limits"]
    for rec in control.readings(cell, [5, 2 ** 31 + 6], 0.1, device="cpu",
                                sizes=TINY):
        assert rec["correct"], rec["program"]
        assert _fails(rec, limits), rec["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(cell, card):
    limits = manifest.workload(cell)["limits"]
    sizes = {"n_parcels": 1 << 22, "grid": {"nx": 360, "ny": 181,
                                            "nz": 61}}
    for rec in control.readings(cell, [21, 22, 23], 1.0, device="cuda",
                                sizes=sizes):
        assert rec["correct"], rec["program"]
        assert _fails(rec, limits), rec["control"]
