"""The chemistry step as a whole: ``pipeline.run_timestep`` with the
flagship's phys ``chem`` (convection, OH and H2O2 chemistry, wet and dry
deposition of SO2 on top of advection, diffusion and decay) in the port
against the JAX step, on the fused path (float32, the kernels' plain
versions on the CPU) and on the exact path in float32 and float64, four
steps with a sort before the third; the fused step is held to the JAX
fused step.

Two met pairs.  ``flagship``: the flagship's own synthetic wind, as
``__graft_entry__._make_setup(phys="chem")`` makes it (uniform T, no
clouds, CAPE 0 and equilibrium level 0, so convection takes every parcel
and H2O2 and wet deposition find no cloud), held to the tolerances of
``tests/test_torch_step.py`` (``_compare`` for the fused path,
``_compare_exact`` for the exact one).  ``weather``: the same wind with
temperature, clouds, CAPE, equilibrium level, boundary layer and cloud
top and bottom planted from a numpy seed, so that every module acts.
Those tolerances hold there too but for the mass (and T in float64),
which now depend on where a parcel is: see ``WEATHER_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from helpers.torch_bridge import met_to_numpy, to_torch
from test_torch_chem import _plant
from test_torch_step import _compare, _compare_exact
from mptrac_tpu.ops.fast_interp import build_met_pack as jbuild
from mptrac_tpu.ops.sort import module_sort as jsort
from mptrac_tpu.physics import pipeline as jpipe
from mptrac_tpu.types import astype_state
from mptrac_tpu_torch import flagship
from mptrac_tpu_torch.ops.fast_interp import build_met_pack as tbuild
from mptrac_tpu_torch.ops.sort import module_sort as tsort
from mptrac_tpu_torch.physics import pipeline as tpipe

NSTEPS = 4
SORT_AT = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: more intra-op threads would only spin, on the cores
    of the other test workers (module-wide, so that the module fixtures
    run on one thread too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: relative tolerances of m and T on the ``weather`` pair, after
#: ``steps`` steps, that replace those of test_torch_step.py.  float32:
#: the chemistry's losses are exp(-k dt) with k up to ~1.5/dt from pow
#: and exp of interpolated float32 fields (the wet deposition's
#: (cl/0.5)**(1/0.36) triples an ulp of cl), and the two math libraries
#: and XLA's multiply-add contraction differ by a few ulp there: m to
#: 1e-5 (measured 2.1e-6 after one step, 2.9e-6 after four).  float64:
#: the two sides' positions differ by the single-precision Box-Muller of
#: both (5e-9 deg a step, test_torch_step.py), and T, the clouds and the
#: rates vary from node to node on this pair: T to 1e-10 (measured
#: 1.1e-11), m to 1e-8 (measured 4.3e-10 after one step, 1.1e-9 after
#: four).
WEATHER_RTOL = {"fused": {"m": 1e-5},
                "exact-float64": {"m": 1e-8, "t": 1e-10}}


def stormy_setup(n=2048):
    """The JAX flagship with phys ``chem`` (float64), its met pair with
    clouds, CAPE, equilibrium level, boundary layer, cloud top and
    bottom, cloud water and a varying temperature planted into it."""
    ctl, clim, met01, atm, cache = g._make_setup(n, nx=36, ny=19, nz=8,
                                                 phys="chem")
    rng = np.random.default_rng(21)
    d = met_to_numpy(met01)
    s2 = d["fields2d"]["ps"].shape
    s3 = d["fields3d"]["t"].shape
    f2 = dict(d["fields2d"], pbl=_plant(rng, s2, 850, 1000),
              cape=_plant(rng, s2, 0, 2000, nan=0.1),
              cin=_plant(rng, s2, 0, 300, nan=0.2),
              pel=_plant(rng, s2, 150, 500, nan=0.3),
              pct=_plant(rng, s2, 150, 500, nan=0.2),
              pcb=_plant(rng, s2, 550, 950),
              cl=_plant(rng, s2, 0, 3, zero=0.2))
    f3 = dict(d["fields3d"], t=_plant(rng, s3, 250, 290))
    for name in ("lwc", "rwc", "iwc", "swc"):
        f3[name] = _plant(rng, s3, 0, 2e-4, zero=0.6)
    met01 = met01.replace(
        fields2d={k: jnp.asarray(v) for k, v in f2.items()},
        fields3d={k: jnp.asarray(v) for k, v in f3.items()})
    return ctl, clim, met01, atm, cache


@pytest.fixture(scope="module", params=[
    ("flagship", "fused"), ("flagship", "exact-float32"),
    ("flagship", "exact-float64"), ("weather", "fused"),
    ("weather", "exact-float64")], ids=lambda p: "-".join(p))
def chem_runs(request):
    met, mode = request.param
    if met == "weather":
        ctl, clim, met01, atm, cache = stormy_setup()
    else:
        ctl, clim, met01, atm, cache = g._make_setup(2048, nx=36, ny=19,
                                                     nz=8, phys="chem")
    if mode != "exact-float64":
        atm, cache, met01, clim = astype_state(atm, cache, met01, clim)
    tatm, tcache, tmet, tclim = to_torch(atm, cache, met01, clim)
    dtype = torch.float64 if mode == "exact-float64" else torch.float32
    tctl = flagship.make_setup(atm.npmax, nx=36, ny=19, nz=8, device="cpu",
                               dtype=dtype, phys="chem")[0]
    jpack = tpack = None
    if mode == "fused":
        jpack, tpack = jbuild(met01, cell=True), tbuild(tmet, cell=True)
    jstates, tstates = [(atm, cache)], [(tatm, tcache)]
    for i in range(1, NSTEPS + 1):
        t = 180.0 * i
        if i == SORT_AT:
            atm, cache = jax.jit(jsort)(met01, atm, cache)
            tatm, tcache = tsort(tmet, tatm, tcache)
        atm, cache = jpipe.run_timestep(ctl, clim, met01, atm, cache,
                                        jnp.asarray(t, jnp.float64),
                                        pack=jpack)
        tatm, tcache = tpipe.run_timestep(tctl, tclim, tmet, tatm, tcache,
                                          t, pack=tpack)
        jstates.append((atm, cache))
        tstates.append((tatm, tcache))
    return (met, mode), jstates, tstates


def _check(case, jstate, tstate, steps):
    """The step tests' comparison; on the ``weather`` pair m (and T) at
    WEATHER_RTOL, and the JAX side's copies of them replaced by the
    port's for the rest of the comparison."""
    met, mode = case
    (ja, jc), (ta, tc) = jstate, tstate
    if met == "weather":
        q = dict(ja.q)
        for name, rtol in WEATHER_RTOL[mode].items():
            got, want = ta.q[name].numpy(), np.asarray(ja.q[name])
            np.testing.assert_allclose(got, want, rtol=rtol * steps, atol=0,
                                       err_msg=name)
            q[name] = jnp.asarray(got)
        ja = ja.replace(q=q)
    if mode == "fused":
        _compare((ja, jc), (ta, tc), atol_pos=6.2e-5 * steps,
                 atol_uvwp=5e-4 * steps)
    else:
        _compare_exact(mode.split("-")[1], (ja, jc), (ta, tc), steps)


def test_chem_one_step(chem_runs):
    case, js, ts = chem_runs
    _check(case, js[1], ts[1], 1)


def test_chem_four_steps_with_sort(chem_runs):
    """Four steps; the chemistry acted: mass lost beyond the decay (OH,
    H2O2, wet and dry deposition), the counter advanced by the
    convection's uniform draws too."""
    case, js, ts = chem_runs
    _check(case, js[NSTEPS], ts[NSTEPS], NSTEPS)
    a, c = ts[NSTEPS]
    n = a.npmax
    # per step: 2 x (3n + 1) normals of the diffusion, n + 1 uniforms
    assert c.rng_ctr == NSTEPS * (2 * (3 * n + 1) + n + 1)
    decay = np.exp(-180.0 / 259200.0) ** NSTEPS
    m = a.q["m"].to(torch.float64).numpy()
    assert float(m.min()) < decay * (1.0 - 1e-4)
    assert float(np.median(m)) < decay
