"""Model-level and zeta/eta advection of the port against the JAX
package: the CLaMS-convention met of ``parity/golden_zeta``, the column
interpolation ``ops.interp.interp_4d_zeta``, one step of each vertical
coordinate and RK scheme, ``module_advect_init``, and golden_zeta end to
end through the port's ``run_trac``.

Tolerances.  The met is the same array for array (both sides run the
same numpy preprocessing).  ``interp_4d_zeta`` and ``module_advect_init``
do the same float64 operations in the same order on both sides (the
port probes the levels of a binary search, the JAX package interpolates
the whole column and counts): rtol 1e-12, atol 0; measured 0.  The
float64 step (``TPU_FAST 0``) is held at rtol 1e-12 on every column it
writes.  The float32 step (``TPU_FAST 1``: the JAX package on its w64
pack, the port on the unfused kernels' plain versions) computes the
model-level interpolation in float64 on both sides and then rounds: the
JAX step carries the float64 result into the state (its ``where``
promotes), the port rounds it to the state's float32; positions agree
to a float32 rounding of the position, quantities to one of theirs.
golden_zeta is held at ``tests/test_zeta_parity.py``'s tolerances.
"""

import os
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_bridge import to_torch
from mptrac_tpu.climatology import read_clim as jread_clim
from mptrac_tpu.config import read_ctl as jread_ctl
from mptrac_tpu.met.build import read_met as jread_met
from mptrac_tpu.ops import interp as jinterp
from mptrac_tpu.ops.fast_interp import build_met_pack as jbuild
from mptrac_tpu.physics import advect as jadvect
from mptrac_tpu.physics import pipeline as jpipe
from mptrac_tpu.types import Atm as JAtm
from mptrac_tpu.types import Cache as JCache
from mptrac_tpu.types import astype_state as jastype
from mptrac_tpu.types import stack_met as jstack
from mptrac_tpu_torch.climatology import read_clim as tread_clim
from mptrac_tpu_torch.config import read_ctl as tread_ctl
from mptrac_tpu_torch.met.build import read_met as tread_met
from mptrac_tpu_torch.ops import interp as tinterp
from mptrac_tpu_torch.physics import advect as tadvect
from mptrac_tpu_torch.physics import pipeline as tpipe
from mptrac_tpu_torch.sim import build_pack, run_trac
from mptrac_tpu_torch.types import astype_state as tastype
from test_full_parity import assert_tab_close

GOLD = pathlib.Path(__file__).resolve().parents[1] / "parity" / \
    "golden_zeta" / "data"
FILES = ("clams_16070100.nc", "clams_16070106.nc")
T0 = 520646400.0
NPMAX = 640
NP = 600
RTOL = 1e-12
#: the float64 step: the turbulent diffusion's float64 arithmetic, as
#: tests/test_torch_step.py holds the exact step
F64_ATOL = dict(lon=5e-9, lat=5e-9, p=5e-8)
#: the float32 step: a float32 rounding of a position, of a quantity
F32_ATOL = dict(lon=2e-5, lat=1e-5, p=1e-4, zeta=1e-4)
F32_RTOL = 3e-7
#: diffusion on (the golden control file zeroes it), so the step runs
#: the surface and sigma kernels on the unfused path
DIFFUSION = ("DIFFUSION", "1", "TURB_DX_TROP", "50", "TURB_DZ_TROP", "0",
             "TURB_DX_STRAT", "0", "TURB_DZ_STRAT", "0.1",
             "TURB_MESOX", "0.16", "TURB_MESOZ", "0.16")


QNT = ("m", "zeta", "eta", "theta", "ps", "p")


def _args(extra=()):
    args = list(extra) + ["NQ", str(len(QNT)), "METBASE", "-"]
    for i, name in enumerate(QNT):
        args += [f"QNT_NAME[{i}]", name]
    return args


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of parcels: more intra-op threads would only spin, on the
    cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mets():
    """The golden met pair as both packages read it."""
    jctl = jread_ctl(str(GOLD / "trac.ctl"), _args())
    tctl = tread_ctl(str(GOLD / "trac.ctl"), _args())
    jclim, tclim = jread_clim(jctl), tread_clim(tctl, device="cpu")
    jm = [jread_met(str(GOLD / f), jctl, jclim) for f in FILES]
    tm = [tread_met(str(GOLD / f), tctl, tclim, device="cpu")
          for f in FILES]
    return dict(jctl=jctl, tctl=tctl, jclim=jclim, tclim=tclim, jm=jm,
                tm=tm, jmet=jstack(*jm))


def test_golden_zeta_met_matches_jax(mets):
    """The met that the port builds from the CLaMS files: every field,
    axis and time of both snapshots, after the monotonization of zetal
    and pl (``met/process.monotonize``)."""
    for jm, tm in zip(mets["jm"], mets["tm"]):
        assert float(jm.time) == float(tm.time)
        assert jm.npl_ml == tm.npl_ml == 30
        for name in ("lon", "lat", "p", "hybrid"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        assert set(tm.fields3d) == set(jm.fields3d)
        for name in ("zetal", "zeta_dotl", "pl", "ul", "vl", "wl", "u",
                     "v", "w", "t"):
            np.testing.assert_array_equal(tm.fields3d[name].numpy(),
                                          np.asarray(jm.fields3d[name]),
                                          err_msg=name)
        zetal = tm.fields3d["zetal"].numpy()
        pl = tm.fields3d["pl"].numpy()
        assert (np.diff(zetal, axis=-1) >= 0).all()
        assert (np.diff(pl, axis=-1) <= 0).all()
        for name in tm.fields2d:
            np.testing.assert_array_equal(tm.fields2d[name].numpy(),
                                          np.asarray(jm.fields2d[name]),
                                          err_msg=name)


def _planted_met(mets):
    """The golden pair with columns that tie or fall out of order: four
    blocks of 2x2 columns (both snapshots, so every parcel in the block's
    cell sees the same in its interpolated column).  Returns the JAX
    pair, the port's pair and the lower corner of each block."""
    d = {k: np.array(v) for k, v in mets["jmet"].fields3d.items()}
    blocks = dict(bottom=(3, 5), middle=(10, 8), top=(20, 12),
                  swapped=(30, 20))
    for name, (ix, iy) in blocks.items():
        sl = (slice(None), slice(ix, ix + 2), slice(iy, iy + 2))
        z, p = d["zetal"][sl], d["pl"][sl]
        if name == "bottom":          # levels 0 and 1 tie
            z[..., 1] = z[..., 0]
            p[..., 1] = p[..., 0]
        elif name == "middle":        # levels 10, 11, 12 tie
            z[..., 11] = z[..., 12] = z[..., 10]
            p[..., 11] = p[..., 12] = p[..., 10]
        elif name == "top":           # the last two levels tie
            z[..., -1] = z[..., -2]
            p[..., -1] = p[..., -2]
        else:                         # levels 15, 16 out of order
            z[..., 16] = z[..., 15] * (1.0 - 1e-7)
            p[..., 16] = p[..., 15] * (1.0 + 1e-7)
        d["zetal"][sl], d["pl"][sl] = z, p
    jmet = mets["jmet"].replace(
        fields3d={k: jnp.asarray(v) for k, v in d.items()})
    _, _, tmet, _ = to_torch(met01=jmet)
    return jmet, tmet, blocks


def _column_parcels(rng, jmet, blocks, name):
    """Parcels in each block's cell and elsewhere, with heights below,
    inside and above the columns, on a level's value and NaN."""
    lon = np.asarray(jmet.lon[0])
    lat = np.asarray(jmet.lat[0])
    f = np.asarray(jmet.fields3d[name])
    lo, hi = float(np.nanmin(f)), float(np.nanmax(f))
    pts = []
    for ix, iy in list(blocks.values()) + [(50, 25), (0, 0), (71, 35)]:
        n = 40
        plon = rng.uniform(lon[ix], lon[ix + 1], n)
        plat = rng.uniform(lat[iy], lat[iy + 1], n)
        h = rng.uniform(lo, hi, n)
        h[0], h[1], h[2] = lo - 0.1 * abs(lo), hi + 0.1 * abs(hi), np.nan
        h[3:8] = f[0, ix, iy, [0, 1, 10, 11, 28]]
        pts.append((plon, plat, h))
    lon_, lat_, h_ = (np.concatenate(a) for a in zip(*pts))
    t = T0 + rng.uniform(0.0, 21600.0, lon_.size)
    t[:3] = (T0, T0 + 21600.0, T0 + 10800.0)
    return t, h_, lon_, lat_


@pytest.mark.parametrize("heights,array", [
    ("zetal", "ul"), ("zetal", "pl"), ("zetal", "zeta_dotl"),
    ("pl", "zetal"), ("pl", "wl")])
def test_interp_4d_zeta(mets, heights, array):
    """Ascending (zetal) and descending (pl) columns, heights below,
    inside and above them, on a level, NaN; columns whose levels tie at
    the bottom (so locate_irr's direction rule reads the column as
    descending), in the middle and at the top, and a column out of
    order by one rounding."""
    rng = np.random.default_rng(5)
    jmet, tmet, blocks = _planted_met(mets)
    t, h, lon, lat = _column_parcels(rng, jmet, blocks, heights)
    want = np.asarray(jinterp.interp_4d_zeta(
        jmet, heights, array, jnp.asarray(t), jnp.asarray(h),
        jnp.asarray(lon), jnp.asarray(lat)))
    got = tinterp.interp_4d_zeta(
        tmet, heights, array, torch.from_numpy(t), torch.from_numpy(h),
        torch.from_numpy(lon), torch.from_numpy(lat))
    assert got.dtype == torch.float64
    got = got.numpy()
    assert np.isfinite(want).sum() > 0.9 * want.size
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)
    # the level index itself, against the JAX count on the column
    loc = tinterp.locate_zeta(tmet, heights, torch.from_numpy(t),
                              torch.from_numpy(h), torch.from_numpy(lon),
                              torch.from_numpy(lat))
    npl = tmet.npl_ml
    assert int(loc.iz.min()) >= 0 and int(loc.iz.max()) <= npl - 2
    assert int(loc.iz[2::40].max()) == 0        # NaN heights: cell 0


def test_interp_4d_zeta_float32_positions(mets):
    """Float32 positions and heights (the kernels' state): computed in
    float64 all the same, as the JAX function's default dtype."""
    rng = np.random.default_rng(6)
    jmet, tmet, blocks = _planted_met(mets)
    t, h, lon, lat = _column_parcels(rng, jmet, blocks, "zetal")
    h, lon, lat = (a.astype(np.float32) for a in (h, lon, lat))
    jm32 = jastype(met=jmet)
    tm32 = tastype(met=tmet)
    want = np.asarray(jinterp.interp_4d_zeta(
        jm32, "zetal", "pl", jnp.asarray(t), jnp.asarray(h),
        jnp.asarray(lon), jnp.asarray(lat)))
    got = tinterp.interp_4d_zeta(
        tm32, "zetal", "pl", torch.from_numpy(t), torch.from_numpy(h),
        torch.from_numpy(lon), torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)


def _state(mets, rng):
    """(JAX atm, JAX cache) of NPMAX parcels inside the golden met's
    columns, with zeta and eta taken from the met at their pressure."""
    jmet = mets["jmet"]
    lon = rng.uniform(-180.0, 180.0, NPMAX)
    lat = rng.uniform(-85.0, 85.0, NPMAX)
    p = np.exp(rng.uniform(np.log(20.0), np.log(900.0), NPMAX))
    time = np.full(NPMAX, T0 + 3600.0 - 180.0)
    zeta = np.asarray(jinterp.interp_4d_zeta(
        jmet, "pl", "zetal", jnp.asarray(time), jnp.asarray(p),
        jnp.asarray(lon), jnp.asarray(lat)))
    q = {name: np.zeros(NPMAX) for name in QNT}
    q.update(m=rng.uniform(0.5, 2.0, NPMAX), zeta=zeta, eta=zeta.copy())
    atm = JAtm(time=jnp.asarray(time), p=jnp.asarray(p),
               lon=jnp.asarray(lon), lat=jnp.asarray(lat),
               q={k: jnp.asarray(v) for k, v in q.items()},
               np=jnp.asarray(NP, jnp.int32))
    cache = JCache.zeros(NPMAX, iso_npmax=1).replace(
        rng_ctr=jnp.asarray(777, jnp.uint64))
    return atm, cache


def test_module_advect_init(mets):
    """Pressure from each parcel's zeta (ADVECT_VERT_COORD 1 only; the
    dead parcels keep theirs)."""
    rng = np.random.default_rng(8)
    ja, _ = _state(mets, rng)
    ja = ja.replace(q=dict(ja.q, zeta=ja.q["zeta"] * 1.01))
    ta, _, tmet, _ = to_torch(atm=ja, met01=mets["jmet"])
    for vert in (0, 1, 2, 3):
        jctl = mets["jctl"].replace(advect_vert_coord=vert)
        tctl = mets["tctl"].replace(advect_vert_coord=vert)
        want = jadvect.module_advect_init(jctl, mets["jmet"], ja)
        got = tadvect.module_advect_init(tctl, tmet, ta)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                                   rtol=RTOL, atol=0)
        changed = not np.array_equal(got.p.numpy(), np.asarray(ja.p))
        assert changed == (vert == 1)
    assert torch.equal(got.p[NP:], ta.p[NP:])
    ta2 = ta.replace(q={"m": ta.q["m"]})
    assert tadvect.module_advect_init(
        mets["tctl"].replace(advect_vert_coord=1), tmet, ta2) is ta2


@pytest.mark.parametrize("advect", [1, 2, 4])
@pytest.mark.parametrize("vert", [1, 2, 3])
@pytest.mark.parametrize("mode", ["float64", "float32"])
def test_one_step(mets, monkeypatch, mode, vert, advect):
    """One ``run_timestep`` with ADVECT_VERT_COORD 1 (zeta), 2 (omega on
    model levels) and 3 (eta) under Euler, midpoint and RK4, with the
    turbulent and mesoscale diffusion on: float64 on the exact path
    (``TPU_FAST 0``), float32 on the unfused kernels (``TPU_FAST 1``:
    the advection is the exact model-level one, the diffusion reads the
    surface and sigma tables).

    In float32 the JAX step's ``where`` would carry the float64 result
    of the model-level interpolation into the state, and the diffusion
    would then draw float64 random numbers, another stream than the
    float32 one.  The test rounds the JAX advection's output to the
    state's float32, as the port's advection does, so both steps draw
    the same numbers."""
    rng = np.random.default_rng(100 * vert + advect)
    if mode == "float32":
        advect_f64 = jpipe.m_advect.module_advect

        def advect_in_state_dtype(ctl, cache, met01, atm, *a, **k):
            out, cache = advect_f64(ctl, cache, met01, atm, *a, **k)
            return out.replace(
                lon=out.lon.astype(atm.lon.dtype),
                lat=out.lat.astype(atm.lat.dtype),
                p=out.p.astype(atm.p.dtype),
                q={n: v.astype(atm.q[n].dtype) for n, v in out.q.items()}
            ), cache

        monkeypatch.setattr(jpipe.m_advect, "module_advect",
                            advect_in_state_dtype)
    fast = "0" if mode == "float64" else "1"
    args = _args(("ADVECT", str(advect), "ADVECT_VERT_COORD", str(vert),
                  "TPU_FAST", fast) + DIFFUSION)
    jctl = jread_ctl(str(GOLD / "trac.ctl"), args)
    tctl = tread_ctl(str(GOLD / "trac.ctl"), args)
    ja, jc = _state(mets, rng)
    jmet, jclim = mets["jmet"], mets["jclim"]
    ta, tc, tmet, tclim = to_torch(ja, jc, jmet, jclim)
    jpack = tpack = None
    if mode == "float32":
        ja, jc, jmet, jclim = jastype(ja, jc, jmet, jclim)
        ta, tc, tmet, tclim = tastype(ta, tc, tmet, tclim)
        jpack = jbuild(jmet)
        tpack = build_pack(tctl, tmet)
        assert tpack.cell is None and tpack.packT is not None
        assert tpack.sigT is not None and tpack.sfcT is not None
    t = T0 + 3600.0
    jn, _ = jpipe.run_timestep(jctl, jclim, jmet, ja, jc,
                               jnp.asarray(t, jnp.float64), pack=jpack)
    tn, _ = tpipe.run_timestep(tctl, tclim, tmet, ta, tc, t, pack=tpack)
    qnt = "zeta" if vert == 1 else "eta"
    moved = np.abs(tn.lon.numpy()[:NP] - ta.lon.numpy()[:NP]) > 0
    assert moved.mean() > 0.5
    np.testing.assert_array_equal(tn.time.numpy(), np.asarray(jn.time))
    for name in ("lon", "lat", "p", qnt):
        got = (getattr(tn, name) if name in ("lon", "lat", "p")
               else tn.q[name]).numpy()
        want = np.asarray(getattr(jn, name) if name in ("lon", "lat", "p")
                          else jn.q[name])
        if mode == "float64":
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=F64_ATOL.get(name, 0.0),
                                       err_msg=name)
        else:
            assert got.dtype == np.float32, name
            np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                       atol=F32_ATOL.get(name, 1e-4),
                                       err_msg=name)
    if vert == 2:
        np.testing.assert_array_equal(tn.q[qnt].numpy(), ta.q[qnt].numpy())


def test_build_pack_skips_the_fused_kernel_off_pressure_levels(mets):
    """``TPU_FAST 2`` with ``SORT_DT``: the fused kernel's tables on
    pressure levels only; with zeta advection the unfused tables, which
    the diffusion reads (the JAX step takes the fused kernel only for
    ADVECT_VERT_COORD 0)."""
    tmet = tastype(met=to_torch(met01=mets["jmet"])[2])
    ctl = mets["tctl"].replace(tpu_fast=2, sort_dt=900.0, diffusion=1,
                               turb_mesox=0.16)
    assert build_pack(ctl.replace(advect_vert_coord=0), tmet).cell \
        is not None
    for vert in (1, 2, 3):
        pack = build_pack(ctl.replace(advect_vert_coord=vert), tmet)
        assert pack.cell is None and pack.packT is not None
        assert pack.sigT is not None


def test_golden_zeta_end_to_end(tmp_path):
    """The port's ``run_trac`` on a copy of ``parity/golden_zeta`` (120
    steps of diabatic zeta advection, 819 parcels) on the CPU, held at
    ``tests/test_zeta_parity.py``'s tolerances."""
    data = tmp_path / "data"
    data.mkdir()
    for f in GOLD.glob("clams_*.nc"):
        shutil.copy(f, data / f.name)
    for f in ("trac.ctl", "atm_init.tab"):
        shutil.copy(GOLD / f, data / f)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = run_trac("data", "trac.ctl", "atm_init.tab",
                       ("ATM_BASENAME", "atm"), device="cpu")
    finally:
        os.chdir(cwd)
    assert sim.ctl.advect_vert_coord == 1 and sim.atm.np == 819
    assert sim.timers.as_dict()["RUN_TIMESTEP"]["count"] == 121
    for stamp in ("00_00_00", "03_00_00", "06_00_00"):
        f = f"atm_2016_07_01_{stamp}.tab"
        assert_tab_close(
            data / f, GOLD / f,
            col_tol={0: (0, 0), 1: (0, 1e-4), 2: (0, 1e-4), 3: (0, 1e-4)},
            default=(1e-4, 1e-4))
