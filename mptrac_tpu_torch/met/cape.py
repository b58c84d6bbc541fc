"""CAPE/CIN/LCL/LFC/EL by adiabatic parcel ascent.

Vectorized-over-columns rebuild of the reference ``read_met_cape``
(mptrac.c:8862-8982): a bisection for the lifted
condensation level, then ~100 m log-pressure ascent steps accumulating
buoyancy, with all columns advanced in lockstep under termination
masks.
"""

from __future__ import annotations

import numpy as np

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import EPS, G0, H0, MA, P0, RA, RI
from mptrac_tpu_torch.climatology import clim_tropo_np
from mptrac_tpu_torch.utils.timers import span


def _tvirt(t, h2o):
    return t * (1.0 + (1.0 - EPS) * np.maximum(h2o, 0.1e-6))


def _psat(t):
    return 6.112 * np.exp(17.62 * (t - 273.15) / (243.12 + t - 273.15))


def _rh(p, t, h2o):
    h = np.maximum(h2o, 0.1e-6)
    pw = p * h / (1.0 + (1.0 - EPS) * h)
    return pw / _psat(t) * 100.0


def _sh(h2o):
    return EPS * np.maximum(h2o, 0.1e-6)


def _lapse_rate(t, h2o):
    """Moist adiabatic lapse rate [K/km] (reference lapse_rate,
    c:12332)."""
    LV, CPD = 2501000.0, 1003.5
    a = RA * t * t
    r = _sh(h2o) / (1.0 - _sh(h2o))
    return 1e3 * G0 * (a + LV * r * t) / (CPD * a + LV * LV * r * EPS)


def _interp_prof(field, p_levels, p_query):
    """Per-column vertical interpolation in the reference weight
    convention (descending p levels)."""
    npl = p_levels.size
    iz = np.clip(np.searchsorted(-p_levels, -p_query, side="left") - 1,
                 0, npl - 2)
    wz = (p_levels[iz + 1] - p_query) / (p_levels[iz + 1] - p_levels[iz])
    lo = np.take_along_axis(field, iz, axis=-1)
    hi = np.take_along_axis(field, iz + 1, axis=-1)
    return wz * (lo - hi) + hi


@span("process.compute_cape")
def compute_cape(ctl: Ctl, met_time: float, lon, lat, p, f2, f3) -> None:
    if ctl.met_cape != 1:
        return
    pfac = 1.01439
    dz0 = RI / MA / G0 * np.log(pfac)

    ps = f2["ps"].astype(np.float64)          # [nx, ny]
    t3 = f3["t"].astype(np.float64)
    h2o3 = f3["h2o"].astype(np.float64)
    nx, ny = ps.shape
    npl = p.size
    flatshape = (nx * ny,)
    psf = ps.reshape(-1)
    tf = t3.reshape(-1, npl)
    h2of = h2o3.reshape(-1, npl)

    # Mean theta/h2o over the lowest 50 hPa above the surface
    pbot = np.minimum(psf, p[0])
    ptop50 = pbot - 50.0
    use = p[None, :] <= pbot[:, None]
    # stop once p < ptop50 and n > 0 (scan order: include first level
    # below ptop50's boundary? reference breaks *before* adding when
    # p[ip] < ptop and n>0 — the level that triggered the break was
    # already added if it satisfied p <= pbot in the same iteration)
    # Reference order per ip: add if p<=pbot; then break if p<ptop & n>0.
    added = np.zeros_like(use)
    n = np.zeros(flatshape, np.int64)
    theta = np.zeros(flatshape)
    h2o = np.zeros(flatshape)
    done = np.zeros(flatshape, bool)
    for ip in range(npl):
        sel = (~done) & (p[ip] <= pbot)
        theta += np.where(sel, tf[:, ip] * (1000.0 / p[ip]) ** 0.286, 0.0)
        h2o += np.where(sel, h2of[:, ip], 0.0)
        n += sel
        done |= (p[ip] < ptop50) & (n > 0)
    theta /= np.maximum(n, 1)
    h2o /= np.maximum(n, 1)

    plcl = np.full(flatshape, np.nan)
    plfc = np.full(flatshape, np.nan)
    pel = np.full(flatshape, np.nan)
    cape = np.full(flatshape, np.nan)
    cin = np.full(flatshape, np.nan)
    ok = h2o > 0

    # LCL bisection (reference c:8913-8924)
    ptop_b = np.full(flatshape, P0 * np.exp(-20.0 / H0))
    pbot_b = psf.copy()
    for _ in range(64):
        if not np.any((pbot_b - ptop_b > 0.1) & ok):
            break
        mid = 0.5 * (pbot_b + ptop_b)
        t_mid = theta / (1000.0 / mid) ** 0.286
        super_sat = _rh(mid, t_mid, h2o) > 100.0
        act = (pbot_b - ptop_b > 0.1) & ok
        ptop_b = np.where(act & super_sat, mid, ptop_b)
        pbot_b = np.where(act & ~super_sat, mid, pbot_b)
        plcl = np.where(act, mid, plcl)
    plcl = np.where(ok, plcl, np.nan)

    # CIN up to LCL (c:8926-8944)
    cape_acc = np.zeros(flatshape)
    cin_acc = np.zeros(flatshape)
    pcur = psf.copy()
    t = theta / (1000.0 / plcl) ** 0.286  # placeholder; loop sets t
    t = np.where(ok, theta / (1000.0 / np.maximum(pcur, 1e-3)) ** 0.286, 0.0)
    active = ok.copy()
    for _ in range(2000):
        if not np.any(active):
            break
        dz = dz0 * _tvirt(t, h2o)
        pcur = np.where(active, pcur / pfac, pcur)
        t_new = theta / (1000.0 / np.maximum(pcur, 1e-3)) ** 0.286
        t = np.where(active, t_new, t)
        t_env = _interp_prof(tf, p, pcur[:, None])[:, 0]
        h2o_env = _interp_prof(h2of, p, pcur[:, None])[:, 0]
        dcape = (1e3 * G0 * (_tvirt(t, h2o) - _tvirt(t_env, h2o_env))
                 / _tvirt(t_env, h2o_env) * dz)
        cin_acc += np.where(active & (dcape < 0), np.abs(dcape), 0.0)
        active &= pcur > plcl

    # Ascent above LCL (c:8946-8976)
    pcur = plcl.copy()
    t = theta / (1000.0 / np.maximum(plcl, 1e-3)) ** 0.286
    h2o_a = h2o.copy()
    lat2d = np.broadcast_to(lat[None, :], (nx, ny)).reshape(-1)
    ref_lat = lat2d if ctl.met_coord_type == 0 else np.full(
        flatshape, ctl.met_utm_ref_lat)
    ptop_stop = 0.75 * np.array(
        [clim_tropo_np(None, float(met_time), la)
         for la in np.unique(ref_lat)])
    # map back per column
    uniq = np.unique(ref_lat)
    lut = {la: pt for la, pt in zip(uniq, ptop_stop)}
    ptop_col = np.array([lut[la] for la in ref_lat])

    dcape_prev = np.zeros(flatshape)
    active = ok.copy()
    for _ in range(4000):
        if not np.any(active):
            break
        dz = dz0 * _tvirt(t, h2o_a)
        pcur = np.where(active, pcur / pfac, pcur)
        t = np.where(active, t - _lapse_rate(t, h2o_a) * dz, t)
        psat = _psat(t)
        h2o_a = np.where(active, psat / (pcur - (1.0 - EPS) * psat), h2o_a)
        t_env = _interp_prof(tf, p, pcur[:, None])[:, 0]
        h2o_env = _interp_prof(h2of, p, pcur[:, None])[:, 0]
        dcape = (1e3 * G0 * (_tvirt(t, h2o_a) - _tvirt(t_env, h2o_env))
                 / _tvirt(t_env, h2o_env) * dz)
        pos = active & (dcape > 0)
        cape_acc += np.where(pos, dcape, 0.0)
        plfc = np.where(pos & ~np.isfinite(plfc), pcur, plfc)
        pel = np.where(active & (dcape <= 0) & (dcape_prev > 0), pcur, pel)
        cin_acc += np.where(active & (dcape < 0) & ~np.isfinite(plfc),
                            np.abs(dcape), 0.0)
        dcape_prev = np.where(active, dcape, dcape_prev)
        active &= pcur > ptop_col

    cape = np.where(ok, cape_acc, np.nan)
    cin = np.where(ok & np.isfinite(plfc), cin_acc, np.nan)

    f2["plcl"] = plcl.reshape(nx, ny).astype(np.float32)
    f2["plfc"] = plfc.reshape(nx, ny).astype(np.float32)
    f2["pel"] = pel.reshape(nx, ny).astype(np.float32)
    f2["cape"] = cape.reshape(nx, ny).astype(np.float32)
    f2["cin"] = cin.reshape(nx, ny).astype(np.float32)
