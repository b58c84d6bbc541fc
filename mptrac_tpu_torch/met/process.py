"""Meteo preprocessing chain.

Host-side numpy rebuild of the derived-field chain applied after every
meteo read (reference mptrac.c:7480-7530):
extrapolate -> polar winds -> periodic boundary -> downsampling ->
geopotential -> PV -> PBL -> tropopause -> clouds -> CAPE -> ozone ->
detrend -> monotonize.  Runs once per met file (I/O bound), so plain
vectorized numpy is used; the results are uploaded to device as float32
arrays in a :class:`Met`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import EPS, G0, H0, MA, MO3, P0, RA, RE, RI
from mptrac_tpu_torch.utils.timers import span

_DEG2RAD = np.pi / 180.0


def _theta(p, t):
    return t * (1000.0 / p) ** 0.286


def _zdiff(lnp0, t0, h2o0, lnp1, t1, h2o1):
    tv0 = t0 * (1.0 + (1.0 - EPS) * np.maximum(h2o0, 0.1e-6))
    tv1 = t1 * (1.0 + (1.0 - EPS) * np.maximum(h2o1, 0.1e-6))
    return RI / MA / G0 * 0.5 * (tv0 + tv1) * (lnp0 - lnp1)


@span("process.extrapolate")
def extrapolate(f3: Dict[str, np.ndarray]) -> None:
    """Fill below-surface levels downward from the lowest valid level
    (reference read_met_extrapolate, c:9146).  Level 0 is the surface
    (descending pressure)."""
    t, u, v, w = f3["t"], f3["u"], f3["v"], f3["w"]
    valid = (np.isfinite(t) & np.isfinite(u) & np.isfinite(v)
             & np.isfinite(w))                       # [nx, ny, np]
    npl = t.shape[-1]
    # ip0 = highest index (from bottom) that is invalid; all ip <= ip0
    # get the value from ip0+1.  Equivalent: for each level ip, find the
    # lowest valid level jp >= ip scanning down, i.e. the first index
    # >= ip from which all following are valid.
    inv_any_below = np.cumsum(~valid[..., ::-1], axis=-1)[..., ::-1]
    # src index: smallest jp such that levels jp.. are all valid
    src = np.argmax(inv_any_below == 0, axis=-1)     # [nx, ny]
    lev = np.arange(npl)
    take = np.maximum(lev[None, None, :], src[..., None])
    for name in ("t", "u", "v", "w", "h2o", "o3", "lwc", "rwc", "iwc",
                 "swc", "cc"):
        f3[name] = np.take_along_axis(f3[name], take, axis=-1)


@span("process.polar_winds")
def polar_winds(lon, lat, f3, coord_type: int) -> None:
    """Average the 89-deg winds into pole rows (reference
    read_met_polar_winds, c:11451)."""
    if coord_type != 0:
        return
    if abs(lat[0]) < 89.999 or abs(lat[-1]) < 89.999:
        return
    nx = lon.size
    u, v = f3["u"], f3["v"]
    for i89, i90 in ((1, 0), (lat.size - 2, lat.size - 1)):
        sign = -1.0 if lat[i90] < 0 else 1.0
        clon = np.cos(sign * _DEG2RAD * lon)[:, None]   # [nx,1]
        slon = np.sin(sign * _DEG2RAD * lon)[:, None]
        u89 = u[:, i89, :]
        v89 = v[:, i89, :]
        velx = np.sum(u89 * clon - v89 * slon, axis=0) / nx  # [np]
        vely = np.sum(u89 * slon + v89 * clon, axis=0) / nx
        u[:, i90, :] = (velx[None, :] * clon + vely[None, :] * slon)
        v[:, i90, :] = (-velx[None, :] * slon + vely[None, :] * clon)


@span("process.periodic")
def periodic(lon, f2, f3):
    """Append a wraparound longitude column on global grids (reference
    read_met_periodic, c:11390).  Returns the (possibly extended) lon."""
    if not abs(lon[-1] - lon[0] + lon[1] - lon[0] - 360.0) < 0.01:
        return lon, f2, f3
    lon = np.append(lon, lon[-1] + lon[1] - lon[0])
    for d in (f2, f3):
        for k in list(d):
            d[k] = np.concatenate([d[k], d[k][:1]], axis=0)
    return lon, f2, f3


@span("process.geopot")
def geopot(ctl: Ctl, lon, lat, p, f2, f3) -> None:
    """Hydrostatic geopotential heights + horizontal smoothing
    (reference read_met_geopot, c:9186)."""
    t = f3["t"].astype(np.float64)
    h2o = f3["h2o"].astype(np.float64)
    ps = f2["ps"].astype(np.float64)          # [nx, ny]
    zs = f2["zs"].astype(np.float64)
    npl = p.size
    logp = np.log(p)
    lnps = np.log(ps)

    # Surface values by linear-in-p interpolation at ps
    ip0 = _locate_irr_vec(p, ps)                            # [nx, ny]
    p_lo = p[ip0]
    p_hi = p[ip0 + 1]
    w = (ps - p_lo) / (p_hi - p_lo)
    ts = np.take_along_axis(t, ip0[..., None], -1)[..., 0] * (1 - w) + \
        np.take_along_axis(t, ip0[..., None] + 1, -1)[..., 0] * w
    h2os = np.take_along_axis(h2o, ip0[..., None], -1)[..., 0] * (1 - w) + \
        np.take_along_axis(h2o, ip0[..., None] + 1, -1)[..., 0] * w

    z = np.empty_like(t)
    # Cumulative hypsometric integration relative to the surface.
    # Reference anchors both directions at (lnps, ts, h2os).
    # Level-to-level increments:
    dz_up = _zdiff(logp[:-1][None, None, :], t[..., :-1], h2o[..., :-1],
                   logp[1:][None, None, :], t[..., 1:], h2o[..., 1:])
    cum = np.concatenate(
        [np.zeros_like(t[..., :1]), np.cumsum(dz_up, axis=-1)], axis=-1)
    # Anchor: z at level ip0+1 = zs + zdiff(surface -> ip0+1); and
    # z[ip0] = zs + zdiff(surface -> ip0) (a downward step).
    z_anchor_hi = zs + _zdiff(
        lnps, ts, h2os,
        logp[ip0 + 1],
        np.take_along_axis(t, ip0[..., None] + 1, -1)[..., 0],
        np.take_along_axis(h2o, ip0[..., None] + 1, -1)[..., 0])
    cum_at_hi = np.take_along_axis(cum, ip0[..., None] + 1, -1)[..., 0]
    z = z_anchor_hi[..., None] + (cum - cum_at_hi[..., None])
    # Below-anchor part: reference anchors z[ip0] separately from the
    # surface, then steps down with the same increments; the cumulative
    # form is identical because zdiff is additive in lnp, except for the
    # separate surface anchor of the downward branch:
    z_anchor_lo = zs + _zdiff(
        lnps, ts, h2os, logp[ip0],
        np.take_along_axis(t, ip0[..., None], -1)[..., 0],
        np.take_along_axis(h2o, ip0[..., None], -1)[..., 0])
    cum_at_lo = np.take_along_axis(cum, ip0[..., None], -1)[..., 0]
    lev = np.arange(npl)[None, None, :]
    below = lev <= ip0[..., None]
    z_below = z_anchor_lo[..., None] + (cum - cum_at_lo[..., None])
    z = np.where(below, z_below, z)
    f3["z"] = z.astype(np.float32)

    # Horizontal smoothing
    dx, dy = ctl.met_geopot_sx, ctl.met_geopot_sy
    if dx == 0 or dy == 0:
        return
    if dx < 0 or dy < 0:
        if abs(lon[1] - lon[0]) < 0.5:
            dx, dy = 3, 2
        else:
            dx, dy = 6, 4
    f3["z"] = _smooth_xy(f3["z"], dx, dy).astype(np.float32)


def _smooth_xy(z, dx, dy):
    """Triangular-weight horizontal smoothing with periodic lon wrap
    (reference c:9263-9305)."""
    nx, ny = z.shape[:2]
    res = np.zeros_like(z, np.float64)
    wsum = np.zeros_like(z, np.float64)
    for ox in range(-dx + 1, dx):
        wx = 1.0 - abs(ox) / dx
        zx = np.roll(z, -ox, axis=0)
        for oy in range(-dy + 1, dy):
            w = wx * (1.0 - abs(oy) / dy)
            # latitude clamp: shifted-out rows don't contribute
            if oy >= 0:
                sl = zx[:, oy:, :]
                tgt = np.s_[:, : ny - oy, :]
            else:
                sl = zx[:, : ny + oy, :]
                tgt = np.s_[:, -oy:, :]
            ok = np.isfinite(sl)
            res[tgt] += np.where(ok, sl, 0.0) * w
            wsum[tgt] += ok * w
    out = np.where(wsum > 0, res / np.maximum(wsum, 1e-30), np.nan)
    return out


def _locate_irr_vec(xx: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized reference locate_irr (ascending or descending)."""
    n = xx.size
    if xx[1] > xx[0]:
        i = np.searchsorted(xx, x, side="right") - 1
    else:
        i = np.searchsorted(-xx, -x, side="left") - 1
    return np.clip(i, 0, n - 2).astype(np.int64)


@span("process.pv")
def pv(lon, lat, p, f3, coord_type: int) -> None:
    """Potential vorticity by centered differences (reference
    read_met_pv, c:11513)."""
    t = f3["t"].astype(np.float64)
    u = f3["u"].astype(np.float64)
    v = f3["v"].astype(np.float64)
    nx, ny, npl = t.shape
    pows = (1000.0 / p) ** 0.286

    ix = np.arange(nx)
    ix0 = np.maximum(ix - 1, 0)
    ix1 = np.minimum(ix + 1, nx - 1)
    iy = np.arange(ny)
    iy0 = np.maximum(iy - 1, 0)
    iy1 = np.minimum(iy + 1, ny - 1)
    latr = 0.5 * (lat[iy1] + lat[iy0])                    # [ny]

    if coord_type == 0:
        dxm = 1000.0 * (RE * _DEG2RAD * (lon[ix1] - lon[ix0])[:, None]
                        * np.cos(_DEG2RAD * latr)[None, :])   # [nx, ny]
        dym = 1000.0 * (RE * _DEG2RAD * (lat[iy1] - lat[iy0]))  # [ny]
        c0 = np.cos(_DEG2RAD * lat[iy0])
        c1 = np.cos(_DEG2RAD * lat[iy1])
        cr = np.cos(_DEG2RAD * latr)
        vort = 2 * 7.2921e-5 * np.sin(_DEG2RAD * latr)
    else:
        dxm = np.broadcast_to((lon[ix1] - lon[ix0])[:, None], (nx, ny)).copy()
        dym = lat[iy1] - lat[iy0]
        c0 = c1 = cr = np.ones(ny)
        vort = 2 * 7.2921e-5 * np.sin(latr / (RE * 1000.0))

    tp = t * pows[None, None, :]
    dtdx = (tp[ix1] - tp[ix0]) / dxm[..., None]
    dvdx = (v[ix1] - v[ix0]) / dxm[..., None]
    dtdy = (tp[:, iy1] - tp[:, iy0]) / dym[None, :, None]
    dudy = (u[:, iy1] * c1[None, :, None]
            - u[:, iy0] * c0[None, :, None]) / dym[None, :, None]

    ip = np.arange(npl)
    ip0 = np.maximum(ip - 1, 0)
    ip1 = np.minimum(ip + 1, npl - 1)
    dp0 = 100.0 * (p - p[ip0])
    dp1 = 100.0 * (p[ip1] - p)
    interior = (ip != ip0) & (ip != ip1)

    def ddp(f):
        denom3 = dp0 * dp1 * (dp0 + dp1)
        centered = (dp0 ** 2 * f[..., ip1] - dp1 ** 2 * f[..., ip0]
                    + (dp1 ** 2 - dp0 ** 2) * f) / np.where(
                        interior, denom3, 1.0)
        edge = (f[..., ip1] - f[..., ip0]) / (dp0 + dp1)
        return np.where(interior[None, None, :], centered, edge)

    dtdp = ddp(tp)
    dudp = ddp(u)
    dvdp = ddp(v)

    pv_ = 1e6 * G0 * (
        -dtdp * (dvdx - dudy / cr[None, :, None] + vort[None, :, None])
        + dvdp * dtdx - dudp * dtdy)
    # Polar fix
    if ny >= 3:
        pv_[:, 0, :] = pv_[:, 1, :] = pv_[:, 2, :]
        pv_[:, -1, :] = pv_[:, -2, :] = pv_[:, -3, :]
    f3["pv"] = pv_.astype(np.float32)


@span("process.pbl")
def pbl(ctl: Ctl, lon, lat, p, f2, f3) -> None:
    """Planetary boundary layer pressure (reference read_met_pbl,
    c:11253): mode 0 = from file (pressure), 1 = from file (height),
    2 = bulk Richardson number, 3 = theta increase (default)."""
    ps = f2["ps"].astype(np.float64)
    if ctl.met_pbl == 1:
        z = f3["z"].astype(np.float64)
        ztop = f2["zs"].astype(np.float64) + f2["pbl"].astype(np.float64)
        nxny = ps.shape
        ip = np.empty(nxny, np.int64)
        for ixx in range(nxny[0]):      # small grids; fine on host
            for iyy in range(nxny[1]):
                ip[ixx, iyy] = _locate_irr_vec(z[ixx, iyy], np.array(
                    ztop[ixx, iyy]))
        z0 = np.take_along_axis(z, ip[..., None], -1)[..., 0]
        z1 = np.take_along_axis(z, ip[..., None] + 1, -1)[..., 0]
        pblp = p[ip] + (p[ip + 1] - p[ip]) * (ztop - z0) / (z1 - z0)
        f2["pbl"] = pblp.astype(np.float32)
    elif ctl.met_pbl == 2:
        f2["pbl"] = _pbl_richardson(ctl, p, f2, f3).astype(np.float32)
    elif ctl.met_pbl == 3:
        t = f3["t"].astype(np.float64)
        ts = f2["ts"].astype(np.float64)
        theta0 = _theta(ps, ts)
        th = _theta(p[None, None, :], t)        # [nx, ny, npl]
        # Find topmost level (from the top downward) satisfying:
        # p >= 300 and (p > ps or theta <= theta0 + 2)
        dtheta = 2.0
        zmin = 0.1
        cond = (p[None, None, :] >= 300.0) & (
            (p[None, None, :] > ps[..., None])
            | (th <= theta0[..., None] + dtheta))
        npl = p.size
        # reference scans ip from npl-2 down to 1, stops at first cond;
        # if none found ip ends at 0
        idxs = np.arange(npl - 2, 0, -1)
        sub = cond[..., idxs]
        first = np.argmax(sub, axis=-1)
        found = np.any(sub, axis=-1)
        ip = np.where(found, idxs[0] - first, 0)
        th_lo = np.take_along_axis(th, ip[..., None] + 1, -1)[..., 0]
        th_hi = np.take_along_axis(th, ip[..., None], -1)[..., 0]
        p_lo = p[ip + 1]
        p_hi = p[ip]
        pblp = p_lo + (p_hi - p_lo) / np.where(
            th_hi != th_lo, th_hi - th_lo, 1e-30) * (
                theta0 + dtheta - th_lo)
        pbl_min = ps * np.exp(-zmin / H0)
        pblp = np.where((pblp > pbl_min) | (p[ip] > ps), pbl_min, pblp)
        f2["pbl"] = pblp.astype(np.float32)
    # Clamp (applies in all modes)
    pbl_lo = ps * np.exp(-ctl.met_pbl_min / H0)
    pbl_hi = ps * np.exp(-ctl.met_pbl_max / H0)
    f2["pbl"] = np.maximum(np.minimum(f2["pbl"], pbl_lo),
                           pbl_hi).astype(np.float32)


def _pbl_richardson(ctl: Ctl, p, f2, f3):
    """Bulk Richardson number PBL (reference c:11280-11334), fully
    vectorized over columns: the per-column upward scan becomes an
    argmax over the level axis (a 1444x724x140 ERA5 grid runs in
    ~0.5 s instead of hours; numerically identical to the scalar scan,
    asserted by test_met_vectorized)."""
    rib_crit, dz, umin = 0.25, 0.05, 5.0
    ps = f2["ps"].astype(np.float64)
    t = f3["t"].astype(np.float64)
    u = f3["u"].astype(np.float64)
    v = f3["v"].astype(np.float64)
    h2o = f3["h2o"].astype(np.float64)
    z = f3["z"].astype(np.float64)
    us = f2["us"].astype(np.float64)
    vs = f2["vs"].astype(np.float64)
    ts = f2["ts"].astype(np.float64)
    zs = f2["zs"].astype(np.float64)
    nx, ny, npl = t.shape

    pbl_bot = ps * np.exp(-dz / H0)                        # [nx, ny]
    # ip = first level index >= 1 with p[ip] < pbl_bot (p descending;
    # the predicate is monotone so a count works)
    ip = 1 + np.sum(p[None, None, 1:] >= pbl_bot[..., None], axis=-1)

    # Surface virtual potential temperature; h2o interpolated to
    # pbl_bot on the ascending-pressure profile (np.interp semantics:
    # clamped at the ends)
    pasc = p[::-1]
    j = np.clip(np.searchsorted(pasc, pbl_bot), 1, npl - 1)
    x0, x1 = pasc[j - 1], pasc[j]
    h2o_asc = h2o[..., ::-1]
    y0 = np.take_along_axis(h2o_asc, (j - 1)[..., None], -1)[..., 0]
    y1 = np.take_along_axis(h2o_asc, j[..., None], -1)[..., 0]
    slope = (y1 - y0) / (x1 - x0)
    h2os = np.where(pbl_bot <= pasc[0], h2o_asc[..., 0],
                    np.where(pbl_bot >= pasc[-1], h2o_asc[..., -1],
                             y0 + slope * (pbl_bot - x0)))
    tvs = _theta(pbl_bot, ts) * (
        1.0 + (1.0 - EPS) * np.maximum(h2os, 0.1e-6))

    # Bulk Richardson number at every level [nx, ny, npl]
    vh2 = np.maximum((u - us[..., None]) ** 2 + (v - vs[..., None]) ** 2,
                     umin ** 2)
    thv = _theta(p[None, None, :], t) * (
        1.0 + (1.0 - EPS) * np.maximum(h2o, 0.1e-6))
    rib = (G0 * 1e3 * (z - zs[..., None]) / tvs[..., None]
           * (thv - tvs[..., None]) / vh2)

    # First level ip2 >= ip with rib >= rib_crit
    lev = np.arange(npl)[None, None, :]
    hit = (rib >= rib_crit) & (lev >= ip[..., None])
    found = np.any(hit, axis=-1)
    ip2 = np.argmax(hit, axis=-1)                          # [nx, ny]
    ip2s = np.maximum(ip2, 1)
    rib_at = np.take_along_axis(rib, ip2s[..., None], -1)[..., 0]
    rib_prev = np.take_along_axis(rib, (ip2s - 1)[..., None], -1)[..., 0]
    # rib_old is 0 when the first scanned level already exceeds crit
    rib_old = np.where(ip2 > ip, rib_prev, 0.0)
    val = p[ip2s - 1] + (p[ip2s] - p[ip2s - 1]) / (
        rib_at - rib_old) * (rib_crit - rib_old)
    val = np.where(val > pbl_bot, pbl_bot, val)
    # No level exceeded rib_crit: keep the start-level pressure
    return np.where(found, val, p[np.minimum(ip, npl - 1)])


@span("process.cloud")
def cloud(lon, lat, p, f2, f3) -> None:
    """Cloud top/bottom pressure and total column cloud water
    (reference read_met_cloud, c:8982)."""
    ccmin, cwmin = 0.01, 1e-6
    ps = f2["ps"].astype(np.float64)
    cc = f3["cc"].astype(np.float64)
    lwc = f3["lwc"].astype(np.float64)
    rwc = f3["rwc"].astype(np.float64)
    iwc = f3["iwc"].astype(np.float64)
    swc = f3["swc"].astype(np.float64)
    npl = p.size
    p_hi = P0 * np.exp(-20.0 / H0)
    lev_ok = (p[None, None, :-1] <= ps[..., None]) & (p[:-1] >= p_hi)

    cloudy = lev_ok & (cc[..., :-1] > ccmin) & (
        (lwc[..., :-1] > cwmin) | (rwc[..., :-1] > cwmin)
        | (iwc[..., :-1] > cwmin) | (swc[..., :-1] > cwmin))
    pmid_up = 0.5 * (p[:-1] + p[1:])
    pm1 = np.maximum(np.arange(npl - 1) - 1, 0)
    pmid_dn = 0.5 * (p[:-1] + p[pm1])
    any_cloud = np.any(cloudy, axis=-1)
    # top: last cloudy level (loop keeps overwriting pct)
    last = npl - 2 - np.argmax(cloudy[..., ::-1], axis=-1)
    first = np.argmax(cloudy, axis=-1)
    pct = np.where(any_cloud, pmid_up[last], np.nan)
    pcb = np.where(any_cloud, pmid_dn[first], np.nan)
    tot = lwc + rwc + iwc + swc
    cl = np.sum(np.where(lev_ok, 0.5 * (tot[..., :-1] + tot[..., 1:])
                         * 100.0 * (p[:-1] - p[1:]) / G0, 0.0), axis=-1)
    f2["pct"] = pct.astype(np.float32)
    f2["pcb"] = pcb.astype(np.float32)
    f2["cl"] = cl.astype(np.float32)


@span("process.ozone_column")
def ozone_column(p, f2, f3) -> None:
    """Total column ozone in Dobson units (reference read_met_ozone,
    c:11633)."""
    o3 = f3["o3"].astype(np.float64)
    ps = f2["ps"].astype(np.float64)
    vmr = 0.5 * (o3[..., :-1] + o3[..., 1:])
    dp = (p[:-1] - p[1:])[None, None, :]
    use = p[None, None, :-1] <= ps[..., None]
    cd = np.sum(np.where(use, vmr * MO3 / MA * dp * 1e2 / G0, 0.0), axis=-1)
    f2["o3c"] = (cd / 2.1415e-5).astype(np.float32)


_PROFILE_OPS: dict = {}


def _profile_operator(z, z2, spline: bool):
    """[n2, n] resampling operator A with ``A @ y`` equal to the
    reference ``spline()`` (c:12215) column resample onto z2.

    Both of the reference's interpolants are *linear in the profile
    values*: the linear path trivially, and the GSL natural cubic
    spline because its second derivatives solve a fixed tridiagonal
    system (sigma = T^-1 D y).  Folding that into one dense operator
    turns the per-column resampling of a whole met grid into a single
    matmul (BLAS on the host)."""
    key = (z.tobytes(), z2.tobytes(), spline)
    A = _PROFILE_OPS.get(key)
    if A is not None:
        return A
    n, n2 = z.size, z2.size
    A = np.zeros((n2, n))
    if spline:
        h = np.diff(z)
        T = np.zeros((n, n))
        D = np.zeros((n, n))
        T[0, 0] = T[-1, -1] = 1.0      # natural: sigma_0 = sigma_n = 0
        for i in range(1, n - 1):
            T[i, i - 1] = h[i - 1] / 6.0
            T[i, i] = (h[i - 1] + h[i]) / 3.0
            T[i, i + 1] = h[i] / 6.0
            D[i, i - 1] = 1.0 / h[i - 1]
            D[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
            D[i, i + 1] = 1.0 / h[i]
        S = np.linalg.solve(T, D)      # sigma = S @ y
    for i2, x in enumerate(z2):
        if x <= z[0]:
            A[i2, 0] = 1.0
            continue
        if x >= z[-1]:
            A[i2, -1] = 1.0
            continue
        j = min(int(np.searchsorted(z, x, side="right")) - 1, n - 2)
        hj = z[j + 1] - z[j]
        a = (z[j + 1] - x) / hj
        b = (x - z[j]) / hj
        A[i2, j] += a
        A[i2, j + 1] += b
        if spline:
            A[i2] += ((a ** 3 - a) * S[j]
                      + (b ** 3 - b) * S[j + 1]) * hj * hj / 6.0
    _PROFILE_OPS[key] = A
    return A


@span("process.tropopause")
def tropopause(ctl: Ctl, clim, met_time, lon, lat, p, f2, f3) -> None:
    """Tropopause pressure per column (reference read_met_tropo,
    c:11835): 0 none, 1 climatology, 2 cold point, 3 WMO 1st (default),
    4 WMO 2nd, 5 dynamical."""
    nx, ny = f2["ps"].shape
    npl = p.size
    z = H0 * np.log(P0 / p)
    z2 = 4.5 + 0.1 * np.arange(191)
    p2 = P0 * np.exp(-z2 / H0)

    if ctl.met_tropo == 0:
        f2["pt"] = np.full((nx, ny), np.nan, np.float32)
    elif ctl.met_tropo == 1:
        from mptrac_tpu_torch.climatology import clim_tropo_np
        pt = np.empty((nx, ny))
        for iyy in range(ny):
            pt[:, iyy] = clim_tropo_np(clim, met_time, lat[iyy])
        f2["pt"] = pt.astype(np.float32)
    else:
        t3 = f3["t"].astype(np.float64)
        ncol = nx * ny
        finite = np.all(np.isfinite(t3), axis=-1).reshape(ncol)
        AT = _profile_operator(z, z2, bool(ctl.met_tropo_spline)).T
        izgrid = np.arange(171)[None, :]
        # Precomputed per-(iz, k) pressure factor of the lapse rate
        coef = {}
        for k in range(1, 21):
            pl, pr = p2[:171], p2[k:k + 171]
            coef[k] = 1e3 * G0 / RA * (pr + pl) / (pr - pl)

        def lapse_ok(t2, kmax, lo, hi):
            """ok[iz] = all k in [1, kmax]: lo <= lapse(iz, iz+k) <= hi
            for iz in [0, 171); t2 stays cache-resident per chunk."""
            ok = np.ones((t2.shape[0], 171), bool)
            tl = t2[:, :171]
            for k in range(1, kmax + 1):
                tr = t2[:, k:k + 171]
                lapse = coef[k] * (tr - tl) / (tr + tl)
                if hi is not None:
                    ok &= lapse <= hi
                if lo is not None:
                    ok &= lapse >= lo
            return ok

        # Column-chunked: the resample is one BLAS matmul per chunk
        # (the spline/linear operator is linear in the profile values,
        # see _profile_operator) and the window scans then run on a
        # cache-resident [chunk, 191] slab.  Full 1444x724 ERA5 grid:
        # seconds, vs hours for the former per-column Python loops.
        pt = np.full(ncol, np.nan)
        csize = 16384
        t3c = t3.reshape(ncol, npl)
        if ctl.met_tropo == 5:
            pvc = f3["pv"].astype(np.float64).reshape(ncol, npl)
            thc = _theta(p[None, :], t3c)
        for c0 in range(0, ncol, csize):
            sl = slice(c0, min(c0 + csize, ncol))
            t2 = t3c[sl] @ AT                      # [chunk, 191]
            if ctl.met_tropo == 2:
                iz = np.argmin(t2[:, :171], axis=-1)
                okf = (iz > 0) & (iz < 170)
                iz_found = np.where(okf, iz, -1)
            elif ctl.met_tropo in (3, 4):
                ok1 = lapse_ok(t2, 20, None, 2.0)  # [chunk, 171]
                found1 = np.any(ok1, axis=-1)
                iz_found = np.where(found1, np.argmax(ok1, axis=-1), -1)
                if ctl.met_tropo == 4:
                    start = np.where(iz_found >= 0, iz_found, 171)
                    # stage 2: skip while a 10-level window has lapse < 3
                    ok2 = lapse_ok(t2, 10, 3.0, None)
                    cand2 = ok2 & (izgrid >= start[:, None])
                    start2 = np.where(np.any(cand2, axis=-1),
                                      np.argmax(cand2, axis=-1), 171)
                    # stage 3: the WMO criterion again above that level
                    cand3 = ok1 & (izgrid >= start2[:, None])
                    iz_found = np.where(np.any(cand3, axis=-1),
                                        np.argmax(cand3, axis=-1), -1)
            elif ctl.met_tropo == 5:
                pv2 = pvc[sl] @ AT
                th2 = thc[sl] @ AT
                hit = ((np.abs(pv2[:, :171]) >= ctl.met_tropo_pv)
                       | (th2[:, :171] >= ctl.met_tropo_theta))
                idx = np.argmax(hit, axis=-1)
                okf = np.any(hit, axis=-1) & (idx > 0) & (idx < 170)
                iz_found = np.where(okf, idx, -1)
            else:
                raise ValueError("Cannot calculate tropopause!")
            good = (iz_found > 0) & (iz_found < 170) & finite[sl]
            pt[sl] = np.where(good, p2[np.clip(iz_found, 0, 170)],
                              np.nan)
        f2["pt"] = pt.reshape(nx, ny).astype(np.float32)

    # Interpolate T, z, h2o at the tropopause (reference c:11983-12006)
    from mptrac_tpu_torch.met.build import interp_columns_at
    f2["tt"] = interp_columns_at(f3["t"], lon, lat, p, f2["pt"],
                                 coord_type=ctl.met_coord_type)
    f2["zt"] = interp_columns_at(f3["z"], lon, lat, p, f2["pt"],
                                 coord_type=ctl.met_coord_type)
    f2["h2ot"] = interp_columns_at(f3["h2o"], lon, lat, p, f2["pt"],
                                   coord_type=ctl.met_coord_type)


def level_definitions(press_level_def: int):
    """Built-in output pressure-level sets for model-level data
    (reference level_definitions, c:3342): ids 3-7 (extended
    L137/L91/L60 etc.), returned surface-first (descending p)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "press_level_defs.npz")
    with np.load(path) as d:
        key = str(press_level_def)
        if key not in d:
            raise ValueError(
                f"MET_PRESS_LEVEL_DEF={press_level_def} is disabled. "
                "Use 3-7.")
        return d[key][::-1].copy()


@span("process.sample_grid")
def sample_grid(ctl: Ctl, lon, lat, p, f2, f3):
    """Downsampling/smoothing by strides met_dx/dy/dp with triangular
    boxcar met_sx/sy/sp (reference read_met_sample, c:11662)."""
    if (ctl.met_dp <= 1 and ctl.met_dx <= 1 and ctl.met_dy <= 1
            and ctl.met_sp <= 1 and ctl.met_sx <= 1 and ctl.met_sy <= 1):
        return lon, lat, p, f2, f3
    nx, ny, npl = lon.size, lat.size, p.size
    sx, sy, sp = max(ctl.met_sx, 1), max(ctl.met_sy, 1), max(ctl.met_sp, 1)

    smooth2 = ("ps", "zs", "ts", "us", "vs", "ess", "nss", "shf", "lsm",
               "sst", "pbl", "cape", "cin")
    smooth3 = ("t", "u", "v", "w", "h2o", "o3", "lwc", "rwc", "iwc",
               "swc", "cc")

    acc2 = {k: np.zeros((nx, ny)) for k in smooth2}
    acc3 = {k: np.zeros((nx, ny, npl)) for k in smooth3}
    w2 = np.zeros((nx, ny))
    w3 = np.zeros((nx, ny, npl))
    for ox in range(-sx + 1, sx):
        wx = 1.0 - abs(ox) / sx
        for oy in range(-sy + 1, sy):
            wy = 1.0 - abs(oy) / sy
            ysrc = np.clip(np.arange(ny) + oy, 0, ny - 1)
            yok = (np.arange(ny) + oy >= 0) & (np.arange(ny) + oy < ny)
            for k in smooth2:
                rolled = np.roll(f2[k], -ox, axis=0)[:, ysrc]
                acc2[k] += np.where(yok[None, :], wx * wy * rolled, 0.0)
            w2 += np.where(yok[None, :], wx * wy, 0.0)
            for op in range(-sp + 1, sp):
                wp = 1.0 - abs(op) / sp
                psrc = np.clip(np.arange(npl) + op, 0, npl - 1)
                pok = ((np.arange(npl) + op >= 0)
                       & (np.arange(npl) + op < npl))
                m = yok[None, :, None] & pok[None, None, :]
                for k in smooth3:
                    rolled = np.roll(f3[k], -ox, axis=0)[:, ysrc][..., psrc]
                    acc3[k] += np.where(m, wx * wy * wp * rolled, 0.0)
                w3 += np.where(m, wx * wy * wp, 0.0)
    for k in smooth2:
        f2[k] = (acc2[k] / w2).astype(np.float32)
    for k in smooth3:
        f3[k] = (acc3[k] / w3).astype(np.float32)

    # Downsampling by strides
    xs = np.arange(0, nx, ctl.met_dx)
    ys = np.arange(0, ny, ctl.met_dy)
    ps_ = np.arange(0, npl, ctl.met_dp)
    lon2 = lon[xs]
    lat2 = lat[ys]
    p2 = p[ps_]
    for k in list(f2):
        f2[k] = np.ascontiguousarray(f2[k][xs][:, ys])
    for k in list(f3):
        f3[k] = np.ascontiguousarray(f3[k][xs][:, ys][:, :, ps_])
    return lon2, lat2, p2, f2, f3


@span("process.detrend")
def detrend(ctl: Ctl, lon, lat, p, f3):
    """Subtract a Gaussian-smoothed background from t/u/v/w
    (reference read_met_detrend, c:9039): FWHM met_detrend [km]."""
    if ctl.met_detrend <= 0:
        return
    if ctl.met_coord_type != 0:
        raise ValueError("Only lat/lon grid supported")
    nx, ny = lon.size, lat.size
    sigma = ctl.met_detrend / 2.355
    tssq = 2.0 * sigma ** 2
    dlat_deg = abs(lat[1] - lat[0])
    dlon_deg = abs(lon[1] - lon[0])
    sy = int(3.0 * (sigma * 180.0 / (np.pi * RE)) / dlat_deg)
    sy = min(max(1, sy), ny // 2)

    latr = np.deg2rad(lat)
    lonr = np.deg2rad(lon)
    x = RE * np.cos(latr)[None, :] * np.cos(lonr)[:, None]
    y = RE * np.cos(latr)[None, :] * np.sin(lonr)[:, None]
    z = RE * np.broadcast_to(np.sin(latr)[None, :], (nx, ny))

    bgs = {k: np.zeros_like(f3[k], np.float64)
           for k in ("t", "u", "v", "w")}
    wsum = np.zeros((nx, ny))
    # per-latitude-row zonal box size varies; loop over offsets with a
    # per-row mask (vectorized across the grid)
    near_pole = np.abs(lat) > 89.999
    dx2deg_row = np.where(
        near_pole, 0.0,
        sigma * 180.0 / (np.pi * RE
                         * np.cos(np.deg2rad(np.where(near_pole, 0.0,
                                                      lat)))))
    sx_row = (3.0 * dx2deg_row / dlon_deg).astype(int)
    sx_row = np.minimum(np.maximum(1, sx_row), nx // 2)
    sx_max = int(sx_row.max())
    for ox in range(-sx_max, sx_max + 1):
        in_x = np.abs(ox) <= sx_row          # [ny]
        xr = np.roll(x, -ox, axis=0)
        yr = np.roll(y, -ox, axis=0)
        zr = np.roll(z, -ox, axis=0)
        for oy in range(-sy, sy + 1):
            ysrc = np.arange(ny) + oy
            yok = (ysrc >= 0) & (ysrc < ny)
            ysafe = np.clip(ysrc, 0, ny - 1)
            d2 = ((x - xr[:, ysafe]) ** 2 + (y - yr[:, ysafe]) ** 2
                  + (z - zr[:, ysafe]) ** 2)
            w = np.exp(-d2 / tssq).astype(np.float32)
            w = np.where(yok[None, :] & in_x[None, :], w, 0.0)
            wsum += w
            for k in bgs:
                bgs[k] += w[..., None] * np.roll(
                    f3[k], -ox, axis=0)[:, ysafe]
    for k in bgs:
        f3[k] = (f3[k] - bgs[k] / wsum[..., None]).astype(np.float32)


@span("process.monotonize")
def monotonize(ctl: Ctl, hybrid, f3):
    """Enforce monotonic zeta/pressure profiles on model levels for
    diabatic advection (reference read_met_monotonize, c:10949)."""
    if ctl.advect_vert_coord != 1:
        return
    for name, increasing in (("zetal", True), ("pl", False)):
        if name not in f3:
            continue
        prof = f3[name].astype(np.float64)
        npl = prof.shape[-1]
        sgn = 1.0 if increasing else -1.0
        v = sgn * prof
        # running maximum marks inversions; linear re-interpolation in
        # the hybrid coordinate between inversion bottom and top
        out = v.copy()
        for k in range(1, npl):
            out[..., k] = np.maximum(out[..., k], out[..., k - 1])
        # Where the running max changed the value, interpolate between
        # bracketing unchanged levels in hybrid space (iterative
        # forward fill reproduces the reference's linear bridge)
        changed = out > v + 0.0
        # find for each level the previous unchanged level value and
        # next unchanged level; vectorized scan:
        idx = np.arange(npl)
        last_ok = np.where(~changed, idx[None, None, :], -1)
        np.maximum.accumulate(last_ok, axis=-1, out=last_ok)
        next_ok = np.where(~changed, idx[None, None, :], npl)
        next_ok = np.flip(
            np.minimum.accumulate(np.flip(next_ok, -1), -1), -1)
        next_ok = np.clip(next_ok, 0, npl - 1)
        last_ok = np.clip(last_ok, 0, npl - 1)
        v0 = np.take_along_axis(v, last_ok, -1)
        v1 = np.take_along_axis(v, next_ok, -1)
        h = np.asarray(hybrid)
        h0 = h[last_ok]
        h1 = h[next_ok]
        denom = np.where(h1 != h0, h1 - h0, 1.0)
        interp_v = v0 + (v1 - v0) / denom * (h[None, None, :] - h0)
        out = np.where(changed, interp_v, v)
        f3[name] = (sgn * out).astype(np.float32)


@span("process.ml2pl")
def ml2pl(ctl: Ctl, f3, target_p):
    """Model-level -> pressure-level vertical interpolation using the
    3-D pressure field pl (reference read_met_ml2pl, c:10907)."""
    pl = f3["pl"].astype(np.float64)          # [nx, ny, nml]
    nml = pl.shape[-1]
    npl_out = target_p.size
    desc = pl[..., :1] > pl[..., 1:2]
    names = [name for name in ("t", "u", "v", "w", "h2o", "o3", "lwc",
                               "rwc", "iwc", "swc", "cc") if name in f3]
    var = {name: f3[name].astype(np.float64) for name in names}
    out = {name: np.empty(pl.shape[:-1] + (npl_out,)) for name in names}
    # locate_irr per column (descending or ascending profiles) via a
    # per-column comparison count; the cell of each target level is the
    # same for every field
    key = np.where(desc, -pl, pl)
    lo = np.minimum(pl[..., 0], pl[..., -1])
    hi = np.maximum(pl[..., 0], pl[..., -1])
    for ip, pt in enumerate(target_p):
        ptc = np.clip(pt, lo, hi)
        kq = np.where(desc[..., 0], -ptc, ptc)
        idx = np.sum(key <= kq[..., None], axis=-1) - 1
        idx = np.clip(idx, 0, nml - 2)[..., None]
        p0 = np.take_along_axis(pl, idx, -1)[..., 0]
        p1 = np.take_along_axis(pl, idx + 1, -1)[..., 0]
        denom = np.where(p1 != p0, p1 - p0, 1.0)
        for name in names:
            v0 = np.take_along_axis(var[name], idx, -1)[..., 0]
            v1 = np.take_along_axis(var[name], idx + 1, -1)[..., 0]
            out[name][..., ip] = v0 + (v1 - v0) / denom * (ptc - p0)
    for name in names:
        f3[name] = out[name].astype(np.float32)
