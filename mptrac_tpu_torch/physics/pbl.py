"""PBL turbulence closure (Hanna / FLEXPART scheme).

Reference: module_diff_pbl (mptrac.c:4335-4580).  Counterpart of the
JAX package's ``physics/pbl.py``: regime-dependent (neutral / unstable /
stable) velocity standard deviations and Lagrangian timescales from
Monin-Obukhov theory, AR(1) velocity perturbations with well-mixed
drift, and reflection at the surface and the PBL top.  The masked
``where`` ladders keep the JAX branch order.

Every parcel's update depends on its own values only, so the module
runs over chunks of ``PBL_CHUNK`` parcels after one draw of all
parcels' normals: the same numbers as one pass, with the ~90 temporaries
of the ladders bounded by the chunk.
"""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import CPD, G0, H0, KARMAN, P0
from mptrac_tpu_torch.ops import interp, thermo
from mptrac_tpu_torch.ops.rng import module_rng3
from mptrac_tpu_torch.ops.thermo import dx2coord, dy2coord
from mptrac_tpu_torch.types import Atm, Cache, Met

#: parcels per pass (a float32 temporary of a pass is 32 MB)
PBL_CHUNK = 1 << 23

#: branch codes of ``pbl_branches``: a parcel the scheme leaves alone,
#: the neutral regime, the unstable regime's zeta bands (0.03-0.4 split
#: by the smaller of its two sigma_w forms) and the stable regime
BRANCHES = ("inactive", "neutral", "unstable_zeta<0.03",
            "unstable_0.03-0.4_s1<s2", "unstable_0.03-0.4_s1>=s2",
            "unstable_0.4-0.96", "unstable_zeta>=0.96", "stable")


def _pbl_pass(met01: Met, time, lon, lat, p, dt, mask, uvwp, rs,
              branch: bool = False):
    """The scheme on one pass of parcels: (lon, lat, p, uvwp) after the
    step, or with ``branch`` the branch code of each parcel."""
    loc = interp.locate_3d(met01, lon, lat, p)
    pbl = interp.interp_time_2d(met01, "pbl", time, loc)
    ps = interp.interp_time_2d(met01, "ps", time, loc)
    del loc

    active = ((dt != 0.0) & mask & (p >= pbl)
              & (ps > 0.0) & (pbl > 0.0) & (ps > pbl))

    pc = torch.minimum(p, ps)
    zs = thermo.altitude(ps)
    z_raw = 1e3 * (thermo.altitude(pc) - zs)
    zi = 1e3 * (thermo.altitude(pbl) - zs)
    active = active & (zi > 1.0)
    zi_safe = torch.clamp(zi, min=1.001)
    del zi
    z = torch.minimum(torch.clamp(z_raw, min=0.0), zi_safe)
    del z_raw
    zeta = torch.clamp(z / zi_safe, 1e-6, 1.0 - 1e-6)
    z_m = torch.clamp(z, min=1.0)

    # Thermodynamics at the clamped pressure
    loc = interp.locate_3d(met01, lon, lat, pc)
    ess = interp.interp_time_2d(met01, "ess", time, loc)
    nss = interp.interp_time_2d(met01, "nss", time, loc)
    t = interp.interp_time_3d(met01, "t", time, loc)
    h2o = interp.interp_time_3d(met01, "h2o", time, loc)
    shf = interp.interp_time_2d(met01, "shf", time, loc)
    del loc

    tv = thermo.tvirt(t, h2o)
    thetav = thermo.theta_virt(pc, t, h2o)
    rho = thermo.rho(pc, tv)
    del t, h2o, tv, pc
    active = active & (rho > 0.0)
    tau_stress = torch.sqrt(ess * ess + nss * nss)
    del ess, nss
    ustar = torch.sqrt(torch.clamp(
        tau_stress / torch.clamp(rho, min=1e-30), min=0.0))
    ust = torch.clamp(ustar, min=1e-4)
    del tau_stress, ustar

    big = torch.abs(shf) > 1e-6
    ol = torch.where(big,
                     thetav * rho * CPD * ust * ust * ust
                     / (KARMAN * G0 * torch.where(big, shf, 1.0)),
                     1e12)
    del big

    neutral = zi_safe / torch.abs(ol) < 1.0
    unstable = (~neutral) & (ol < 0.0)

    # --- Neutral (c:4428-4443)
    corr = z_m / ust
    sigw0 = 1.3 * ust * torch.exp(-2e-4 * corr)
    n_sig_u = torch.clamp(2.0 * ust * torch.exp(-3e-4 * corr), min=1e-5)
    n_sig_v = torch.clamp(sigw0, min=1e-5)
    n_sig_w = n_sig_v
    n_dsigw_dz = -2e-4 * sigw0 / ust
    n_tau_u = 0.5 * z_m / n_sig_w / (1.0 + 1.5e-3 * corr)
    del corr, sigw0

    # --- Unstable (c:4446-4497)
    wstar_arg = -G0 / thetav * shf / (rho * CPD) * zi_safe
    wstar = torch.clamp(wstar_arg, min=0.0) ** (1.0 / 3.0)
    del wstar_arg
    u_sig_u = torch.clamp(
        ust * torch.clamp(12.0 - 0.5 * zi_safe / ol, min=0.0) ** (1.0 / 3.0),
        min=1e-6)
    arg = torch.clamp(3.0 * zeta - ol / zi_safe, min=1e-12)
    s1 = 0.96 * arg ** (1.0 / 3.0)
    s2 = 0.763 * zeta ** 0.175
    # zeta < 0.03
    w_a = 0.96 * wstar * arg ** (1.0 / 3.0)
    d_a = 1.8432 * wstar * wstar / zi_safe * arg ** (-1.0 / 3.0)
    del arg
    # 0.03 <= zeta < 0.4, branch on s1 < s2
    w_b1 = wstar * s1
    d_b1 = d_a
    w_b2 = wstar * s2
    d_b2 = 0.203759 * wstar * wstar / zi_safe * zeta ** (-0.65)
    # 0.4 <= zeta < 0.96
    w_c = 0.722 * wstar * (1.0 - zeta) ** 0.207
    d_c = -0.215812 * wstar * wstar / zi_safe * (1.0 - zeta) ** (-0.586)
    # zeta >= 0.96
    w_d = 0.37 * wstar
    d_d = torch.zeros_like(wstar)
    lt03, lt4, lt96, s12 = zeta < 0.03, zeta < 0.4, zeta < 0.96, s1 < s2
    del s1, s2
    if branch:
        code = torch.full_like(p, 7, dtype=torch.int8)       # stable
        code[unstable & ~lt96] = 6
        code[unstable & lt96] = 5
        code[unstable & lt4 & ~s12] = 4
        code[unstable & lt4 & s12] = 3
        code[unstable & lt03] = 2
        code[neutral] = 1
        code[~active] = 0
        return code
    where = torch.where
    u_sig_w = where(lt03, w_a, where(lt4, where(s12, w_b1, w_b2),
                                     where(lt96, w_c, w_d)))
    u_dsigw2_dz = where(lt03, d_a, where(lt4, where(s12, d_b1, d_b2),
                                         where(lt96, d_c, d_d)))
    del w_a, d_a, w_b1, d_b1, w_b2, d_b2, w_c, d_c, w_d, d_d, lt03, lt4
    del lt96, s12, wstar
    u_sig_w = torch.clamp(u_sig_w, min=1e-6)
    u_dsigw_dz = where(u_sig_w > 1e-12, 0.5 * u_dsigw2_dz / u_sig_w, 0.0)
    del u_dsigw2_dz
    u_tau_u = 0.15 * zi_safe / torch.clamp(u_sig_u, min=1e-12)
    denom = torch.clamp(0.55 - 0.38 * torch.abs(z_m / ol), min=0.05)
    u_tau_w = where(
        z_m < torch.abs(ol), 0.1 * z_m / (u_sig_w * denom),
        where(zeta < 0.1, 0.59 * z_m / u_sig_w,
              0.15 * zi_safe / u_sig_w * (1.0 - torch.exp(-5.0 * zeta))))
    del denom, ol

    # --- Stable (c:4500-4510)
    s_sig_u = torch.clamp(2.0 * ust * (1.0 - zeta), min=1e-6)
    s_sig_v = torch.clamp(1.3 * ust * (1.0 - zeta), min=1e-6)
    s_sig_w = s_sig_v
    s_dsigw_dz = -1.3 * ust / zi_safe
    s_tau_u = 0.15 * zi_safe / s_sig_u * torch.sqrt(zeta)
    s_tau_v = 0.467 * s_tau_u
    s_tau_w = 0.1 * zi_safe / s_sig_w * zeta ** 0.8
    del ust, zeta, z_m

    sig_u = where(neutral, n_sig_u, where(unstable, u_sig_u, s_sig_u))
    sig_v = where(neutral, n_sig_v, where(unstable, u_sig_u, s_sig_v))
    sig_w = where(neutral, n_sig_w, where(unstable, u_sig_w, s_sig_w))
    dsigw_dz = where(neutral, n_dsigw_dz,
                     where(unstable, u_dsigw_dz, s_dsigw_dz))
    tau_u = where(neutral, n_tau_u, where(unstable, u_tau_u, s_tau_u))
    tau_v = where(neutral, n_tau_u, where(unstable, u_tau_u, s_tau_v))
    tau_w = where(neutral, n_tau_u, where(unstable, u_tau_w, s_tau_w))
    del (n_sig_u, n_sig_v, n_sig_w, n_dsigw_dz, n_tau_u, u_sig_u, u_sig_w,
         u_dsigw_dz, u_tau_u, u_tau_w, s_sig_u, s_sig_v, s_sig_w,
         s_dsigw_dz, s_tau_u, s_tau_v, s_tau_w, neutral, unstable)

    tau_u = torch.clamp(tau_u, min=10.0)
    tau_v = torch.clamp(tau_v, min=10.0)
    tau_w = torch.clamp(tau_w, min=30.0)
    active = active & (sig_u > 0) & (sig_v > 0) & (sig_w > 0)

    dt_abs = torch.abs(dt)
    ru = torch.exp(-dt_abs / tau_u)
    ru2 = torch.sqrt(torch.clamp(1.0 - ru * ru, min=0.0))
    rv = torch.exp(-dt_abs / tau_v)
    rv2 = torch.sqrt(torch.clamp(1.0 - rv * rv, min=0.0))
    rw = torch.exp(-dt_abs / tau_w)
    rw2 = torch.sqrt(torch.clamp(1.0 - rw * rw, min=0.0))
    del dt_abs, tau_u, tau_v

    dtype = lon.dtype
    up = uvwp[0].to(dtype)
    vp = uvwp[1].to(dtype)
    wp = uvwp[2].to(dtype)

    up_new = (up * ru + sig_u * ru2 * rs[0]).to(torch.float32)
    vp_new = (vp * rv + sig_v * rv2 * rs[1]).to(torch.float32)
    rhoaux = -1.0 / (1e3 * H0)
    wp_new = (wp * rw + sig_w * rw2 * rs[2]
              + tau_w * (1.0 - rw)
              * (2.0 * sig_w * dsigw_dz + rhoaux * sig_w * sig_w)
              ).to(torch.float32)
    del up, vp, wp, ru, ru2, rv, rv2, rw, rw2, sig_u, sig_v, sig_w
    del tau_w, dsigw_dz

    cart = met01.coord_type != 0
    lon_new = lon + dx2coord(up_new.to(dtype) * dt, lat, cart)
    lat_new = lat + dy2coord(vp_new.to(dtype) * dt, cart)

    # Reflect at surface and PBL top, flipping the perturbation
    znew = z + wp_new.to(dtype) * dt
    wflip = wp_new
    for _ in range(6):
        below = znew < 0.0
        znew = torch.where(below, -znew, znew)
        wflip = torch.where(below, -wflip, wflip)
        above = znew > zi_safe
        znew = torch.where(above, 2.0 * zi_safe - znew, znew)
        wflip = torch.where(above, -wflip, wflip)
    znew = torch.minimum(torch.clamp(znew, min=0.0), zi_safe)
    p_new = P0 * torch.exp(-(zs + znew / 1000.0) / H0)
    p_new = torch.minimum(torch.maximum(p_new, pbl), ps)

    uvwp_new = torch.stack([where(active, up_new, uvwp[0]),
                            where(active, vp_new, uvwp[1]),
                            where(active, wflip, uvwp[2])])
    return (where(active, lon_new, lon), where(active, lat_new, lat),
            where(active, p_new, p), uvwp_new)


def _passes(n: int):
    for s in range(0, n, PBL_CHUNK):
        yield s, min(n, s + PBL_CHUNK)


def module_diff_pbl(ctl: Ctl, cache: Cache, met01: Met, atm: Atm):
    """One step of the PBL scheme (reference c:4335-4580): draws 3n
    normals (counter + 3n + 1) and moves the active parcels."""
    n = atm.npmax
    rs, ctr = module_rng3(ctl.rng_type, cache.rng_ctr, n,
                          dtype=atm.lon.dtype, device=atm.lon.device,
                          part=cache.rng_part)
    cache = cache.replace(rng_ctr=ctr)
    mask = atm.mask
    lon, lat = torch.empty_like(atm.lon), torch.empty_like(atm.lat)
    p, uvwp = torch.empty_like(atm.p), torch.empty_like(cache.uvwp)
    for s, e in _passes(n):
        out = _pbl_pass(met01, atm.time[s:e], atm.lon[s:e], atm.lat[s:e],
                        atm.p[s:e], cache.dt[s:e], mask[s:e],
                        cache.uvwp[:, s:e], rs[:, s:e])
        lon[s:e], lat[s:e], p[s:e], uvwp[:, s:e] = out
        del out
    return atm.replace(lon=lon, lat=lat, p=p), cache.replace(uvwp=uvwp)


def pbl_branches(ctl: Ctl, cache: Cache, met01: Met, atm: Atm):
    """int8 branch code (an index into ``BRANCHES``) that the scheme
    takes for each parcel in its present state, without moving any."""
    mask = atm.mask
    code = torch.empty(atm.npmax, dtype=torch.int8, device=atm.lon.device)
    for s, e in _passes(atm.npmax):
        code[s:e] = _pbl_pass(met01, atm.time[s:e], atm.lon[s:e],
                              atm.lat[s:e], atm.p[s:e], cache.dt[s:e],
                              mask[s:e], None, None, branch=True)
    return code
