"""Full chemistry (KPP mechanism) with a batched Rosenbrock solver.

Counterpart of the JAX package's ``physics/kpp.py`` (the reference's
optional KPP chemistry, mptrac.c module_kpp_chem c:5001, mechanism
projects/kpp/chem/chem.eqn, rate constants projects/kpp/chem/chem.kpp):
a 15-species HOx/Ox/SO2 stratospheric mechanism with 39 reactions (JPL
rates, photolysis table lookups, aqueous SO2+H2O2), integrated per
parcel over DT_KPP by an adaptive 4-stage Rosenbrock method (Rodas3).
The stoichiometry is read from ``data/kpp_mechanism.npz``, a copy of
the JAX package's tables.

The JAX package runs a ``while_loop`` per parcel under ``vmap``: every
parcel keeps its own time, step, concentrations, step count and
rejection flag, and a parcel that has finished is held by the batched
select.  Here one batched loop runs while any parcel of a pass is
active and holds the finished ones the same way, and its batch shrinks
to the running parcels as they finish, so a parcel's result does not
depend on the others of its pass (held bit for bit on the CPU by the
tests); the passes take ``KPP_CHUNK`` parcels each, which bounds the
[chunk, 39, 15] tangents.

The Jacobian is the analytic one of the mass-action rates,
``J[i, j] = sum_r NET_V[r, i] * rconst[r] * (REACT_V[r, j] / c_j) *
exp(lograte[r])`` with ``1/c_j`` taken as 0 where ``c_j <= 1e-30``: term
for term what ``jax.jacfwd`` of the JAX ``_rhs`` evaluates (the tangent
of ``log(max(c, 1e-30))`` is ``1/c`` above the floor and 0 below it).
The integration runs in float64 whatever the state's dtype, as the JAX
package's float64 tables make it run there (on a float32 state its
``while_loop`` refuses the promoted carry); the results are written back
in the state's dtype.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import AVO, MA, RI
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.physics.chem import clim_photo, cos_sza, molec_dens
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met, _map_tensors
from mptrac_tpu_torch.utils.timers import span

#: parcels per pass of the integration (~20 kB of float64 temporaries
#: each, the [39, 15] tangents the largest: ~20 GB a pass)
KPP_CHUNK = 1 << 20

#: quantity name carrying each variable species (SET_VAR calls,
#: chem.kpp:97-110; so2 is carried in qnt_Cx)
SPECIES_QNT = {"o3p": "Co3p", "o1d": "Co1d", "h2o2": "Ch2o2",
               "oh": "Coh", "ho2": "Cho2", "h": "Ch", "n2o": "Cn2o",
               "ccl3f": "Cccl3f", "ccl2f2": "Cccl2f2", "co": "Cco",
               "so2": "Cx"}


class Mechanism(NamedTuple):
    """Stoichiometry tables: reactant orders of the variable species
    ``react_v`` [NREACT, NVAR] and of the fixed ones ``react_f``
    [NREACT, 3], net production ``net_v`` [NREACT, NVAR]."""
    react_v: np.ndarray
    react_f: np.ndarray
    net_v: np.ndarray
    var_species: tuple
    fix_species: tuple


@functools.lru_cache(maxsize=None)
def mechanism() -> Mechanism:
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "kpp_mechanism.npz")
    with np.load(path) as d:
        return Mechanism(d["react_v"], d["react_f"], d["net_v"],
                         tuple(str(s) for s in d["var_species"]),
                         tuple(str(s) for s in d["fix_species"]))


NVAR = 15
NREACT = 39


def _tables(device):
    """The float64 tables on ``device``, each contracted with the batch
    from the right in a contiguous layout: ``react_v``, ``REACT_V^T``,
    ``REACT_F^T``, ``NET_V`` and ``NET_V^T``.  (A transposed view on the
    right of a matmul gives a row results that depend on the number of
    rows on the CPU; the contiguous copies do not, so a parcel's result
    does not depend on its pass.)"""
    m = mechanism()

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device)

    return (t(m.react_v), t(m.react_v.T), t(m.react_f.T), t(m.net_v),
            t(m.net_v.T))


def _arr_ab(t, a, b):
    return a * torch.exp(-b / t)


def _arr_ac(t, a, c):
    return a * (t / 298.0) ** c


def _k3rd_jpl(t, M, k0_300, n, kinf_300, m):
    k0 = k0_300 * (298.0 / t) ** n * M
    kinf = kinf_300 * (298.0 / t) ** m
    c = torch.log10(k0 / kinf)
    return k0 / (1.0 + k0 / kinf) * 0.6 ** (1.0 / (1.0 + c * c))


def _kcar_jpl(t, M, k0_300, n, kinf_300, m, a, b):
    """CO + OH chemical activation rate (chem.kpp kcar_jpl)."""
    return (_k3rd_jpl(t, M, k0_300, n, kinf_300, m)
            + _arr_ab(t, a, -b))


def rate_constants(clim: Clim, t, M, p, sza, o3c, lwc):
    """All 39 reaction rate constants (chem.kpp:124-195), [np, NREACT]
    in the dtype of ``t``."""

    def photo(key):
        if key in clim.photo:
            return clim_photo(clim.photo[key], clim, p, sza, o3c)
        return torch.zeros_like(t)

    k = [None] * NREACT
    k[0] = _arr_ac(t, 6.1e-34, -2.4) * M
    k[1] = _arr_ab(t, 8e-12, 2060)
    k[2] = _arr_ab(t, 1.8e-11, -180)
    k[3] = _arr_ab(t, 3e-11, -200)
    k[4] = _arr_ab(t, 1.4e-12, 2000)
    k[5] = _arr_ab(t, 3.3e-11, -55)
    k[6] = _arr_ab(t, 2.4e-10, 0)
    k[7] = _arr_ab(t, 1.2e-10, 0)
    k[8] = _arr_ab(t, 1.63e-10, -60)
    k[9] = _arr_ab(t, 2.15e-11, -110)
    k[10] = _arr_ac(t, 2.8e-36, -0.9) * M
    k[11] = _arr_ab(t, 1.19e-10, -20)
    k[12] = _arr_ab(t, 1.75e-10, 0)
    k[13] = _arr_ab(t, 7.5e-11, -115)
    k[14] = _arr_ab(t, 2.3e-10, 0)
    k[15] = _arr_ab(t, 1.4e-10, -25)
    k[16] = _k3rd_jpl(t, M, 5.3e-32, 1.8, 9.5e-11, -0.4)
    k[17] = _arr_ab(t, 1.4e-10, 470)
    k[18] = _arr_ab(t, 7.2e-11, 0)
    k[19] = _arr_ab(t, 1.6e-12, 0)
    k[20] = _arr_ab(t, 6.9e-12, 0)
    k[21] = _arr_ab(t, 1.7e-12, 940)
    k[22] = _arr_ab(t, 1.8e-12, 0)
    k[23] = _k3rd_jpl(t, M, 6.9e-31, 1.0, 2.6e-11, 0)
    k[24] = _arr_ab(t, 4.8e-11, -250)
    k[25] = torch.full_like(t, 1.8e-12)
    k[26] = _kcar_jpl(t, M, 6.9e-33, 2.1, 1.1e-12, -1.3, 1.85e-13, 65)
    k[27] = _arr_ab(t, 1e-14, 490)
    k[28] = (_arr_ab(t, 3e-13, -460)
             + _arr_ab(t, 2.1e-33, -920) * M)
    k[29] = photo("o2")
    k[30] = photo("o3_1")
    k[31] = photo("o3_2")
    k[32] = photo("h2o")
    k[33] = photo("h2o2")
    k[34] = photo("n2o")
    k[35] = photo("ccl3f")
    k[36] = photo("ccl3f")   # reference uses ccl3f table for both
    # Aqueous SO2 + H2O2 (chem.kpp:176-190)
    kaq = 9.1e7 * torch.exp(-29700.0 / RI * (1.0 / t - 1.0 / 298.15)) \
        / (AVO * 1e-3) ** 2
    H_SO2 = 1.3e-2 * torch.exp(2900.0 * (1.0 / t - 1.0 / 298.15)) * RI * t
    K_1S = 1.23e-2 * torch.exp(2.01e3 * (1.0 / t - 1.0 / 298.15)) \
        * AVO * 1e-3
    H_h2o2 = 8.3e2 * torch.exp(7600.0 * (1.0 / t - 1.0 / 298.15)) * RI * t
    rho_air = 100.0 * p / (RI * t) * MA / 1000.0
    CWC = lwc * rho_air / 1000.0
    k[37] = kaq * K_1S * H_SO2 * H_h2o2 * CWC
    k[38] = _k3rd_jpl(t, M, 2.9e-31, 4.1, 1.7e-12, -0.2)
    return torch.stack(k, dim=-1)


def _rates(c, fix, rconst, tables):
    """(exp(lograte), rates) of a batch: lograte = REACT_V log c +
    REACT_F log fix with the concentrations floored at 1e-30."""
    _, react_vt, react_ft, _, _ = tables
    logc = torch.log(torch.clamp(c, min=1e-30))
    logf = torch.log(torch.clamp(fix, min=1e-30))
    e = torch.exp(logc @ react_vt + logf @ react_ft)
    return e, rconst * e


def _rhs(c, fix, rconst, tables):
    """dC/dt of a batch [B, NVAR]: rates = k * prod(C^order), S^T r."""
    return _rates(c, fix, rconst, tables)[1] @ tables[3]


def _jacobian(c, fix, rconst, tables):
    """(f, J) of a batch: dC/dt and its Jacobian [B, NVAR, NVAR]."""
    react_v, _, _, net_v, net_vt = tables
    e, rates = _rates(c, fix, rconst, tables)
    inv = torch.where(c > 1e-30, 1.0 / c, torch.zeros_like(c))
    # the tangent of the rates along each c_j, as jacfwd forms it
    tan = rconst[:, :, None] * ((react_v[None] * inv[:, None, :])
                                * e[:, :, None])
    return rates @ net_v, net_vt @ tan


# Rodas3 coefficients (KPP int/rosenbrock.f90 SUBROUTINE Rodas3; the
# reference selects method 4 = Rodas3 in module_kpp_chem, c:5044)
_GAMMA = 0.5
_ALPHA = ((0.0, 0.0, 0.0, 0.0),
          (0.0, 0.0, 0.0, 0.0),
          (2.0, 0.0, 0.0, 0.0),
          (2.0, 0.0, 1.0, 0.0))
_C = ((0.0, 0.0, 0.0, 0.0),
      (4.0, 0.0, 0.0, 0.0),
      (1.0, -1.0, 0.0, 0.0),
      (1.0, -1.0, -8.0 / 3.0, 0.0))
_M = (2.0, 0.0, 1.0, 1.0)
_E = (0.0, 0.0, 0.0, 1.0)


def rosenbrock_step(c, fix, rconst, h, tables=None):
    """One Rodas3 step of a batch with steps ``h`` [B]; returns
    (c_new clamped at 0, err_norm [B])."""
    if tables is None:
        tables = _tables(c.device)
    f0, J = _jacobian(c, fix, rconst, tables)
    eye = torch.eye(NVAR, dtype=c.dtype, device=c.device)
    A = eye[None] / (h * _GAMMA)[:, None, None] - J
    del J
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    del A
    hh = h[:, None]
    ks = []
    for i in range(4):
        ci = c
        for j in range(i):
            ci = ci + _ALPHA[i][j] * ks[j]
        fi = f0 if i in (0, 1) else _rhs(ci, fix, rconst, tables)
        rhs = fi
        for j in range(i):
            rhs = rhs + (_C[i][j] / hh) * ks[j]
        ks.append(torch.linalg.lu_solve(lu, piv, rhs[:, :, None])[:, :, 0])
    c_new = c
    for i in range(4):
        c_new = c_new + _M[i] * ks[i]
    err_vec = sum(_E[i] * ks[i] for i in range(4))
    scale = 1.0 + torch.abs(c_new) * 1e-3
    err = torch.sqrt(torch.mean((err_vec / scale) ** 2, dim=-1))
    return torch.clamp(c_new, min=0.0), err


#: the batch of the integration loop shrinks to the parcels still
#: running, in multiples of this many parcels (see ``integrate``)
COMPACT_ALIGN = 16


def integrate(c0, fix, rconst, dt: float, rtol=1e-3, max_steps=1000):
    """Adaptive Rodas3 integration of a batch of parcels over ``dt``;
    returns (c_final, steps taken by each parcel).

    Step control follows KPP's ros_Integrator (rosenbrock.f90): safety
    factor 0.9, growth capped x5, shrink capped x0.2, and growth
    disabled immediately after a rejection (RejectLastH memory).  A
    non-finite error norm counts as 1e10; the step is clipped to
    [1e-12 dt, dt]; a parcel stops at ``dt`` or after ``max_steps``.

    The loop steps the parcels that still run; a parcel that has
    stopped is held, as the JAX package's batched select holds it.
    When an eighth of the batch has stopped, the batch shrinks to the
    running parcels (with stopped ones to fill a multiple of
    ``COMPACT_ALIGN``: PyTorch's CPU loops round a batch's remainder
    differently, so a parcel's result does not depend on the batch)."""
    tables = _tables(c0.device)
    b = c0.shape[0]
    kw = dict(dtype=c0.dtype, device=c0.device)
    c_out = c0.clone()
    n_out = torch.zeros(b, dtype=torch.int32, device=c0.device)
    idx = torch.arange(b, device=c0.device)
    t = torch.zeros(b, **kw)
    h = torch.full((b,), dt * 1e-6, **kw)
    c = c0
    n = n_out.clone()
    rejected = torch.zeros(b, dtype=torch.bool, device=c0.device)
    while True:
        run = (t < dt * (1.0 - 1e-12)) & (n < max_steps)
        nrun = int(run.sum())
        if nrun == 0:
            break
        size = -(-nrun // COMPACT_ALIGN) * COMPACT_ALIGN
        if 8 * size <= 7 * idx.shape[0]:
            c_out[idx], n_out[idx] = c, n
            # the running parcels first, then stopped ones to fill
            keep = torch.argsort((~run).to(torch.int8), stable=True)[:size]
            idx, t, h, c, n, rejected, run = (
                x[keep] for x in (idx, t, h, c, n, rejected, run))
            fix, rconst = fix[keep], rconst[keep]
        h_eff = torch.minimum(h, dt - t)
        c_new, err = rosenbrock_step(c, fix, rconst, h_eff, tables)
        err = torch.where(torch.isfinite(err), err,
                          torch.full_like(err, 1e10))
        accept = err <= 1.0
        fac = torch.clamp(0.9 * torch.clamp(err, min=1e-10) ** (-1.0 / 3.0),
                          0.2, 5.0)
        fac = torch.where(accept & rejected, torch.clamp(fac, max=1.0), fac)
        step = run & accept
        t = torch.where(step, t + h_eff, t)
        c = torch.where(step[:, None], c_new, c)
        h = torch.where(run, torch.clamp(h_eff * fac, 1e-12 * dt, dt), h)
        n = torch.where(run, n + 1, n)
        rejected = torch.where(run, ~accept, rejected)
    c_out[idx], n_out[idx] = c, n
    return c_out, n_out


def _kpp_pass(ctl: Ctl, clim: Clim, met01: Met, time, lon, lat, p, q,
              active):
    """The chemistry of one pass of parcels: writes the new
    concentrations, ``m`` and ``mloss_kpp`` into ``q`` (slices of the
    state's quantities) and returns the steps each parcel took.  The
    met values are sampled in the state's dtype and the chemistry runs
    in float64 (``clim`` is the float64 one)."""
    names = mechanism().var_species
    f64 = torch.float64
    loc = interp.locate_3d(met01, lon, lat, p)
    t, lwc, h2o, o3 = (interp.interp_time_3d(met01, name, time, loc).to(f64)
                       for name in ("t", "lwc", "h2o", "o3"))
    o3c = interp.interp_time_2d(met01, "o3c", time, loc).to(f64)
    del loc
    lon, lat, p = lon.to(f64), lat.to(f64), p.to(f64)
    M = molec_dens(p, t)
    sza = torch.arccos(torch.clamp(cos_sza(time, lon, lat), -1.0, 1.0))
    rconst = rate_constants(clim, t, M, p, sza, o3c, lwc)
    del t, lwc, sza, o3c

    # Assemble concentrations [np, NVAR] in molec/cm^3
    cols = []
    for sp in names:
        if sp == "h2o":
            cols.append(h2o * M)
        elif sp == "o3":
            cols.append(o3 * M)
        elif sp in SPECIES_QNT and SPECIES_QNT[sp] in q:
            cols.append(q[SPECIES_QNT[sp]] * M)
        else:
            cols.append(torch.zeros_like(M))
    c0 = torch.stack(cols, dim=-1)
    del cols, h2o, o3
    # FIX order is (o2, h2, n2) per the mechanism tables
    fix = torch.stack([0.2095 * M, 5e-7 * M, 0.7808 * M], dim=-1)

    c_final, steps = integrate(c0, fix, rconst, ctl.dt_kpp)

    # Write back (kpp_chem_output2atm, chem.kpp C_UTIL)
    for i, sp in enumerate(names):
        qnt = SPECIES_QNT.get(sp)
        if qnt and qnt in q:
            dtype = q[qnt].dtype
            new = c_final[:, i] / M
            if qnt == "Cx" and "m" in q:
                # track SO2 mass loss like the reference couples Cx->m
                ratio = torch.where(
                    c0[:, i] > 0,
                    c_final[:, i] / torch.clamp(c0[:, i], min=1e-30), 1.0)
                m = q["m"]
                if "mloss_kpp" in q:
                    q["mloss_kpp"].copy_(torch.where(
                        active, q["mloss_kpp"] + m * (1.0 - ratio),
                        q["mloss_kpp"]))
                m.copy_(torch.where(active, m * ratio, m))
            q[qnt].copy_(torch.where(active, new.to(dtype), q[qnt]))
    return steps


@span("kpp")
def module_kpp_chem(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                    atm: Atm, stats: Optional[dict] = None) -> Atm:
    """Full-chemistry step over DT_KPP (reference module_kpp_chem,
    c:5001), in passes of ``KPP_CHUNK`` parcels.  ``stats``, where
    given, receives the pass size and the Rosenbrock steps of the
    slowest parcel and their mean over the parcels."""
    active = (cache.dt != 0.0) & atm.mask
    written = set(SPECIES_QNT.values()) | {"m", "mloss_kpp"}
    q = {k: v.clone() if k in written else v for k, v in atm.q.items()}
    if clim.photo_p.dtype != torch.float64:
        clim = _map_tensors(clim, lambda a: a.to(torch.float64)
                            if a.dtype == torch.float32 else a)
    steps = torch.zeros(atm.npmax, dtype=torch.int32, device=atm.p.device)
    for s in range(0, atm.npmax, KPP_CHUNK):
        e = min(atm.npmax, s + KPP_CHUNK)
        steps[s:e] = _kpp_pass(ctl, clim, met01, atm.time[s:e],
                               atm.lon[s:e], atm.lat[s:e], atm.p[s:e],
                               {k: v[s:e] for k, v in q.items()},
                               active[s:e])
    if stats is not None:
        live = steps[active]
        stats.update(chunk=KPP_CHUNK, steps_max=int(live.max()),
                     steps_mean=float(live.double().mean()))
    return atm.replace(q=q)
