"""Per-timestep module pipeline.

Counterpart of the JAX package's ``physics/pipeline.py:31-207`` (the
reference ``mptrac_run_timestep``, mptrac.c:7545-7694): the fixed
module order with the enables resolved from Ctl on the host.  Eager:
one call runs one step.  Every module of the JAX step is ported: timesteps,
position, advection on pressure levels (fused, unfused through the
kernels, or exact), on model levels and in zeta/eta
(``ADVECT_VERT_COORD`` 1-3, exact), turbulent diffusion, the PBL scheme
(``TURB_PBL_SCHEME 1``), mesoscale diffusion, convection,
sedimentation, the isosurface constraint (``ISOSURF`` 1-4), meteo
sampling, boundary conditions, decay, mixing, the chemistry grid, OH /
H2O2 / tracer chemistry, radioactive decay, KPP chemistry, wet and dry
deposition, and the first-step initialisation (``init_modules``: the
isosurface, the zeta coordinate, the chemistry).  The pack decides the
path: with ``pack.cell`` the fused RK kernel (pressure levels only, as
in the JAX step), with ``pack.packT`` the unfused kernels, without a
pack (or with a float64 state) the exact interpolation.  Off pressure
levels the advection is the exact model-level one, and the kernels'
tables still serve the diffusion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops.fast_interp import MetPack
from mptrac_tpu_torch.physics import advect as m_advect
from mptrac_tpu_torch.physics import bound as m_bound
from mptrac_tpu_torch.physics import chem as m_chem
from mptrac_tpu_torch.physics import convection as m_conv
from mptrac_tpu_torch.physics import decay as m_decay
from mptrac_tpu_torch.physics import depo as m_depo
from mptrac_tpu_torch.physics import diffusion as m_diff
from mptrac_tpu_torch.physics import isosurf as m_isosurf
from mptrac_tpu_torch.physics import kpp as m_kpp
from mptrac_tpu_torch.physics import meteo as m_meteo
from mptrac_tpu_torch.physics import mixing as m_mixing
from mptrac_tpu_torch.physics import pbl as m_pbl
from mptrac_tpu_torch.physics import position as m_position
from mptrac_tpu_torch.physics import sedi as m_sedi
from mptrac_tpu_torch.physics import timesteps as m_timesteps
from mptrac_tpu_torch.types import Atm, Cache, Clim, Met


class StepFlags(NamedTuple):
    """Per-step gates evaluated by the run loop (fmod of the wall-clock
    time against module intervals, reference c:7599, 7638, 7645)."""
    do_conv: bool = True
    do_mixing: bool = True
    do_kpp: bool = True
    do_meteo: bool = True


def run_timestep(ctl: Ctl, clim: Clim, met01: Met, atm: Atm, cache: Cache,
                 t: float, flags: StepFlags = StepFlags(),
                 pack: MetPack = None):
    """One model timestep; mirrors the reference module order.

    ``t`` is the model time (Python float); ``pack`` the gather tables
    of ``ops.fast_interp.build_met_pack`` or None."""
    # The kernels compute in float32: their tables serve only the
    # float32 compute mode
    fp32 = met01.lon.dtype == torch.float32
    packT = pack.packT if pack is not None and fp32 else None
    sigT = pack.sigT if pack is not None and fp32 else None
    sfcT = pack.sfcT if pack is not None and fp32 else None
    # Per-cell fused-RK kernel (ops.rk_fused): advect + meso sigma +
    # meteo T in ONE pass
    cell = (pack.cell if pack is not None and fp32
            and ctl.advect_vert_coord == 0 and ctl.advect in (1, 2, 4)
            else None)

    # Set timesteps of air parcels
    cache = m_timesteps.module_timesteps(ctl, cache, met01, atm, t)

    # (module_sort is a performance transform, handled by the run loop)

    # Check positions (initial)
    atm = m_position.module_position(cache, met01, atm)

    # Advection
    fused_sig = None
    fused_t = None
    if ctl.advect > 0:
        if cell is not None:
            atm, cache, fused_sig, fused_t = m_advect.module_advect_fused(
                ctl, cache, met01, atm, cell)
        else:
            atm, cache = m_advect.module_advect(ctl, cache, met01, atm,
                                                packT)

    # Turbulent diffusion
    if ctl.diffusion and (
            ctl.turb_dx_pbl > 0 or ctl.turb_dz_pbl > 0
            or ctl.turb_dx_trop > 0 or ctl.turb_dz_trop > 0
            or ctl.turb_dx_strat > 0 or ctl.turb_dz_strat > 0):
        atm, cache = m_diff.module_diff_turb(ctl, cache, clim, met01,
                                             atm, sfcT)

    # PBL diffusion scheme
    if ctl.diffusion and ctl.turb_pbl_scheme == 1:
        atm, cache = m_pbl.module_diff_pbl(ctl, cache, met01, atm)

    # Mesoscale diffusion
    if ctl.diffusion and (ctl.turb_mesox > 0 or ctl.turb_mesoz > 0):
        atm, cache = m_diff.module_diff_meso(ctl, cache, met01, atm,
                                             packT, sig=fused_sig,
                                             sigT=sigT)

    # Convection
    if (ctl.conv_mix_pbl or ctl.conv_cape >= 0) and flags.do_conv:
        atm, cache = m_conv.module_convection(ctl, cache, met01, atm)

    # Sedimentation
    if ctl.qnt("rp") >= 0 and ctl.qnt("rhop") >= 0:
        atm = m_sedi.module_sedi(ctl, cache, met01, atm)

    # Isosurface
    if 1 <= ctl.isosurf <= 4:
        atm = m_isosurf.module_isosurf(ctl, cache, met01, atm)

    # Check positions (final)
    atm = m_position.module_position(cache, met01, atm)

    # Interpolate meteo data
    if ctl.met_dt_out > 0 and flags.do_meteo:
        atm = m_meteo.module_meteo(
            ctl, cache, clim, met01, atm, pack,
            pre3d={"t": fused_t} if fused_t is not None else None)

    # Boundary conditions (initial)
    bound_on = (ctl.bound_lat0 < ctl.bound_lat1
                and ctl.bound_p0 > ctl.bound_p1)
    if bound_on:
        atm = m_bound.module_bound_cond(ctl, cache, clim, met01, atm)

    # Initialize total loss rate
    if ctl.qnt("loss_rate") >= 0:
        q = dict(atm.q)
        q["loss_rate"] = torch.where((cache.dt != 0) & atm.mask, 0.0,
                                     q["loss_rate"])
        atm = atm.replace(q=q)

    # Exponential decay
    if ctl.tdec_trop > 0 and ctl.tdec_strat > 0:
        atm = m_decay.module_decay(ctl, cache, clim, atm)

    # Interparcel mixing
    if (ctl.mixing_trop >= 0 and ctl.mixing_strat >= 0
            and flags.do_mixing):
        atm = m_mixing.module_mixing(ctl, clim, atm, t)

    # Chemistry grid
    if (ctl.oh_chem_reaction != 0 or ctl.h2o2_chem_reaction != 0
            or (ctl.kpp_chem and flags.do_kpp)):
        atm = m_chem.module_chem_grid(ctl, met01, atm, t)

    # OH chemistry
    if ctl.oh_chem_reaction != 0:
        atm = m_chem.module_oh_chem(ctl, cache, clim, met01, atm)

    # H2O2 chemistry
    if ctl.h2o2_chem_reaction != 0:
        atm = m_chem.module_h2o2_chem(ctl, cache, clim, met01, atm)

    # First-order tracer chemistry
    if ctl.tracer_chem:
        atm = m_chem.module_tracer_chem(ctl, cache, clim, met01, atm)

    # Radioactive decay
    if ctl.radio_decay:
        atm = m_decay.module_radio_decay(ctl, cache, atm)

    # KPP full chemistry
    if ctl.kpp_chem and flags.do_kpp:
        atm = m_kpp.module_kpp_chem(ctl, cache, clim, met01, atm)

    # Wet deposition
    if ((ctl.wet_depo_ic_a > 0 or ctl.wet_depo_ic_h[0] > 0)
            and (ctl.wet_depo_bc_a > 0 or ctl.wet_depo_bc_h[0] > 0)):
        atm = m_depo.module_wet_depo(ctl, cache, met01, atm)

    # Dry deposition
    if ctl.dry_depo_vdep > 0:
        atm = m_depo.module_dry_depo(ctl, cache, met01, atm)

    # Boundary conditions (final)
    if bound_on:
        atm = m_bound.module_bound_cond(ctl, cache, clim, met01, atm)

    return atm, cache


def init_modules(ctl: Ctl, clim: Clim, met01: Met, atm: Atm, cache: Cache):
    """First-step module initialization (reference c:7556-7567)."""
    if 1 <= ctl.isosurf <= 4:
        cache = m_isosurf.module_isosurf_init(ctl, cache, met01, atm)
    atm = m_advect.module_advect_init(ctl, met01, atm)
    atm = m_chem.module_chem_init(ctl, clim, met01, atm)
    return atm, cache
