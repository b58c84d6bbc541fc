"""Sedimentation (reference module_sedi, mptrac.c:5671-5699).
Counterpart of the JAX package's ``physics/sedi.py``: Stokes settling
velocity with Cunningham slip correction applied as a pressure
tendency."""

from __future__ import annotations

import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.ops import interp
from mptrac_tpu_torch.ops.thermo import dz2dp, sedi_velocity
from mptrac_tpu_torch.types import Atm, Cache, Met
from mptrac_tpu_torch.utils.timers import span


@span("sedi")
def module_sedi(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    active = (cache.dt != 0.0) & atm.mask
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    del loc
    v_s = sedi_velocity(atm.p, t, atm.q["rp"], atm.q["rhop"])
    p_new = atm.p + dz2dp(v_s * cache.dt / 1000.0, atm.p)
    return atm.replace(p=torch.where(active, p_new, atm.p))
