"""What decides ``correct``: the timed path's products against the
configuration's reference (``references/<name>.py``, passed in as
``ref``; ``references/plain.py`` by default).

* ``unmodelled``: the configuration's control keys and values that the
  reference does not model (the run is refused before it starts).
* ``sample``: the state of sampled parcel slots, gathered on the device
  into one small block and copied to the host (the driver takes it
  before and after the checked steps, in the period after the window).
* ``state_hash``: an order-free hash of every parcel of the state, taken
  before and after each sort of that period (a sort that loses,
  duplicates or mixes parcels changes it).
* ``step_gaps``: the reference's step from the captured state, and the
  largest gaps between the program's result and it (a parcel at a
  threshold is held to the nearer of the reference's two sides).
* ``ingest_gaps``: the program's met pair against the fields the
  reference derives from the files.

Every number compared has a limit in the cell's workload file; the
limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

#: MPTRAC's earth radius [km] (mptrac.h RE): the yardstick of ``pos_km``,
#: and the radius of the plain reference (``reference.py``)
RE = 6367.421


def __getattr__(name: str):
    """``CTL_DEFAULTS`` and ``SPECIES``: the plain reference's (its
    defaults of MPTRAC's control parameters, the SO2 preset of
    SPECIES), under the names they had here."""
    if name in ("CTL_DEFAULTS", "SPECIES"):
        from benchmark import manifest
        return getattr(manifest.reference({}), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _same_value(a: str, b: str) -> bool:
    try:
        return float(a) == float(b)
    except ValueError:
        return a == b


def unmodelled(cfg: dict, ref) -> List[str]:
    """The ``KEY VALUE`` entries of configuration ``cfg`` (its ``ctl`` and
    its ``clim_files``) that reference ``ref`` models neither as physics
    (``ref.MODELS``, the key with any value or one of the values listed)
    nor as the program's path (``ref.PATH_KEYS``)."""
    pairs = cfg["ctl"]
    entries = dict(zip(pairs[0::2], pairs[1::2]), **cfg.get("clim_files", {}))
    out = []
    for key, val in entries.items():
        if key in ref.PATH_KEYS:
            continue
        allowed = ref.MODELS.get(key, ())
        if allowed is not None and not any(_same_value(val, a)
                                           for a in allowed):
            out.append(f"{key} {val}")
    return out


# ------------------------------------------------------------- capture

STATE_KEYS = ("time", "lon", "lat", "p", "t", "m", "u", "v", "w")


def _columns(atm, cache) -> Dict[str, torch.Tensor]:
    return {"time": atm.time, "lon": atm.lon, "lat": atm.lat, "p": atm.p,
            "t": atm.q["t"], "m": atm.q["m"], "u": cache.uvwp[0],
            "v": cache.uvwp[1], "w": cache.uvwp[2]}


def sample(atm, cache, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The state of the parcel slots ``idx`` (a tensor on the state's
    device): gathered on the device into one small float64 block (every
    column's values exact) and copied to the host (a wait for the device
    at this step, of a few hundred kB)."""
    cols = _columns(atm, cache)
    block = torch.stack([torch.index_select(cols[k], 0, idx)
                         .to(torch.float64) for k in STATE_KEYS]).cpu()
    return dict(zip(STATE_KEYS, block))


# ----------------------------------------------------------------- hash

_HASH_K = (0x2545F491, 0x1B873593, 0x5BD1E995, 0x27D4EB2F, 0x165667B1,
           0x3C6EF372, 0x61C88647, 0x7FEB352D, 0x68E31DA4, 0x0B5297A4,
           0x1D8E4E27)


def state_hash(atm, cache) -> torch.Tensor:
    """An int64 device scalar, the same for any order of the parcels:
    each parcel's columns (bit patterns, the float64 time as two words)
    combined linearly with odd constants in wrapping int32 arithmetic,
    mixed, and summed over the parcels."""
    cols = _columns(atm, cache)
    words = cols["time"].contiguous().view(torch.int32)
    h = words[0::2] * _HASH_K[0]
    h.add_(words[1::2], alpha=_HASH_K[1])
    for k, name in enumerate(STATE_KEYS[1:]):
        h.add_(cols[name].contiguous().view(torch.int32),
               alpha=_HASH_K[2 + k])
    h.bitwise_xor_(torch.bitwise_right_shift(h, 15) & 0x1FFFF)
    h.mul_(0x2C1B3C6D)
    h.bitwise_xor_(torch.bitwise_right_shift(h, 13) & 0x7FFFF)
    return h.sum(dtype=torch.int64)


# ------------------------------------------------------------ comparing

#: the numbers of a step: the largest gap over the sampled parcels of
#: the horizontal position (km), pressure and mass (relative), the
#: sampled temperature (K), the mesoscale wind memory (m/s) and the time
#: (s)
STEP_NUMBERS = ("pos_km", "p_rel", "m_rel", "t_abs", "uvw_abs", "time_abs")


def _rel(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """|g - e| / |e|, 0 where both are 0."""
    d = torch.abs(g - e)
    return torch.where(d == 0, 0.0, d / torch.abs(e))


def _max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    x = torch.where(torch.isnan(x), torch.full_like(x, math.inf), x)
    return float(x.max())


def _nearest(got: dict, versions: List[dict]) -> dict:
    """Per parcel, the version whose pressure and mass lie nearest the
    program's (the versions differ only in parcels at a threshold)."""
    if len(versions) == 1:
        return versions[0]
    score = torch.stack([_rel(got["p"], v["p"]) + _rel(got["m"], v["m"])
                         for v in versions])
    pick = torch.nan_to_num(score, nan=math.inf).argmin(0)
    return {k: torch.stack([v[k] for v in versions]).gather(
        0, pick[None])[0] for k in STATE_KEYS}


def gaps(got: dict, exp) -> Dict[str, float]:
    """The largest gaps of ``got`` from ``exp`` (float64 dicts of the
    state columns, or a list of the reference's versions of them: see
    ``reference.step_versions``); a value that is not finite reads
    infinite."""
    g = {k: got[k].to(torch.float64) for k in STATE_KEYS}
    versions = exp if isinstance(exp, list) else [exp]
    e = _nearest(g, [{k: v[k].to(torch.float64) for k in STATE_KEYS}
                     for v in versions])
    dlon = torch.remainder(g["lon"] - e["lon"] + 180.0, 360.0) - 180.0
    dlat = g["lat"] - e["lat"]
    coslat = torch.cos(e["lat"] * (math.pi / 180.0))
    pos = torch.sqrt(dlat ** 2 + (dlon * coslat) ** 2) * (math.pi * RE
                                                         / 180.0)
    out = {
        "pos_km": _max(pos),
        "p_rel": _max(_rel(g["p"], e["p"])),
        "m_rel": _max(_rel(g["m"], e["m"])),
        "t_abs": _max(torch.abs(g["t"] - e["t"])),
        "uvw_abs": max(_max(torch.abs(g[k] - e[k])) for k in "uvw"),
        "time_abs": _max(torch.abs(g["time"] - e["time"])),
    }
    for k in STATE_KEYS:
        if not bool(torch.isfinite(g[k]).all()):
            out[_NUMBER_OF[k]] = math.inf
    return out


def combine(per_step: List[dict]) -> Dict[str, float]:
    """The numbers of a run from its checked steps: the largest gap."""
    return {key: max((r[key] for r in per_step), default=0.0)
            for key in STEP_NUMBERS}


#: the number that a state column's gap counts in
_NUMBER_OF = {"lon": "pos_km", "lat": "pos_km", "p": "p_rel", "m": "m_rel",
              "t": "t_abs", "u": "uvw_abs", "v": "uvw_abs", "w": "uvw_abs",
              "time": "time_abs"}


def step_gaps(ref, pairs: List[tuple], ctl: dict, met_for, clim,
              total: int, slots: torch.Tensor,
              dtype=torch.float64) -> List[dict]:
    """For each checked step (before, after): the gaps of the program's
    ``after`` from reference ``ref``'s step of ``before`` computed in
    ``dtype``, and of the reference in ``dtype`` against float64 when
    ``dtype`` is not float64 (the control)."""
    out = []
    for before, after in pairs:
        t = before["t_step"]
        met = met_for(t)
        exp = ref.step_versions(ctl, met, clim, before["state"], t,
                                before["ctr"], total, slots)
        if dtype == torch.float64:
            got = {k: after["state"][k] for k in STATE_KEYS}
        else:
            got = ref.step(ctl, met.astype(dtype), clim, before["state"], t,
                           before["ctr"], total, slots, dtype)
        out.append(dict(t=t, **gaps(got, exp)))
    return out


def ingest_gaps(pair_fields: dict, pair_times, expected: List[tuple],
                exp_times) -> Dict[str, float]:
    """``met_rel``: the largest relative gap of the program's pair (the
    fields the reference ingests; numpy [2, ...]) from the fields the
    reference derived from the pair's two files (snapshots ``(lon, lat,
    p, fields2d, fields3d)``); ``met_time``: the gap of the pair's
    times."""
    worst = 0.0
    for name, got in pair_fields.items():
        for s in (0, 1):
            e = expected[s][4].get(name, expected[s][3].get(name))
            g = got[s].astype(np.float64)
            e = e.astype(np.float64)
            if g.shape != e.shape:
                return {"met_rel": math.inf, "met_time": math.inf}
            scale = max(float(np.max(np.abs(e))), 1e-30)
            d = np.abs(g - e) / scale
            worst = max(worst, float(np.max(np.where(np.isnan(d), np.inf,
                                                     d))))
    tgap = max(abs(float(a) - float(b)) for a, b in zip(pair_times,
                                                          exp_times))
    return {"met_rel": worst, "met_time": tgap}
