"""The plain reference (``reference.py``, with the parameters of
``CTL_DEFAULTS``): the reference that a configuration uses where it
names none.  What the checks take from a reference:

* ``MODELS``: the control keys of a configuration that it models, each
  with the values it models (None: any value); ``PATH_KEYS``: the keys
  that choose the program's path and not its physics.  A configuration
  that sets any other key, or another value, is refused before the run
  (``checks.unmodelled``);
* ``params(pairs)``: its parameters from the cell's ``KEY VALUE`` list;
* ``load_clim(files)``: its climatologies from the configuration's
  ``clim_files`` (key -> path);
* ``met_pair(times, a, b)``: its met pair from two snapshots ``(lon,
  lat, p, fields2d, fields3d)``, with ``astype(dtype)``;
* ``step_versions`` and ``step`` (``dtype``: bfloat16 for the control);
* ``ingest(path, dtype)``: the snapshot it derives from one met file of
  the series, and ``INGESTED``: the fields of the program's met pair
  compared with it.
"""

import torch

from benchmark import reference

#: MPTRAC's defaults of the control parameters this reference reads
#: (mptrac.c read_ctl), and the SO2 preset of SPECIES
CTL_DEFAULTS = {
    "dt_met": 3600.0, "turb_pbl_trans": 0.0, "turb_dx_pbl": 50.0,
    "turb_dx_trop": 50.0, "turb_dx_strat": 0.0, "turb_dz_pbl": 0.0,
    "turb_dz_trop": 0.0, "turb_dz_strat": 0.1, "turb_mesox": 0.16,
    "turb_mesoz": 0.16, "conv_mix_pbl": 0, "conv_cape": -999.0,
    "conv_pbl_trans": 0.0, "tdec_trop": 0.0, "tdec_strat": 0.0,
    "oh_chem_reaction": 0, "oh_chem": (0.0, 0.0, 0.0, 0.0),
    "h2o2_chem_reaction": 0, "wet_depo_ic_a": 0.0, "wet_depo_ic_b": 0.0,
    "wet_depo_bc_a": 0.0, "wet_depo_bc_b": 0.0,
    "wet_depo_pre": (0.5, 0.36), "wet_depo_ic_ret_ratio": 1.0,
    "wet_depo_bc_ret_ratio": 1.0, "dry_depo_vdep": 0.0,
    "dry_depo_dp": 30.0, "t_start": 0.0, "t_stop": 0.0,
}
SPECIES = {"SO2": {"oh_chem_reaction": 3,
                   "oh_chem": (2.9e-31, 4.1, 1.7e-12, -0.2)}}

#: the configuration's keys that this reference models and their values:
#: midpoint advection, the turbulent and mesoscale diffusion with the
#: Squares draws, decay, convection of the boundary layer and to the
#: equilibrium level, OH chemistry of reaction type 3, H2O2 chemistry,
#: wet deposition by the a/b scheme (Henry's constants are read only
#: where a scheme's a is 0, which ``reference.py`` refuses), dry
#: deposition; the quantities t and m
MODELS = {
    "NQ": ("2",), "QNT_NAME[0]": ("t",), "QNT_NAME[1]": ("m",),
    "T_STOP": None, "ADVECT": ("2",), "DIFFUSION": ("1",),
    "RNG_TYPE": ("1",), "TURB_PBL_TRANS": None, "TURB_DX_PBL": None,
    "TURB_DX_TROP": None, "TURB_DX_STRAT": None, "TURB_DZ_PBL": None,
    "TURB_DZ_TROP": None, "TURB_DZ_STRAT": None, "TURB_MESOX": None,
    "TURB_MESOZ": None, "TDEC_TROP": None, "TDEC_STRAT": None,
    "CONV_MIX_PBL": ("0", "1"), "CONV_CAPE": None, "CONV_PBL_TRANS": None,
    "SPECIES": tuple(SPECIES), "OH_CHEM_REACTION": ("0", "3"),
    "H2O2_CHEM_REACTION": ("0", "1"), "WET_DEPO_IC_A": None,
    "WET_DEPO_IC_B": None, "WET_DEPO_BC_A": None, "WET_DEPO_BC_B": None,
    "WET_DEPO_IC_RET_RATIO": None, "WET_DEPO_BC_RET_RATIO": None,
    "WET_DEPO_IC_H[0]": None, "WET_DEPO_BC_H[0]": None,
    "DRY_DEPO_VDEP": None, "DRY_DEPO_DP": None,
    "CLIM_OH_FILENAME": None, "CLIM_H2O2_FILENAME": None,
}
#: keys that choose the program's path (the kernels, the sort, the step
#: length), which the reference follows step by step
PATH_KEYS = ("TPU_FAST", "SORT_DT", "DT_MOD")

#: the fields of the program's met pair compared with ``ingest``'s
INGESTED = ("u", "v", "w", "t", "ps", "pbl")

_NAMES2 = ("ps", "pbl", "cape", "pel", "pct", "pcb", "cl")
_NAMES3 = ("u", "v", "w", "t", "lwc", "rwc", "iwc", "swc")

step_versions = reference.step_versions
step = reference.step


def params(pairs: list) -> dict:
    """The reference's parameters from a ``KEY VALUE`` list (the keys
    MPTRAC's control file names)."""
    kv = dict(zip(pairs[0::2], pairs[1::2]))
    out = dict(CTL_DEFAULTS)
    out.update(SPECIES.get(kv.get("SPECIES", "-"), {}))
    for key, val in kv.items():
        k = key.lower()
        if k == "t_stop":
            out["t_stop"] = float(val)
        elif k in out and not isinstance(out[k], tuple):
            out[k] = type(out[k])(float(val))
    return out


def load_clim(files: dict) -> reference.Clim:
    return reference.load_clim(files.get("CLIM_OH_FILENAME"),
                               files.get("CLIM_H2O2_FILENAME"))


def met_pair(times, a, b) -> reference.Met:
    """The pair of the fields the step reads that the snapshots hold."""
    lon, lat, p, f2, f3 = a
    return reference.met_pair(
        times, lon, lat, p, f2, f3, b[3], b[4],
        names2=tuple(k for k in _NAMES2 if k in f2),
        names3=tuple(k for k in _NAMES3 if k in f3))


def ingest(path: str, dtype=torch.float32) -> tuple:
    s = reference.ingest_nc(path, dtype)
    return s["lon"], s["lat"], s["p"], s["f2"], s["f3"]
