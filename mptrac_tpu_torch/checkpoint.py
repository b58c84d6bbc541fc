"""Checkpoint / resume.

Counterpart of the JAX package's ``checkpoint.py``, with its file
format: the full simulation state (particle arrays, the per-parcel cache
with the AR(1) perturbations, the isosurface variable and the balloon
track, the RNG counter, the model time) in one compressed npz file with
a JSON ``__header__`` (``FORMAT_VERSION`` 1), written to ``<path>.tmp``
and moved into place.  A checkpoint of either package loads in the
other.  The port's host values (``Atm.np``, ``Cache.rng_ctr``,
``Cache.iso_n``) are stored as the JAX package stores its scalars:
int32, uint64 and int32 arrays.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mptrac_tpu_torch.types import Atm, Cache, resolve_device

FORMAT_VERSION = 1


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str, atm: Atm, cache: Cache, t: float,
                    meta: Optional[dict] = None) -> None:
    arrays = {
        "time": _host(atm.time),
        "p": _host(atm.p),
        "lon": _host(atm.lon),
        "lat": _host(atm.lat),
        "np": np.asarray(atm.np, dtype=np.int32),
        "uvwp": _host(cache.uvwp),
        "dt": _host(cache.dt),
        "rng_ctr": np.asarray(cache.rng_ctr, dtype=np.uint64),
        "iso_var": _host(cache.iso_var),
        "iso_ps": _host(cache.iso_ps),
        "iso_ts": _host(cache.iso_ts),
        "iso_n": np.asarray(cache.iso_n, dtype=np.int32),
    }
    for name, v in atm.q.items():
        arrays[f"q_{name}"] = _host(v)
    header = dict(version=FORMAT_VERSION, t=float(t),
                  qnt=[n for n in atm.q], meta=meta or {})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __header__=json.dumps(header), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[Atm, Cache, float, dict]:
    """(atm, cache, model time, meta) of a checkpoint, its tensors on
    ``device`` in the dtypes of the file."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as d:
        header = json.loads(str(d["__header__"]))
        if header["version"] != FORMAT_VERSION:
            raise ValueError(
                f"Unsupported checkpoint version {header['version']}")

        def t(name):
            return torch.from_numpy(np.array(d[name])).to(dev)

        atm = Atm(time=t("time"), p=t("p"), lon=t("lon"), lat=t("lat"),
                  q={n: t(f"q_{n}") for n in header["qnt"]},
                  np=int(d["np"]))
        cache = Cache(uvwp=t("uvwp"), dt=t("dt"), rng_ctr=int(d["rng_ctr"]),
                      iso_var=t("iso_var"), iso_ps=t("iso_ps"),
                      iso_ts=t("iso_ts"), iso_n=int(d["iso_n"]),
                      served_min=1.0)
    return atm, cache, header["t"], header["meta"]
