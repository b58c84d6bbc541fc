"""Altitude kernel functions for output weighting (reference
read_kernel, mptrac.c:8522, kernel_weight c:3298).

Own copy of the JAX package's ``read_kernel`` and ``kernel_weight`` (on
the host, for ``tools.atm_split``), and ``kernel_weight`` for a tensor of
pressures on its own device (``kernel_weight_t``), with ``np.interp``'s
arithmetic and its clamping at both ends.
"""

from __future__ import annotations

import numpy as np
import torch

from mptrac_tpu_torch.constants import H0, P0


def read_kernel(filename: str):
    """Read ``z w`` rows; normalize weights by the maximum."""
    kz, kw = [], []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    z, w = float(toks[0]), float(toks[1])
                except ValueError:
                    continue
                if kz and z < kz[-1]:
                    raise ValueError("Height levels must be ascending!")
                kz.append(z)
                kw.append(w)
    if len(kz) < 2:
        raise ValueError("Not enough height levels!")
    kw = np.array(kw)
    return np.array(kz), kw / kw.max()


def interp_clamped(x: torch.Tensor, xp: torch.Tensor,
                   fp: torch.Tensor) -> torch.Tensor:
    """``np.interp(x, xp, fp)`` for a tensor ``x`` (``xp`` ascending,
    all float64 on one device): ``fp[0]`` below the table, ``fp[-1]``
    from its last node on, ``fp[j]`` on a node, else
    ``slope * (x - xp[j]) + fp[j]`` with numpy's fallback from the upper
    node where that is NaN (a repeated height)."""
    n = xp.shape[0]
    j = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1,
                    0, n - 2)
    x0, x1, f0, f1 = xp[j], xp[j + 1], fp[j], fp[j + 1]
    slope = (f1 - f0) / (x1 - x0)
    val = slope * (x - x0) + f0
    val = torch.where(torch.isnan(val), slope * (x - x1) + f1, val)
    val = torch.where(torch.isnan(val) & (f0 == f1), f0, val)
    val = torch.where(x == x0, f0, val)
    val = torch.where(x >= xp[-1], fp[-1], val)
    return torch.where(x < xp[0], fp[0], val)


def kernel_at(kz, kw, z: torch.Tensor) -> torch.Tensor:
    """The kernel interpolated at heights ``z`` [km], in float64 on the
    device of ``z``."""
    def put(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=z.device)

    return interp_clamped(z.to(torch.float64), put(kz), put(kw))


def kernel_weight_t(kz, kw, p: torch.Tensor) -> torch.Tensor:
    """Weight at pressures ``p`` [hPa] by linear interpolation in altitude
    (reference kernel_weight, c:3298), in float64 on the device of
    ``p``; ones when no kernel is loaded."""
    p64 = p.to(torch.float64)
    if kz is None or len(kz) < 2:
        return torch.ones_like(p64)
    return kernel_at(kz, kw, H0 * torch.log(P0 / p64))


def kernel_weight(kz, kw, p):
    """Weight at pressure ``p`` [hPa] on the host (numpy), by linear
    interpolation in altitude (reference kernel_weight, c:3298); 1.0 when
    no kernel is loaded."""
    if kz is None or len(kz) < 2:
        return np.ones_like(np.asarray(p, float))
    z = H0 * np.log(P0 / np.asarray(p, float))
    return np.interp(z, kz, kw)
