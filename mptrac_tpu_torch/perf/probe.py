#!/usr/bin/env python3
"""Microprobes of the card for the gather-kernel designs.

Counterpart of the JAX package's ``perf/probe.py``.  Each probe measures
one inner operation that a kernel design rests on:

  xla    baseline: library row gather (``index_select``) + trilinear and
         time interpolation in plain PyTorch
  lane   P1: per-parcel column gather from the transposed table
         ``[64, ncell]`` + the same interpolation, in one kernel
  grid   P2: the cost of a thread block: ``x * 2`` over ``[8, n]`` in
         blocks of ``[8, G*128]``, G in 8, 32, 64
  small  P3: unsorted gather from a table that fits shared memory
         (``[8, 128]``: the climatology and axis lookups)
  sort   ``argsort`` + row permute at size

Usage: python -m mptrac_tpu_torch.perf.probe [probe ...] [--n N]
       [--ncell N] [--device cuda|cpu]

``lane``, ``grid`` and ``small`` are CUDA kernels (``csrc/probe.cu``);
``xla`` and ``sort`` are plain PyTorch, as they are plain XLA in the JAX
package.  What differs from the JAX probes by design: the TPU's lane
kernel copies a slab of ``S`` table columns into fast memory and gathers
within 128-lane windows for groups of ``G`` x 128 parcels, and reports
the fraction of parcels its windows served; it is probed for five
``(G, S)``.  On this card a thread gathers its own parcel's column and
every parcel is served, so ``lane`` prints one line, not five.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors.  With ``--device cpu`` the printed times
are host times of the plain versions and say so: they are no measure of
any device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mptrac_tpu_torch.ops import _cuda
from mptrac_tpu_torch.ops.lane_interp import interp_uvwt_plain
from mptrac_tpu_torch.types import resolve_device

LANES = 64              # rows of the transposed table
SMALL_SHAPE = (8, 128)  # the small table
SMALL_USED = 73         # columns of it that the indices reach
GRID_GROUPS = (8, 32, 64)
PLAIN_CHUNK = 1 << 22   # parcels per pass of a plain version


def timeit(fn, *args, reps=3, inner=20):
    """(seconds per call, last result): best of ``reps`` means over
    ``inner`` queued calls, after one warm-up call.  CUDA events on the
    card, the host clock for CPU tensors."""
    out = fn(*args)
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if on_card:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                out = fn(*args)
            e1.record()
            torch.cuda.synchronize()
            dt = 1e-3 * e0.elapsed_time(e1) / inner
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                out = fn(*args)
            dt = (time.perf_counter() - t0) / inner
        best = min(best, dt)
    return best, out


def make_data(n, ncell, seed=0, span_jitter=2, device="cuda"):
    """Sorted cell indices with a jitter (RK midpoints break perfect
    monotonicity), weights, and a random transposed table, made on
    ``device``: (packT [64, ceil(ncell/128)*128] f32, base [n] i32,
    w [4, n] f32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.sort(torch.randint(0, ncell - 1, (n,), generator=gen,
                                    device=dev)).values
    base = torch.clamp(
        base + torch.randint(-span_jitter, span_jitter + 1, (n,),
                             generator=gen, device=dev),
        0, ncell - 2).to(torch.int32)
    w = torch.rand((4, n), generator=gen, device=dev)
    packT = torch.rand((LANES, -(-ncell // 128) * 128), generator=gen,
                       device=dev) * 100.0 - 50.0
    return packT, base, w


# ---------------------------------------------------------------- P1
def probe_lane_plain(packT, base, w):
    """Plain PyTorch version of P1: [8, n], rows 0-2 (u, v, w), 3 T,
    4 the served flag (1.0), 5-7 zero."""
    n = base.shape[0]
    # gather the parcels' columns first, so that the temporaries are
    # [n, 64] and not a transposed copy of the table
    rows = packT[:, base.to(torch.int64)].T.contiguous()
    uvwt = interp_uvwt_plain(rows, torch.arange(n, device=base.device), w)
    out = torch.zeros((8, n), dtype=torch.float32, device=packT.device)
    out[0:4] = uvwt
    out[4] = 1.0
    return out


def probe_lane(packT, base, w):
    """P1: u, v, w, T at parcels whose cell is column ``base[i]`` of the
    transposed table ``packT [64, ncell_pad]`` f32; ``w [4, n]`` f32
    (wx, wy, wz, wt).  Returns [8, n] f32 as ``probe_lane_plain``."""
    if packT.dim() != 2 or packT.shape[0] != LANES:
        raise ValueError(f"probe_lane: expected a [{LANES}, ncell] table, "
                         f"got {tuple(packT.shape)}")
    if not packT.is_cuda:
        return probe_lane_plain(packT, base, w)
    return _lane_cuda(packT, base, w)


def _lane_cuda(packT, base, w):
    n = base.shape[0]
    dev, f32, name = packT.device, torch.float32, "probe_lane"
    t = _cuda.ptr(name, "packT", packT, f32, None, dev)
    b = _cuda.ptr(name, "base", base, torch.int32, None, dev)
    wp = _cuda.ptr(name, "w", w, f32, (4, n), dev)
    out = torch.empty((8, n), dtype=f32, device=dev)
    _cuda.call(name, dev, t, b, wp, out.data_ptr(), n, packT.shape[1])
    return out


# ---------------------------------------------------------------- P2
def probe_grid_plain(x, G):
    """Plain PyTorch version of P2."""
    return x * 2.0


def probe_grid(x, G):
    """P2: ``x * 2`` for ``x [8, nchunk * G * 128]`` f32, one thread
    block per ``[8, G * 128]`` tile."""
    cp = G * 128
    if x.dim() != 2 or x.shape[0] != 8 or x.shape[1] % cp != 0:
        raise ValueError(f"probe_grid: expected [8, k * {cp}], got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return probe_grid_plain(x, G)
    return _grid_cuda(x, cp)


def _grid_cuda(x, cp):
    xp = _cuda.ptr("probe_grid", "x", x, torch.float32, None, x.device)
    out = torch.empty_like(x)
    _cuda.call("probe_grid", x.device, xp, out.data_ptr(), x.shape[1] // cp,
               cp)
    return out


# ---------------------------------------------------------------- P3
def probe_small_plain(tab, idx):
    """Plain PyTorch version of P3: ``tab[:, idx]``, [8, n]."""
    return tab[:, idx.to(torch.int64)]


def probe_small(tab, idx):
    """P3: ``tab[:, idx[i]]`` for ``tab [8, 128]`` f32 and ``idx [n]``
    int32 in [0, 128): [8, n] f32."""
    if tuple(tab.shape) != SMALL_SHAPE:
        raise ValueError(f"probe_small: expected a {SMALL_SHAPE} table, got "
                         f"{tuple(tab.shape)}")
    if not tab.is_cuda:
        return probe_small_plain(tab, idx)
    return _small_cuda(tab, idx)


def _small_cuda(tab, idx):
    n = idx.shape[0]
    dev, name = tab.device, "probe_small"
    t = _cuda.ptr(name, "tab", tab, torch.float32, None, dev)
    i = _cuda.ptr(name, "idx", idx, torch.int32, None, dev)
    out = torch.empty((8, n), dtype=torch.float32, device=dev)
    _cuda.call(name, dev, t, i, out.data_ptr(), n)
    return out


def make_small_data(n, seed=0, device="cuda"):
    """(tab [8, 128] f32, idx [n] i32 in [0, 73)) on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tab = torch.rand(SMALL_SHAPE, generator=gen, device=dev)
    idx = torch.randint(0, SMALL_USED, (n,), generator=gen,
                        device=dev).to(torch.int32)
    return tab, idx


# ------------------------------------------------------- the five probes
def _where(dev):
    """The mark of a line that holds no device time."""
    return ("" if dev.type == "cuda"
            else "  [host time of the plain version, no device time]")


def _line(dev, text, dt, n):
    print(f"{text}: {dt * 1e3:8.3f} ms  {dt / n * 1e9:6.3f} ns/parcel"
          f"{_where(dev)}", flush=True)


def run_xla(n, ncell, dev):
    packT, base, w = make_data(n, ncell, device=dev)
    pack64 = packT.T[:ncell].contiguous()
    del packT

    def run(pack64, base, w):
        # (in passes of PLAIN_CHUNK parcels: the gathered rows of
        # 100M parcels would take 26 GB)
        out = torch.empty((4, n), dtype=torch.float32, device=base.device)
        for s in range(0, n, PLAIN_CHUNK):
            e = min(s + PLAIN_CHUNK, n)
            rows = torch.index_select(pack64, 0, base[s:e])
            out[:, s:e] = interp_uvwt_plain(
                rows, torch.arange(e - s, device=base.device), w[:, s:e])
        return out

    dt, _ = timeit(run, pack64, base, w)
    _line(dev, "index_select row-gather+interp", dt, n)
    return dt


def run_lane(n, ncell, dev):
    packT, base, w = make_data(n, ncell, device=dev)
    dt, out = timeit(probe_lane, packT, base, w)
    served = float(out[4].mean())
    # correctness against the plain version (the row gather, as the JAX
    # probe checks itself), piecewise to bound its temporaries
    err = 0.0
    for s in range(0, n, PLAIN_CHUNK):
        e = min(s + PLAIN_CHUNK, n)
        ref = probe_lane_plain(packT, base[s:e], w[:, s:e])
        err = max(err, float((out[:, s:e] - ref).abs().max()))
    print(f"lane column gather+interp: {dt * 1e3:8.3f} ms  "
          f"{dt / n * 1e9:6.3f} ns/parcel  served={served:.4f} "
          f"maxerr={err:.2e}{_where(dev)}", flush=True)
    return dt


def run_grid(n, dev):
    out = {}
    for G in GRID_GROUPS:
        cp = G * 128
        nchunk = -(-n // cp)
        x = torch.ones((8, nchunk * cp), dtype=torch.float32, device=dev)
        dt, _ = timeit(probe_grid, x, G)
        dt_mul, _ = timeit(lambda x: x.mul(2.0), x)
        print(f"grid G={G:3d} ({nchunk} blocks): {dt * 1e3:8.3f} ms  "
              f"{dt / nchunk * 1e6:7.4f} us/block  "
              f"x.mul(2.0): {dt_mul * 1e3:8.3f} ms{_where(dev)}", flush=True)
        out[G] = dt
    return out


def run_small(n, dev):
    tab, idx = make_small_data(n, device=dev)
    dt, _ = timeit(probe_small, tab, idx)
    _line(dev, "small-table shared-memory gather", dt, n)
    idx64 = idx.to(torch.int64)
    dt_sel, _ = timeit(lambda t, i: torch.index_select(t, 1, i), tab, idx64)
    _line(dev, "small-table index_select [8, n]", dt_sel, n)
    tab_t = tab.T.contiguous()
    dt_rows, _ = timeit(lambda t, i: t[i], tab_t, idx64)
    _line(dev, "small-table row gather tab.T[idx] [n, 8]", dt_rows, n)
    return dt


def run_sort(n, ncell, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    key = torch.randint(0, ncell, (n,), generator=gen,
                        device=dev).to(torch.int32)
    vals = torch.rand((n, 8), generator=gen, device=dev)

    def run(key, vals):
        return vals[torch.argsort(key)]

    dt, _ = timeit(run, key, vals, inner=5)
    _line(dev, "argsort+permute [n,8]", dt, n)
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Microprobes of the card for the gather-kernel designs")
    ap.add_argument("probes", nargs="*",
                    default=["xla", "lane", "grid", "small", "sort"])
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--ncell", type=int, default=360 * 181 * 61)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    unknown = set(args.probes) - {"xla", "lane", "grid", "small", "sort"}
    if unknown:
        ap.error(f"unknown probes: {sorted(unknown)}")

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device={name} n={args.n} ncell={args.ncell}", file=sys.stderr)
    for p in args.probes:
        if p == "xla":
            run_xla(args.n, args.ncell, dev)
        elif p == "lane":
            run_lane(args.n, args.ncell, dev)
        elif p == "grid":
            run_grid(args.n, dev)
        elif p == "small":
            run_small(args.n, dev)
        elif p == "sort":
            run_sort(args.n, args.ncell, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
