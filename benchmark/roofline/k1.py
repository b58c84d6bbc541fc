"""K1, ``rk_fused_advect`` (``csrc/rk_fused.cu`` ``rk_kernel``): bytes
and operations of one launch from its shapes (the program's PERF.md
section 6): 5 float32 inputs and 7 outputs a parcel (48 B), the cell
table [npl, nx, ny, 8] float32 and the two axes read once; operations a
parcel: per RK stage a locate (19 + a binary search of the levels, 4
for the regular latitudes), 6 trilinear blends of 21, 9 + 6 + 20 more,
then the final locate, 2 blends, 3 and the 16-point sigma (159) and 25."""

import math

from benchmark.metrics_common import bound_s as _bound

KERNELS = ("rk_kernel",)


def launch_bytes_ops(n: int, nx: int, ny: int, npl: int, nstage: int):
    nbytes = n * 48 + npl * nx * ny * 8 * 4 + (ny + npl) * 4
    per_locate = 19 + math.ceil(math.log2(npl)) + 4
    ops = n * (nstage * (per_locate + 6 * 21 + 9 + 6 + 20)
               + per_locate + 2 * 21 + 3 + 159 + 25)
    return nbytes, ops


def bound_s(ctx, launches: dict) -> float:
    nx, ny, npl = ctx.grid
    nbytes, ops = launch_bytes_ops(ctx.n, nx, ny, npl, ctx.advect_stages)
    return launches["rk_kernel"] * _bound(nbytes, ops)
