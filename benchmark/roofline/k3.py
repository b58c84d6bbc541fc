"""K3, ``permute_cols`` (``csrc/permute_cols.cu``): one sort's
permutation of the state, by the gather kernel or by the pack and rows
kernels, and its count pass.  A permutation of n parcels reads the
index (8 B) and every column once and writes it once: 9 float32 and
one float64 column, 96 B a parcel with the index.  The count pass reads
the index at the outputs it samples (every 8th block of 256, 8 B each,
4 operations).  Bytes are counted once per permutation whatever path
its launches take."""

from benchmark.metrics_common import bound_s as _bound

KERNELS = ("count_kernel", "gather_kernel", "pack_kernel", "rows_kernel")

#: the count pass's sampling (outputs read in blocks)
COUNT_BLOCK = 256
COUNT_EVERY = 8


def sampled(n: int) -> int:
    full, rest = divmod(n, COUNT_BLOCK * COUNT_EVERY)
    return full * COUNT_BLOCK + min(COUNT_BLOCK, rest)


def permutation_bytes(n: int, cols32: int, cols64: int) -> int:
    return n * (8 + 8 * cols32 + 16 * cols64)


def bound_s(ctx, launches: dict) -> float:
    perms = launches["gather_kernel"] + launches["rows_kernel"]
    count = launches["count_kernel"]
    s = sampled(ctx.n)
    return (perms * _bound(permutation_bytes(ctx.n, ctx.cols32, ctx.cols64),
                           0)
            + count * _bound(s * 8, s * 4))
