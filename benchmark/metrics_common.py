"""What the metric readers share: a kernel's roofline share from the
trace and the kernel's own file of bytes and operations."""

from benchmark.tracing import kernel_match

#: published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM
#: bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the float32 rate."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)


def roofline_pct(ctx, kernel_file: str):
    """100 x (the kernel's bound over the window's launches) / (their
    device time in the trace); None where the trace has none of them."""
    if ctx.trace is None:
        return None
    mod = ctx.roofline(kernel_file)
    launches = {k: 0 for k in mod.KERNELS}
    busy = 0.0
    for name, a, b in ctx.trace.events:
        for k in mod.KERNELS:
            if kernel_match(name, k):
                launches[k] += 1
                busy += (b - a) * 1e-6
                break
    if busy <= 0:
        return None
    return 100.0 * mod.bound_s(ctx, launches) / busy


def reader(name: str):
    """The ``read`` of ``metrics/<name>.py``: a metric read alike in
    cells that report different end-to-end metrics."""
    from benchmark import manifest
    return manifest.metric_reader(name).read
