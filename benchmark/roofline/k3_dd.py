"""K3, ``permute_cols`` (``csrc/permute_cols.cu`` ``gather_kernel``), as
the domain-decomposed step's migration calls it: three selections a
subdomain a step (movers, stayers, received), each gathering its parcels
of every state column in slot order.  A parcel gathered reads the index
(8 B) and every column once and writes it once (``k3.permutation_bytes``):
the ``dd`` configuration's 7 float32 columns (p, lon, lat, the
quantity t, the three wind-memory rows) and 2 float64 columns (the time,
the quantity idx), 96 B a parcel.  The program launches the float64
index in a launch of its own, which reads the index once more: the
count leaves that out, so the share reads low rather than high.  The
parcels are the program's counter ``dd_selected`` over the traced steps
(``dd_spans.selected``)."""

from benchmark import dd_spans
from benchmark.metrics_common import bound_s as _bound

KERNELS = ("gather_kernel",)

#: the dd configuration's state columns
COLS32 = 7
COLS64 = 2


def _k3():
    from benchmark import manifest
    return manifest.roofline("k3")


def bound_s(ctx, launches: dict) -> float:
    """The least time of the traced migrations' selections (``launches``
    is not needed: the bytes follow the parcels gathered)."""
    n = dd_spans.selected(dd_spans.tallies()) or 0
    return _bound(_k3().permutation_bytes(n, COLS32, COLS64), 0)
