"""Per-layer time from the program's spans in a capture (`pb/trace.Trace`).

A span is a ``record_function`` range of the program (`repro_torch/obs/
trace.py`); its device-side ranges hold the kernels launched inside it.
A kernel takes the innermost range open on the thread that launched it,
and a range on the device runs from its first kernel to its last, so a
span that opens inside another one (a whole layer's remat recompute,
attention included, runs inside the backward range of the layer's
experts) lies inside that one's device range: ``without`` takes such
spans out.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Iterable, List, Optional, Sequence, Tuple

from pb.trace import Trace, merge


def minus(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]
          ) -> List[Tuple[int, int]]:
    """The merged, sorted intervals ``a`` less the merged, sorted ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def device_ms(ctx, name: str, unit: str,
              without: Iterable[str] = ()) -> Optional[float]:
    """Device milliseconds a unit inside the device ranges of span
    ``name``, less those inside the spans ``without``; None in a cell of
    another unit or where the capture holds no range of ``name``."""
    if ctx["unit"] != unit:
        return None
    tr = ctx["trace"]
    ranges = merge(tr.device_scopes.get(name, []))
    if not ranges:
        return None
    cut = merge(r for n in without for r in tr.device_scopes.get(n, []))
    left = minus(ranges, cut)
    if not left:
        return 0.0
    # `Trace.scope_s`'s arithmetic over the ranges left: the operations
    # that start inside a range, each cut at the range's end
    view = SimpleNamespace(device=tr.device, device_scopes={name: left})
    return 1e3 * Trace.scope_s(view, name) / ctx["units"]


def host_ms(ctx, prefix: str, unit: str) -> Optional[float]:
    """Host milliseconds a unit inside the program's spans whose name
    starts with ``prefix``, on any thread, clipped to the window; None in
    a cell of another unit or where the capture holds no such span."""
    if ctx["unit"] != unit:
        return None
    tr = ctx["trace"]
    spans = [(max(s, tr.t0), min(e, tr.t1))
             for events in tr.host.values() for s, e, n in events
             if n.startswith(prefix) and e > tr.t0 and s < tr.t1]
    if not spans:
        return None
    return sum(e - s for s, e in merge(spans)) / 1e6 / ctx["units"]
