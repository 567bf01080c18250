"""Reduction of a ``torch.profiler`` capture to what the per-layer
metrics read: device intervals, idle gaps labelled by what the host was
doing, device time by kernel name and by program scope.

The window is the range of the benchmark's own ``perfbench/window``
annotation on the host, so every number is clipped to the measured
window on the trace's own clock.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

WINDOW = "perfbench/window"
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _records(prof):
    """(kind, name, start_ns, end_ns, thread) of every parsed function
    event of the capture."""
    out = []
    for e in prof.events():
        kind = str(getattr(e, "activity_type", "") or "")
        cuda = e.device_type == DeviceType.CUDA
        if not kind or kind == "None":
            if cuda:
                kind = ("gpu_user_annotation" if e.is_user_annotation
                        else "gpu_memcpy" if e.name.startswith("Memcpy")
                        else "gpu_memset" if e.name.startswith("Memset")
                        else "kernel")
            else:
                kind = ("user_annotation" if e.is_user_annotation
                        else "cuda_runtime" if e.name.startswith("cuda")
                        else "cpu_op")
        out.append((kind, e.name, int(e.time_range.start * 1000),
                    int(e.time_range.end * 1000), e.thread))
    return out


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """One capture, clipped to the window annotation.  Times are in
    nanoseconds internally and seconds in every public number."""

    def __init__(self, prof):
        self.device: List[Tuple[int, int, str]] = []
        self.device_scopes: Dict[str, List[Tuple[int, int]]] = {}
        self.host: Dict[int, List[Tuple[int, int, str]]] = {}
        window = None
        for kind, name, s, end, thread in _records(prof):
            if kind in DEVICE_WORK:
                self.device.append((s, end, name))
            elif kind == "gpu_user_annotation":
                self.device_scopes.setdefault(name, []).append((s, end))
            elif kind in HOST_KINDS:
                if name == WINDOW and kind == "user_annotation":
                    window = (s, end)
                    continue
                self.host.setdefault(thread, []).append((s, end, name))
        if window is None:
            raise RuntimeError(f"the capture holds no {WINDOW!r} range")
        self.t0, self.t1 = window
        self.counts = {"device": len(self.device),
                       "host": sum(len(v) for v in self.host.values())}
        self.device = [(max(s, self.t0), min(e, self.t1), n)
                       for s, e, n in self.device
                       if e > self.t0 and s < self.t1]
        self.device.sort()
        self.busy = merge((s, e) for s, e, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, pred) -> float:
        """Device seconds of the operations whose name ``pred`` accepts."""
        return sum(e - s for s, e, n in self.device if pred(n)) / 1e9

    def scope_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations that ran inside the device-side
        ranges of the program's ``record_function(name)`` scope; None
        where the capture has no such range."""
        ranges = merge(self.device_scopes.get(name, []))
        if not ranges:
            return None
        starts = [s for s, _ in ranges]
        total = 0
        for s, e, _ in self.device:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < ranges[i][1]:
                total += min(e, ranges[i][1]) - s
        return total / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), v / 1e9] for n, v in rows]

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time summed by the host operation that was running
        at each gap's midpoint: the innermost one (the latest start among
        those that cover it, over every host thread), or ``host: no
        operation`` where Python ran between operations."""
        gaps = self.gaps()
        mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
        label: Dict[str, int] = {}
        best: List[Tuple[int, str]] = [(-1, "host: no operation")] * len(mids)
        for events in self.host.values():
            events.sort()
            stack: List[Tuple[int, int, str]] = []
            j = 0
            for qi, (t, _) in enumerate(mids):
                while j < len(events) and events[j][0] <= t:
                    ev = events[j]
                    while stack and stack[-1][1] <= ev[0]:
                        stack.pop()
                    stack.append(ev)
                    j += 1
                while stack and stack[-1][1] <= t:
                    stack.pop()
                if stack and stack[-1][0] > best[qi][0]:
                    best[qi] = (stack[-1][0], stack[-1][2])
        for (_, dur), (_, name) in zip(mids, best):
            label[name] = label.get(name, 0) + dur
        rows = sorted(label.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), v / 1e9] for n, v in rows]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."
