"""Host-plane span tracer + process-wide cache counters.

Counterpart of ``repro/obs/trace.py``.  :class:`Tracer` wraps host phases
(setup / compile / run / fetch, fleet classes, ...) in nested spans
recorded against one wall-clock epoch.  A span optionally enters
``torch.profiler.record_function(name)`` and, on a tracer made for a CUDA
run, an NVTX range, so a ``torch.profiler`` or Nsight capture of the same
run shows the phase names beside the kernels (the counterpart of
``jax.profiler.TraceAnnotation``).  ``Tracer.span_dicts()`` is the
JSON-ready record that rides ``RunResult.telemetry``; the Chrome
trace-event rendering lives in
`obs.telemetry.RunTelemetry.to_chrome_trace`.

:data:`COUNTERS` is the process-wide counter registry.  `repro_torch.api.run`
increments ``api.setup_cache.hit/miss`` on every call that passes a
``setup_cache``, telemetry on or off, as the reference does; the engine
counts contact-plan builds and reuses (``engine.plan_cache.miss/hit``),
which is what a fleet class shares in eager PyTorch.

:func:`phase_scope` is the in-round marker: ``record_function(name)``
around the engines' ``fed_step`` phases when telemetry is on, a no-op
``nullcontext`` when it is off, so telemetry off adds nothing to a round.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List

import torch


@dataclass
class Span:
    """One closed host span, relative to its tracer's epoch."""
    name: str
    ts_us: float
    dur_us: float
    depth: int
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ts_us": round(self.ts_us, 3),
                "dur_us": round(self.dur_us, 3), "depth": self.depth,
                "args": self.args}


class Tracer:
    """Nested wall-clock spans with optional profiler annotation.

    ``nvtx=True`` (a tracer of a CUDA run) also pushes an NVTX range per
    annotated span; a CPU run's tracer calls no ``torch.cuda`` function."""

    def __init__(self, nvtx: bool = False) -> None:
        self._epoch = time.perf_counter()
        self._depth = 0
        self._nvtx = nvtx
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, annotate: bool = True,
             **args: Any) -> Iterator[None]:
        """``with tracer.span("compile"): ...`` records one span; nesting
        depth follows the with-stack.  ``annotate=True`` also enters
        ``torch.profiler.record_function(name)`` (and an NVTX range on a
        CUDA tracer), so a profiler capture shows the same phase
        boundaries."""
        with contextlib.ExitStack() as stack:
            if annotate:
                stack.enter_context(torch.profiler.record_function(name))
                if self._nvtx:
                    torch.cuda.nvtx.range_push(name)
                    stack.callback(torch.cuda.nvtx.range_pop)
            depth, self._depth = self._depth, self._depth + 1
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                self._depth = depth
                self.spans.append(Span(name, (t0 - self._epoch) * 1e6,
                                       (t1 - t0) * 1e6, depth, dict(args)))

    def span_dicts(self) -> List[Dict[str, Any]]:
        """JSON-ready span records, in start order."""
        return [s.to_dict() for s in sorted(self.spans,
                                            key=lambda s: s.ts_us)]

    def phase_times(self) -> Dict[str, float]:
        """Top-level span name -> total seconds."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.depth == 0:
                out[s.name] = out.get(s.name, 0.0) + s.dur_us / 1e6
        return out


class Counters:
    """Thread-safe monotonic counters (process-wide singleton below)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: collections.Counter = collections.Counter()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    @staticmethod
    def delta(before: Dict[str, int],
              after: Dict[str, int]) -> Dict[str, int]:
        """Per-run counter increments between two snapshots."""
        return {k: v - before.get(k, 0) for k, v in after.items()
                if v - before.get(k, 0)}


COUNTERS = Counters()


def phase_scope(name: str, enabled: bool = True):
    """``torch.profiler.record_function(name)`` when enabled (profiler
    captures then group the phase's kernels under its name), a
    ``nullcontext`` otherwise: the disabled path does nothing."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
