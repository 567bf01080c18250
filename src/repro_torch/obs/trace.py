"""Host-plane span tracer + process-wide cache counters.

Counterpart of ``repro/obs/trace.py``.  :class:`Tracer` wraps host phases
(setup / compile / run / fetch, fleet classes, ...) in nested spans
recorded against one wall-clock epoch.  A span optionally enters
:func:`phase_scope` and, on a tracer made for a CUDA run, an NVTX range,
so a ``torch.profiler`` or Nsight capture of the same run shows the phase
names beside the kernels (the counterpart of
``jax.profiler.TraceAnnotation``).  ``Tracer.span_dicts()`` is the
JSON-ready record that rides ``RunResult.telemetry``; the Chrome
trace-event rendering lives in
`obs.telemetry.RunTelemetry.to_chrome_trace`.

:data:`COUNTERS` is the process-wide counter registry.  `repro_torch.api.run`
increments ``api.setup_cache.hit/miss`` on every call that passes a
``setup_cache``, telemetry on or off, as the reference does; the engine
counts contact-plan builds and reuses (``engine.plan_cache.miss/hit``),
which is what a fleet class shares in eager PyTorch.

The program's spans open only while a ``torch.profiler`` capture runs
(``torch._C._autograd._profiler_enabled()``, a fraction of a microsecond
to ask); otherwise they return a shared ``nullcontext`` and insert
nothing, so an uncaptured run's launches, autograd graph and results are
those of a program without them.  A span is a ``record_function`` range
on the profiler's own clock and keeps nothing of its own: the capture
holds it.

* :func:`phase_scope` opens a range around a phase on the calling
  thread: the round's ``fed_step/*`` phases, the ``host_read/*`` reads
  (`core/engine.host_read`), ``lm_train/update`` (`launch/steps.py`).
* :func:`grad_scope` spans a differentiable region, its backward
  included (``moe/experts``, ``attention/core``).  Autograd runs backward
  on an engine thread of its own on the card, so a range opened in the
  forward pass never covers the backward kernels: identity autograd
  functions on the region's inputs and output open a range of the same
  name in backward, when the output's gradient arrives, and close it
  when the inputs' gradients leave.  A remat recompute reruns the region
  inside that range and reopens its forward range there.

A kernel takes the innermost range open on the thread that launched it,
so no span that a metric reads holds another (a remat recompute of a
whole layer runs inside the backward range of the layer's last region:
the benchmark's readers take the inner ranges out).
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
        :func:`phase_scope` (and an NVTX range on a CUDA tracer), so a
        profiler capture shows the same phase boundaries."""
        with contextlib.ExitStack() as stack:
            if annotate:
                stack.enter_context(phase_scope(name))
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


_NULL = contextlib.nullcontext()


def phase_scope(name: str):
    """``torch.profiler.record_function(name)`` while a capture runs (the
    capture then groups the phase's kernels under its name), the shared
    ``nullcontext`` otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


class _CloseInBackward(torch.autograd.Function):
    """Identity on a region's inputs.  Its backward runs after every node
    of the region's backward (autograd runs the later-made nodes first,
    and these inputs' gradients are complete only then) and closes the
    range that :class:`_OpenInBackward` opened."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        return xs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return (None,) + grads


class _OpenInBackward(torch.autograd.Function):
    """Identity on a region's output.  Its backward runs before the
    region's and opens the range ``name`` on the thread that runs it."""

    @staticmethod
    def forward(ctx, held, name, y):
        ctx.held, ctx.name = held, name
        return y

    @staticmethod
    def backward(ctx, grad):
        scope = torch.profiler.record_function(ctx.name)
        scope.__enter__()
        ctx.held.append(scope)
        return None, None, grad


def grad_scope(name: str, fn, *args):
    """``fn(*args)`` (one tensor out) under the range ``name`` in forward
    and, while a capture runs and autograd records, in its backward too.
    The tensor arguments that require grad must lead to what backward
    differentiates (their gradients close the range).  Without a capture
    it is ``fn(*args)``: no range, no autograd node."""
    if not torch._C._autograd._profiler_enabled():
        return fn(*args)
    marked = ([i for i, a in enumerate(args)
               if isinstance(a, torch.Tensor) and a.requires_grad]
              if torch.is_grad_enabled() else [])
    held = None
    if marked:
        held = []
        args = list(args)
        for i, a in zip(marked, _CloseInBackward.apply(
                held, *(args[i] for i in marked))):
            args[i] = a
    with torch.profiler.record_function(name):
        y = fn(*args)
    return y if held is None else _OpenInBackward.apply(held, name, y)
