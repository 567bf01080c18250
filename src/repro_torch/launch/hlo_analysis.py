"""Roofline inputs of a step, counted on fake tensors.

Counterpart of ``repro/launch/hlo_analysis.py``.  There is no HLO here:
PyTorch runs eagerly, so :func:`count` runs the step once under a
``FakeTensorMode`` (every tensor a shape, a dtype and a device over
``meta`` storage: nothing is computed or allocated, no kernel is built or
launched) and a dispatch mode of this module, :class:`Counter`, reads
every aten op and every kernel op (`kernels/ops.py`) as it passes.  Three
summaries come out, keyed as the reference's, so that
``benchmarks/roofline.py::analyze`` reads a record:

* :func:`cost_summary`: ``flops``, the matrix products by
  ``torch.utils.flop_counter``'s formulas and each kernel by its own (the
  formulas of ``chip_smoke.py``'s bounds: 4 D a live pair of flash, 2 C K
  a column of a stage-1); elementwise work adds no flop.
  ``bytes_accessed``: the bytes of every tensor an op takes and returns,
  views and ops that only allocate or read metadata left out (a kernel op
  thus moves its bytes once, as its bound counts them).
* :func:`memory_summary`: ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` (each storage once), ``alias_size_in_bytes``
  (the arguments the step writes in place: the train step's client stack,
  a decode step's caches), ``temp_size_in_bytes``, and
  ``total_hbm_bytes``: the peak of live device bytes during the step,
  arguments included.  That is what ``torch.cuda.max_memory_allocated``
  reads for the step run from a fresh peak with only its arguments
  resident, less the allocator's rounding and the kernels' workspaces.
* :func:`collective_bytes`: bytes by kind, and ``total``, of every c10d
  or functional collective the step issues, by the reference's
  convention: an all-reduce (and a broadcast) its payload, an all-gather
  its gathered result, a reduce-scatter its scattered result.

Unlike XLA:CPU, which counts a loop body once, every layer counts, and so
does every microbatch and client of a train step: a loop run through
``launch/steps.py::_trips`` under :meth:`Counter.trips` runs its first
trip alone and counts its work once for every trip.  The count is of what
the port runs: a windowed layer that a route computes densely (the
chunked train attention) counts at its full width, and the MoE scan
dispatch every expert on every token.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops  # noqa: F401  (registers the kernel ops)

# ops that allocate or read metadata only: no bytes accessed
_NO_ACCESS = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
              "is_same_size", "set_", "resize_", "record_stream"}
# collective ops (c10d's and the functional ones) -> the reference's kinds;
# an all-gather counts its gathered result, a reduce-scatter its scattered
# one, the others their payload
_KINDS = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
          "all_reduce_": "all-reduce",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "reduce_scatter_tensor": "reduce-scatter",
          "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
          "broadcast_": "broadcast", "broadcast": "broadcast"}
_RESULT_COUNTED = {"all-gather", "reduce-scatter", "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class Counter(TorchDispatchMode):
    """Counts the ops dispatched under it: flops, bytes accessed and
    collective bytes, each op's times the product of the enclosing
    :meth:`trips`; and live device bytes (by storage, freed when the last
    tensor over it goes), their peak, the arguments and what the step
    writes of them."""

    def __init__(self):
        super().__init__()
        self.mult = 1
        self.trip_counts = []             # every trips(n) entered, in order
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.live: Dict[int, tuple] = {}  # id(storage) -> (bytes, weakref)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.args: Dict[int, int] = {}    # argument storages: id -> bytes
        self.written: set = set()         # argument storages written

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count the work done inside ``n`` times (`steps._trips`)."""
        self.trip_counts.append(n)
        self.mult *= n
        try:
            yield
        finally:
            self.mult //= n

    def _freed(self, key: int) -> None:
        nbytes, _ = self.live.pop(key)
        self.live_bytes -= nbytes

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it is freed; its id."""
        st = t.untyped_storage()
        key = id(st)
        if key not in self.live:
            nbytes = st.nbytes()
            self.live[key] = (nbytes, weakref.ref(
                st, lambda _, key=key: self._freed(key)))
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return key

    def arguments(self, args) -> None:
        for t in _tensors(args):
            key = self.track(t)
            self.args[key] = self.live[key][0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        kind = (_KINDS.get(name) if func.namespace in
                ("c10d", "_c10d_functional", "c10d_functional") else None)
        if kind:
            counted = out if kind in _RESULT_COUNTED else (args, kwargs)
            self.collectives[kind] += self.mult * sum(
                _nbytes(t) for t in _tensors(counted))
        elif (func.namespace != "prim" and not func.is_view
              and name not in _NO_ACCESS):
            self.bytes_accessed += self.mult * sum(
                _nbytes(t) for t in _tensors((args, kwargs, out)))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += self.mult * int(formula(*args, **kwargs,
                                                  out_val=out))
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                value = (args[i] if i < len(args)
                         else kwargs.get(a.name))
                for t in _tensors(value):
                    key = id(t.untyped_storage())
                    if key in self.args:
                        self.written.add(key)
        for t in _tensors(out):
            self.track(t)
        return out


@contextlib.contextmanager
def fake_process_group(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (torch's testing backend: no peers, every collective returns at
    once), destroyed on the way out, error or not."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count(fn: Callable, specs: tuple, kwargs: Optional[dict] = None, *,
          device: str, trips: bool = False) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once on fake tensors: ``specs`` are the
    bundle's ``in_specs`` (meta tensors, made fake on ``device``; other
    values pass as they are).  With ``trips`` the step gets
    ``trips=counter.trips``.  Returns the counter, the outputs' storages
    (id -> bytes), the number of output tensors and the seconds it
    took."""
    t0 = time.perf_counter()
    counter = Counter()
    kwargs = dict(kwargs or {})
    # real tensors the step makes or holds (a cluster assignment built
    # with the step, a position made a tensor) become fake where they meet
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=device)
            if isinstance(s, torch.Tensor) else s, specs)
        counter.arguments(args)
        if trips:
            kwargs["trips"] = counter.trips
        with counter:
            out = fn(*args, **kwargs)
        outs = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            outs.setdefault(id(st), st.nbytes())
    return {"counter": counter, "outputs": outs,
            "n_outputs": len(_tensors(out)),
            "count_s": time.perf_counter() - t0}


def cost_summary(c: Dict[str, Any]) -> Dict[str, Any]:
    counter = c["counter"]
    return {"flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes_accessed),
            "utilization_keys": []}


def memory_summary(c: Dict[str, Any]) -> Dict[str, float]:
    counter, outs = c["counter"], c["outputs"]
    arg = sum(counter.args.values())
    out = sum(outs.values())
    alias = sum(counter.args[k] for k in counter.written
                | (set(outs) & set(counter.args)))
    total = counter.peak_bytes
    return {"argument_size_in_bytes": float(arg),
            "output_size_in_bytes": float(out),
            "temp_size_in_bytes": float(total - arg - out + alias),
            "generated_code_size_in_bytes": 0.0,
            "alias_size_in_bytes": float(alias),
            "total_hbm_bytes": float(total)}


def collective_bytes(c: Dict[str, Any]) -> Dict[str, int]:
    out = dict(c["counter"].collectives)
    out["total"] = sum(out.values())
    return out
