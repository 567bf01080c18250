"""Tensor parallelism over "model" and FSDP over "data": the explicit
collectives the mesh program is made of (the dense transformers, the
mixtures of experts, the encoder-decoder, the vision front end and the
recurrent blocks, SSD and RG-LRU).

The reference places its arrays (`sharding/rules.py`) and lets GSPMD
insert the collectives.  The port has no such compiler: each rank holds
its own blocks of the parameter tree (`rules.local_shard`), and the layers
call the collectives here, Megatron-style, where a value changes
placement.  Under autograd each collective is a ``torch.autograd.Function``
with its adjoint:

* :func:`copy_to_model`: identity forward, all-reduce backward: a value
  every model rank holds whole, consumed split over the ranks (the input
  of a column-parallel product, the K/V every rank's heads read);
* :func:`reduce_from_model`: all-reduce forward, identity backward:
  partial sums made whole (a row-parallel product, the vocab-parallel
  embedding and loss);
* :func:`gather_model`, :func:`fsdp_gather`: all-gather forward,
  reduce-scatter backward: a sharded value every rank then uses a part of
  (K and V over "model"; an FSDP weight over "data" at use, freed after
  the layer);
* :func:`gather_whole`: all-gather forward, the rank's block of the
  gradient backward: a sharded value every rank then uses whole (the
  vision front end's projected patches, into the residual stream);
* :func:`sum_over_data_both`, :func:`sum_over_model_both`: all-reduce
  both ways: a statistic of rows split over "data" (the MoE load
  balance), or of channels split over "model" (the SSD's gated norm),
  that every rank's loss reads.

A :class:`TP` of ``None`` is one device: every helper is then the
identity and the layers run their one-device code, unchanged.  The layers
tell a sharded weight from a replicated one by its local shape against
the config's width, so the divisibility fallback of `rules.spec_for_param`
needs no flag.

Collectives go through ``torch.distributed`` as flat buffers, the form
every backend takes.  ``gloo`` takes only ``all_reduce`` and
``broadcast`` of CUDA tensors (two ranks sharing one card), so there a
gather is an all-reduce into zeros and a reduce-scatter an all-reduce
and a slice; elsewhere (``nccl``, ``gloo`` on the CPU, the dry run's
``fake`` group) they are the native ops.  :data:`TRAFFIC` counts the
bytes each axis moves by the reference's convention (an all-reduce its
payload, an all-gather its gathered result, a reduce-scatter its
scattered one), whatever carried them; :data:`AXIS` names the axis of
the collective in flight, which `launch/hlo_analysis.py` reads.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXIS = [None]                   # the mesh axis of the collective in flight
TRAFFIC: Dict[Tuple[str, str], int] = defaultdict(int)  # (axis, kind) -> B
SECONDS: Dict[str, float] = defaultdict(float)  # axis -> s, under timed()
_TIMED = [False]


def reset_traffic() -> None:
    TRAFFIC.clear()
    SECONDS.clear()


@contextlib.contextmanager
def timed():
    """Time every collective issued inside by the host clock, the device
    synchronized before and after each (so the seconds are the
    collective's own, and the step runs slower), into :data:`SECONDS`."""
    prev, _TIMED[0] = _TIMED[0], True
    try:
        yield SECONDS
    finally:
        _TIMED[0] = prev


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def traffic() -> Dict[str, Dict[str, int]]:
    """{axis: {kind: bytes}} since the last :func:`reset_traffic`."""
    out: Dict[str, Dict[str, int]] = {}
    for (axis, kind), n in sorted(TRAFFIC.items()):
        out.setdefault(axis, {})[kind] = n
    return out


@dataclass(frozen=True)
class TP:
    """This rank's place on the mesh: the "model" group, its size and this
    rank's coordinate on it, and, for FSDP, the "data" group (``None``
    without FSDP).  ``rows_over_data``: the rows a step computes on (a
    served batch, or each microbatch of a train step) are split over
    "data", each rank holding its block of them, so that a MoE layer's
    batch-level counts (the load-balance means, the capacity dispatch's
    slots) are taken over "data".  :meth:`from_mesh` sets it with FSDP
    (a served batch goes over "data"); `launch/steps.py` clears it where
    a rank holds whole microbatches or the whole batch."""
    group: Any
    size: int
    rank: int
    data_group: Any = None
    data_size: int = 1
    data_rank: int = 0
    rows_over_data: bool = False

    @property
    def active(self) -> bool:
        """Whether any collective runs: a "model" axis above 1, or FSDP
        over a "data" axis above 1."""
        return self.size > 1 or self.data_size > 1

    @classmethod
    def from_mesh(cls, mesh, *, fsdp: bool) -> "TP":
        from repro_torch.launch import mesh as mesh_lib
        g, r = mesh_lib.model_group(mesh)
        kw = {}
        if fsdp:
            dg, dr = mesh_lib.data_group(mesh)
            kw = dict(data_group=dg, data_size=dist.get_world_size(dg),
                      data_rank=dr, rows_over_data=True)
        return cls(group=g, size=dist.get_world_size(g), rank=r, **kw)


def model_size(tp: Optional[TP]) -> int:
    return 1 if tp is None else tp.size


def data_size(tp: Optional[TP]) -> int:
    return 1 if tp is None else tp.data_size


# --------------------------------------------------------------------------
# Raw collectives (flat buffers; gloo on CUDA through all_reduce)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def on_axis(axis: str):
    """Name the mesh axis of the collectives issued inside (and, under
    :func:`timed`, time them)."""
    prev, AXIS[0] = AXIS[0], axis
    if _TIMED[0]:
        _sync()
        t0 = time.perf_counter()
    try:
        yield
    finally:
        AXIS[0] = prev
        if _TIMED[0]:
            _sync()
            SECONDS[axis] += time.perf_counter() - t0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _emulated(group, x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group``, in place (``x`` must be
    contiguous)."""
    TRAFFIC[(axis, "all-reduce")] += _nbytes(x)
    with on_axis(axis):
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group, size: int, rank: int,
               axis: str) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank
    order."""
    x = x.contiguous()
    dim %= x.dim()
    TRAFFIC[(axis, "all-gather")] += size * _nbytes(x)
    n = x.numel()
    with on_axis(axis):
        if _emulated(group, x):
            buf = torch.zeros(size * n, dtype=x.dtype, device=x.device)
            buf[rank * n:(rank + 1) * n] = x.reshape(-1)
            dist.all_reduce(buf, group=group)
        else:
            buf = torch.empty(size * n, dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(buf, x.reshape(-1), group=group)
    out = buf.view((size,) + tuple(x.shape)).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= size
    return out.reshape(shape)


def reduce_scatter(x: torch.Tensor, dim: int, group, size: int, rank: int,
                   axis: str) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's ``1/size`` block of it
    along ``dim``."""
    dim %= x.dim()
    n = x.shape[dim] // size
    parts = x.unflatten(dim, (size, n)).movedim(dim, 0).contiguous()
    TRAFFIC[(axis, "reduce-scatter")] += _nbytes(parts) // size
    with on_axis(axis):
        if _emulated(group, parts):
            dist.all_reduce(parts, group=group)
            out = parts[rank].clone()
        else:
            out = torch.empty(parts.shape[1:], dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out.view(-1), parts.view(-1),
                                       group=group)
    return out          # parts[r] is laid out as x, its dim n long


# --------------------------------------------------------------------------
# Collectives under autograd
# --------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, ctx.axis), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return all_reduce(x.contiguous().clone(), group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank, axis):
        ctx.args = (dim, group, size, rank, axis)
        return all_gather(x, dim, group, size, rank, axis)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, *ctx.args),) + (None,) * 5


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_reduce(x.contiguous().clone(), group, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, ctx.axis), \
            None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank, axis):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return all_gather(x, dim, group, size, rank, axis)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n),) + (None,) * 5


def copy_to_model(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over "model" backward."""
    if tp is None or tp.size == 1:
        return x
    return _CopyTo.apply(x, tp.group, "model")


def reduce_from_model(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """All-reduce over "model" forward, identity backward."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFrom.apply(x, tp.group, "model")


def gather_model(tp: Optional[TP], x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over "model" along ``dim`` forward, reduce-scatter
    backward."""
    if tp is None or tp.size == 1:
        return x
    return _Gather.apply(x, dim, tp.group, tp.size, tp.rank, "model")


def gather_whole(tp: Optional[TP], x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over "model" along ``dim`` forward, this rank's block of
    the gradient backward: a column-parallel output made whole for
    consumers every rank runs alike (the replicated residual stream), whose
    gradient each rank then holds whole (a reduce-scatter would count it
    once a rank)."""
    if tp is None or tp.size == 1:
        return x
    return _GatherWhole.apply(x, dim, tp.group, tp.size, tp.rank, "model")


def sum_over_data_both(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """The sum over "data" of ``x``, forward and backward (an all-reduce
    both ways): a client-level statistic of rows split over "data" that
    every rank's loss reads (the MoE load-balance means), so that its
    gradient reaches each rank's rows from every rank's loss."""
    if tp is None or tp.data_size == 1:
        return x
    return _SumBoth.apply(x, tp.data_group, "data")


def sum_over_model_both(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """The sum over "model" of ``x``, forward and backward (an all-reduce
    both ways): a statistic of channels split over "model" that every
    rank's channels then read (the SSD's gated-norm sum of squares), so
    that its gradient reaches each rank's channels from every rank's."""
    if tp is None or tp.size == 1:
        return x
    return _SumBoth.apply(x, tp.group, "model")


def fsdp_gather(tp: Optional[TP], w: torch.Tensor, dim: int,
                full: int) -> torch.Tensor:
    """``w`` whole along ``dim`` (``full`` long): all-gathered over "data"
    where it is sharded there (its gradient reduce-scattered), else ``w``
    itself."""
    if tp is None or tp.data_size == 1 or w.shape[dim] == full:
        return w
    return _Gather.apply(w, dim, tp.data_group, tp.data_size, tp.data_rank,
                         "data")


def max_over_model(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over "model" of ``x`` (no gradient)."""
    if tp is None or tp.size == 1:
        return x
    return all_reduce(x.detach().contiguous().clone(), tp.group, "model",
                      dist.ReduceOp.MAX)


def sum_over_data(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over "data" in place (a gradient of a leaf FSDP does
    not shard)."""
    if tp is None or tp.data_size == 1:
        return x
    return all_reduce(x, tp.data_group, "data")


# --------------------------------------------------------------------------
# Layout helpers
# --------------------------------------------------------------------------

def is_split(local: int, full: int) -> bool:
    """Whether a dim of ``local`` entries is this rank's block of ``full``
    (a dim the divisibility fallback left whole has ``local == full``)."""
    return local != full


def block(tp: Optional[TP], local: int, full: int) -> Tuple[int, int]:
    """``[lo, hi)``: the entries of a ``full``-long dim this rank holds
    (all of them where the dim is not split)."""
    if tp is None or not is_split(local, full):
        return 0, full
    return tp.rank * local, (tp.rank + 1) * local


def vocab_range(tp: Optional[TP], v_local: int,
                v_padded: int) -> Tuple[int, int]:
    """The padded-vocab rows (and logit columns) this rank holds."""
    return block(tp, v_local, v_padded)


def agree_over_model(tp: Optional[TP], x: torch.Tensor) -> torch.Tensor:
    """``x`` as the first rank of this rank's "model" group holds it (a
    client's loss, the same on its ranks: one value they all weigh by)."""
    if tp is None or tp.size == 1:
        return x
    x = x.contiguous().clone()
    with on_axis("model"):
        dist.broadcast(x, src=dist.get_global_rank(tp.group, 0),
                       group=tp.group)
    TRAFFIC[("model", "broadcast")] += _nbytes(x)
    return x


def argmax_vocab(tp: Optional[TP], logits: torch.Tensor,
                 lo: int = 0) -> torch.Tensor:
    """The greedy pick over vocab-sharded logits (..., V_local) whose
    columns start at ``lo``: each rank's maximum and its first index,
    reduced over "model" (the largest value, then the smallest global
    index holding it: ``argmax``'s first-index rule), never a gather of
    the logits."""
    idx = logits.argmax(-1)
    if tp is None or tp.size == 1:
        return idx + lo
    val = logits.gather(-1, idx[..., None])[..., 0].float()
    top = max_over_model(tp, val)
    cand = torch.where(val == top, idx + lo,
                       torch.full_like(idx, torch.iinfo(idx.dtype).max))
    return all_reduce(cand.contiguous(), tp.group, "model",
                      dist.ReduceOp.MIN)
