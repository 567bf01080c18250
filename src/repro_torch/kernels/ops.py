"""Dispatching wrappers for the ported kernels.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version in `kernels/ref.py`.  There is no fallback
between the two.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels: set the counts to 0 with :func:`reset_launches`,
run, read ``LAUNCHES``.

A fake tensor (a ``FakeTensor`` of ``launch/dryrun.py``: a device over
no memory) takes neither: it goes to the kernel's op in the
``repro_torch`` library (:func:`counted`), whose fake
implementation gives the kernel's output shapes and dtypes, and whose flop
formula (``torch.utils.flop_counter``) is the kernel's work by the
formulas of ``chip_smoke.py``'s bounds; its inputs and outputs are the
bytes the kernel moves once.  It builds and launches nothing and counts no
launch.  The ops' own implementation, for real tensors, is the plain
version; the wrappers never call it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import kmeans as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_agg as _wagg
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

LAUNCHES: Dict[str, int] = {"weighted_agg_multi": 0, "kmeans_assign": 0,
                            "weighted_agg": 0, "flash_attention": 0}
# flash_attention's launches by route (kernels/flash_attention.py): bf16 on
# the tensor cores, f32 on the CUDA cores; they sum to the total above
FLASH_ROUTES: Dict[str, int] = {_flash.TENSOR_CORES: 0, _flash.CUDA_CORES: 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_ROUTES):
        for name in counts:
            counts[name] = 0


def weighted_agg_multi(stack: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C, K) -> (K, P): all K weighted reductions
    in one pass over the stack (the one-leaf case of the grouped kernel)."""
    if stack.device.type == "cpu":
        return ref.weighted_agg_multi_ref(stack, weights)
    if counted(stack):
        return torch.ops.repro_torch.weighted_agg_multi(
            [stack], weights).reshape(weights.shape[1], stack.shape[1])
    out = _wagg.launch(stack, weights)
    LAUNCHES["weighted_agg_multi"] += 1
    return out


def weighted_agg_multi_tree(tree: Any, weights: torch.Tensor) -> Any:
    """(C, ...) tree + (C, K) weights -> (K, ...) tree, leaf by leaf as
    the reference's tree form; on the card the leaves of each dtype go into
    one grouped launch for every 64 (one for LeNet's 10 leaves: one a
    stage-1; a bf16 model with f32 leaves, as the recurrent families'
    ``A_log``/``D``/``dt_bias``, one for each dtype), any K."""
    leaves = tree_leaves(tree)
    k = weights.shape[1]
    if not leaves or leaves[0].device.type == "cpu":
        outs = [ref.weighted_agg_multi_ref(x.reshape(x.shape[0], -1),
                                           weights).reshape((k,) + x.shape[1:])
                for x in leaves]
        return tree_unflatten(tree, outs)
    outs = [None] * len(leaves)
    for group in dtype_groups(leaves):     # (C, ...) leaves go in as they are
        if counted(leaves[0]):
            flat = torch.ops.repro_torch.weighted_agg_multi(
                [leaves[i] for i in group], weights)
            for i, out in zip(group, _split(flat, [leaves[i] for i in group],
                                            k)):
                outs[i] = out
            continue
        got = _wagg.launch_grouped([leaves[i].contiguous() for i in group],
                                   weights)
        LAUNCHES["weighted_agg_multi"] += _wagg.launches(len(group))
        for i, out in zip(group, got):
            outs[i] = out
    return tree_unflatten(tree, outs)


def dtype_groups(leaves) -> Tuple[Tuple[int, ...], ...]:
    """The leaves' indices grouped by dtype, groups in the order of each
    dtype's first leaf: one grouped launch takes one dtype."""
    groups: Dict[torch.dtype, list] = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return tuple(tuple(g) for g in groups.values())


def weighted_agg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C,) -> (P,): the K = 1 case of the
    ``weighted_agg_multi`` kernel (``csrc/weighted_agg.cu``)."""
    if stack.device.type == "cpu":
        return ref.weighted_agg_ref(stack, weights)
    if counted(stack):
        return torch.ops.repro_torch.weighted_agg(stack, weights)
    out = _wagg.launch(stack, weights.reshape(-1, 1))
    LAUNCHES["weighted_agg"] += 1
    return out.reshape(stack.shape[1])


def weighted_agg_tree(tree: Any, weights: torch.Tensor) -> Any:
    """Leaf-wise: (C, ...) tree + (C,) weights -> (...) tree, one launch
    per leaf, as the reference's tree form."""
    def one(x):
        return weighted_agg(x.reshape(x.shape[0], -1),
                            weights).reshape(x.shape[1:])
    return tree_map(one, tree)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D): GQA,
    scale 1/sqrt(D), optional tanh soft-cap, causal and sliding-window masks
    with q tokens at the end of the kv axis (``q_pos = Sk - Sq + i``).
    On the card bf16 runs the tensor-core kernel and f32 the CUDA-core one
    (``FLASH_ROUTES`` counts each).  Forward only: the kernel's output
    carries no gradient, so on the card a call that autograd would
    differentiate raises (training attention takes
    ``models/attention.py``'s chunked route instead)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel is forward only; training "
            "takes models/attention.py's chunked route (mode='train'), and "
            "a backward kernel is ROADMAP queue 2, item e")
    if counted(q):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                     softcap)
    out, route = _flash.launch(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    FLASH_ROUTES[route] += 1
    return out


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centroids (K, D) -> (assignment (N,) int32, min squared
    distance (N,) f32)."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, centroids)
    if counted(x):
        return torch.ops.repro_torch.kmeans_assign(x, centroids)
    out = _kmeans.launch(x, centroids)
    LAUNCHES["kmeans_assign"] += 1
    return out


# ==========================================================================
# The kernels as ops of the dry run: fake implementations and their work
# ==========================================================================

def counted(t: torch.Tensor) -> bool:
    """A tensor the dry run fakes (a ``FakeTensor``, which carries its
    ``fake_mode``): nothing to launch on.  A plain meta tensor is not
    one: the launcher refuses it, as any tensor off the CPU and the
    card."""
    return getattr(t, "fake_mode", None) is not None


def _split(flat: torch.Tensor, leaves, k: int) -> List[torch.Tensor]:
    """The (K, ...) outputs of a grouped stage-1, leaf-major views of its
    one buffer, as ``weighted_agg.launch_grouped`` returns them."""
    outs, at = [], 0
    for x in leaves:
        n = k * (x.numel() // x.shape[0])
        outs.append(flat[at:at + n].view((k,) + tuple(x.shape[1:])))
        at += n
    return outs


@functools.lru_cache(maxsize=None)
def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Live (q, k) pairs of one head of ``flash_attention``: the band its
    masks leave, q tokens at the end of the kv axis."""
    total = 0
    for qp in range(sk - sq, sk):
        hi = min(sk, qp + 1) if causal else sk
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_flops(q_shape, k_shape, causal: bool, window: int) -> int:
    """4 D flops a live pair of each of the B Hq heads: Q K^T and P V."""
    b, hq, sq, d = q_shape
    return 4 * d * b * hq * flash_pairs(sq, k_shape[2], causal, window)


def stage1_flops(c: int, k: int, columns: int) -> int:
    """A stage-1 of C rows into K clusters over ``columns`` columns: a
    multiply and an add a (row, cluster, column)."""
    return 2 * c * k * columns


def kmeans_flops(n: int, d: int, k: int) -> int:
    """A distance of D products and sums, and 3 more operations, a (point,
    centroid) pair."""
    return n * k * (2 * d + 3)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, softcap: float) -> torch.Tensor:
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q)      # q's layout, as the launcher's output


@torch.library.custom_op("repro_torch::weighted_agg_multi", mutates_args=())
def _wagg_multi_op(leaves: List[torch.Tensor],
                   weights: torch.Tensor) -> torch.Tensor:
    return torch.cat([ref.weighted_agg_multi_ref(
        x.reshape(x.shape[0], -1), weights).reshape(-1) for x in leaves])


@_wagg_multi_op.register_fake
def _(leaves, weights):
    cols = sum(x.numel() // x.shape[0] for x in leaves)
    return leaves[0].new_empty((weights.shape[1] * cols,))


@torch.library.custom_op("repro_torch::weighted_agg", mutates_args=())
def _wagg_op(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ref.weighted_agg_ref(stack, weights)


@_wagg_op.register_fake
def _(stack, weights):
    return stack.new_empty((stack.shape[1],))


@torch.library.custom_op("repro_torch::kmeans_assign", mutates_args=())
def _kmeans_op(x: torch.Tensor, centroids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.kmeans_assign_ref(x, centroids)


@_kmeans_op.register_fake
def _(x, centroids):
    n = x.shape[0]
    return (x.new_empty((n,), dtype=torch.int32),
            x.new_empty((n,), dtype=torch.float32))


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula
    lib = torch.ops.repro_torch

    @register_flop_formula(lib.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, softcap, out_shape=None,
          **kwargs):
        return flash_flops(q_shape, k_shape, causal, window)

    @register_flop_formula(lib.weighted_agg_multi)
    def _(leaf_shapes, w_shape, out_shape=None, **kwargs):
        return stage1_flops(w_shape[0], w_shape[1],
                            out_shape[0] // w_shape[1])

    @register_flop_formula(lib.weighted_agg)
    def _(stack_shape, w_shape, out_shape=None, **kwargs):
        return stage1_flops(stack_shape[0], 1, stack_shape[1])

    @register_flop_formula(lib.kmeans_assign)
    def _(x_shape, c_shape, out_shape=None, **kwargs):
        return kmeans_flops(x_shape[0], x_shape[1], c_shape[0])


_register_flop_formulas()
