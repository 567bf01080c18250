"""The numbers a cell compares: each is a distance between the program's
answer and the reference's, held against a limit of its own."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def worst_rel(prog: Sequence[float], ref: Sequence[float]) -> float:
    """max |p - r| / |r| over paired entries (inf where one is NaN)."""
    out = 0.0
    for p, r in zip(prog, ref):
        d = abs(float(p) - float(r)) / abs(float(r))
        if math.isnan(d):
            return math.inf
        out = max(out, d)
    return out


ULP = 1e-7       # a float32 unit in the last place, relative


def gmean_rel(prog: Sequence[float], ref: Sequence[float]) -> float:
    """exp(mean log max(|p - r| / |r|, ULP)) over paired entries: the
    typical relative gap, one float32 ulp where they agree."""
    logs = []
    for p, r in zip(prog, ref):
        d = abs(float(p) - float(r)) / abs(float(r))
        if math.isnan(d):
            return math.inf
        logs.append(math.log(max(d, ULP)))
    return math.exp(sum(logs) / len(logs)) if logs else math.inf


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN reads as inf."""
    return math.inf if math.isnan(a) or math.isnan(b) else max(a, b)


def update_gap(prog: Dict[str, List[torch.Tensor]],
               ref: Dict[str, List[torch.Tensor]],
               before: Dict[str, List[torch.Tensor]]) -> float:
    """The worst leaf's ||P - R|| / ||R - S|| in float64: the distance
    between the program's and the reference's state after a step, over
    the reference's change from the state ``before`` it.  Each leaf is a
    list of stacks (norms taken over all of them)."""
    out = 0.0
    for name, r_parts in ref.items():
        num = den = 0.0
        for p, r, s in zip(prog[name], r_parts, before[name]):
            r = r.double()
            num += float(((p.double() - r) ** 2).sum())
            den += float(((r - s.double()) ** 2).sum())
        out = worse(out, math.sqrt(num) / math.sqrt(den) if den > 0
                    else (0.0 if num == 0 else math.inf))
    return out
