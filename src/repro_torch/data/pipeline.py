"""Batching pipeline for FL training of the transformer shelf.

Counterpart of ``repro/data/pipeline.py``: a host-side iterator yielding
per-client batches ``tokens/labels (n_clients, per_client_batch, seq)``
(plus zero front-end inputs).  The streams come from
``numpy.random.RandomState``, so the tokens are the reference's exactly
for the same seed.  The reference's ``shardings=`` is ``mesh=`` here:
every rank draws every client's tokens (one stream) and keeps its own
rows of the client dim.  A real deployment swaps ``make_stream`` for its
tokenized corpus reader per satellite.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.launch import mesh as mesh_lib


def make_stream(seed: int, n_clients: int, vocab: int,
                non_iid_alpha: float = 0.3) -> np.ndarray:
    """Per-client unigram mixtures (Dirichlet non-IID over token space)."""
    rng = np.random.RandomState(seed)
    return rng.dirichlet([non_iid_alpha] * 256, size=n_clients)   # coarse


def _rows(mesh, n_clients: int) -> slice:
    """This rank's rows of the client dim on a 1-D client mesh."""
    if mesh is None:
        return slice(None)
    mesh_lib.validate_client_sharding(mesh, mesh_lib.mesh_axes(mesh),
                                      n_clients)
    group = mesh.get_group()
    per = n_clients // dist.get_world_size(group)
    lo = dist.get_rank(group) * per
    return slice(lo, lo + per)


def batches(seed: int, n_clients: int, pcb: int, seq: int, vocab: int,
            mesh=None, frontend: Optional[Dict] = None, *,
            device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields ``{"tokens", "labels", [front-end inputs]}`` on ``device``
    (default ``cuda``) forever; int32 tokens, bf16 zero front ends."""
    dev = device_lib.resolve(device)
    mix = make_stream(seed, n_clients, vocab)
    rng = np.random.RandomState(seed + 1)
    rows = _rows(mesh, n_clients)
    while True:
        coarse = np.stack([
            rng.choice(256, size=(pcb, seq + 1), p=mix[c])
            for c in range(n_clients)])
        offset = rng.randint(0, max(1, vocab - 256), size=(n_clients, 1, 1))
        toks = (coarse + offset).astype(np.int32)[rows]
        batch = {"tokens": torch.as_tensor(toks[:, :, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, :, 1:], device=dev)}
        for k, shape in (frontend or {}).items():
            batch[k] = torch.zeros((toks.shape[0], pcb) + tuple(shape),
                                   dtype=torch.bfloat16, device=dev)
        yield batch
