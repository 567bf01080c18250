"""Faults planted in the program, to show that a cell's comparison
catches them (the tests, and ``calibrate.py --fault``).  Each is a
function of a ``monkeypatch``-like object with ``setattr``; none runs in
the benchmark's own runs.

- ``*_unchanged``: a step returns its state unchanged.
- ``*_half_batch``: half of the batch left out, the mean taken over the
  rest.
- ``*_answer_altered``: the loss altered where it is produced.
- ``*_stage2_unweighted``: stage 2 weighs the clusters equally instead
  of by their data.
- ``*_eval_altered``: the accuracy altered where it is produced.
- ``sync_handoff_skipped``: a re-clustering moves no model: members
  that change cluster keep their old one (no MAML hand-off).

No cell spans chips, so none has an exchange between chips to leave out.
"""
from __future__ import annotations


class Patch:
    """A minimal ``monkeypatch``: ``setattr`` now, ``undo`` later."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


# ------------------------------------------------------------- LeNet

def sync_unchanged(mp):
    from repro_torch.core import engine
    from repro_torch.models.lenet import lenet_loss

    def frozen(params, images, labels, lr, steps, **kw):
        return params, lenet_loss(params, (images, labels))
    mp.setattr(engine, "_local_train", frozen)


def sync_half_batch(mp):
    from repro_torch.core import engine
    real = engine.client_batches

    def half(*a):
        imgs, labs = real(*a)
        return imgs[:, :imgs.shape[1] // 2], labs[:, :labs.shape[1] // 2]
    mp.setattr(engine, "client_batches", half)


def sync_answer_altered(mp):
    from repro_torch.core import engine
    real = engine._finish

    def altered(ctx, state, rnd, params, assignment, centroids, ps_index,
                reclustered, loss_val, *a, **kw):
        return real(ctx, state, rnd, params, assignment, centroids,
                    ps_index, reclustered, loss_val * 1.01, *a, **kw)
    mp.setattr(engine, "_finish", altered)


def stage2_unweighted(mp):
    import torch
    from repro_torch.core import aggregation as agg
    real = agg.global_aggregate

    def equal(cluster_stack, cluster_data_sizes):
        return real(cluster_stack, torch.ones_like(cluster_data_sizes))
    mp.setattr(agg, "global_aggregate", equal)


def _eval_altered(mp, module):
    real = module.lenet_accuracy

    def altered(*a, **kw):
        return real(*a, **kw) - 0.01       # one point of the test set
    mp.setattr(module, "lenet_accuracy", altered)


def sync_eval_altered(mp):
    from repro_torch.core import engine
    _eval_altered(mp, engine)


def sync_handoff_skipped(mp):
    from repro_torch.core import engine
    real = engine._recluster

    def skipped(ctx, rnd, positions, params, *a, **kw):
        _, assignment, centroids, ps_index = real(ctx, rnd, positions,
                                                  params, *a, **kw)
        return params, assignment, centroids, ps_index
    mp.setattr(engine, "_recluster", skipped)


# ------------------------------------------------------------- training

def train_unchanged(mp):
    from repro_torch.launch import steps
    real = steps._local_update

    def frozen(cfg, p, b, **kw):
        _, loss = real(cfg, p, b, **kw)
        return p, loss
    mp.setattr(steps, "_local_update", frozen)


def train_half_batch(mp):
    from repro_torch.launch import steps
    real = steps._local_update

    def half(cfg, p, b, *, accum, **kw):
        keep = max(1, accum // 2)
        rows = b["tokens"].shape[0] * keep // accum
        return real(cfg, p, {k: v[:rows] for k, v in b.items()},
                    accum=keep, **kw)
    mp.setattr(steps, "_local_update", half)


def train_answer_altered(mp):
    from repro_torch.launch import steps
    real = steps._local_update

    def altered(cfg, p, b, **kw):
        new, loss = real(cfg, p, b, **kw)
        return new, loss * 1.01
    mp.setattr(steps, "_local_update", altered)


sync_stage2_unweighted = stage2_unweighted
SYNC = (sync_unchanged, sync_half_batch, sync_answer_altered,
        sync_stage2_unweighted, sync_eval_altered, sync_handoff_skipped)
TRAIN = (train_unchanged, train_half_batch, train_answer_altered)
