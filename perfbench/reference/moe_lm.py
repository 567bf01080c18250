"""Plain reference of FedHC rounds over mixture-of-experts transformer
clients (Mixtral, arXiv:2401.04088): the forward pass, loss, gradients,
local SGD with gradient accumulation, and the one-cluster aggregation,
in PyTorch at the configuration's precision.  It imports nothing of the
program.

Block (pre-norm): x + Attn(RMSNorm(x)), then + MoE(RMSNorm(.)); RMSNorm
with weight 1 + scale (the mean square in float32); causal
sliding-window grouped-query attention with rotary embeddings (the
half-split rotation, theta from the configuration), scores and softmax
in float32; a router over the experts (float32 softmax, top-k, the lower
index first among equal logits, the top-k logits' softmax as weights),
each routed token through its experts' SiLU-gated MLP, the weighted
outputs added in expert order; final RMSNorm, the unembedding, the mean
next-token cross-entropy of logits[:, :-1] against labels[:, 1:] in
float32, plus ``aux_weight`` times the Switch load-balance loss
E * sum_e (token share of e) * (mean probability of e).

Precision: weights, activations, gradients and the gradient sum in
bfloat16, as the configuration states.  ``fp8=True`` is the control:
every matrix product's operands quantized to float8 e4m3 (a scale per
tensor), the products accumulated as before.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (straight-through
    for the gradient)."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach().float() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q.to(x.dtype) - x).detach()


def _mm(fp8: bool) -> Callable:
    if not fp8:
        return torch.matmul
    return lambda a, b: torch.matmul(_q8(a), _q8(b))


def rms_norm(x, scale):
    """x / rms(x) * (1 + scale): the mean square in float32, the factor
    rounded to x's dtype before it scales x."""
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6).to(x.dtype) * (1.0 + scale)


def rope(x, theta: float):
    """x (B, S, H, D) rotated by position, the two halves of D paired."""
    s, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, device=x.device,
                                  dtype=torch.float32) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(m, p, x, mm):
    b, s, _ = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope(mm(x, p["wq"]).reshape(b, s, h, hd), m["rope_theta"])
    k = rope(mm(x, p["wk"]).reshape(b, s, kv, hd), m["rope_theta"])
    v = mm(x, p["wv"]).reshape(b, s, kv, hd)
    g = h // kv
    k = k.repeat_interleave(g, 2)
    v = v.repeat_interleave(g, 2)
    qf, kf = q.float().transpose(1, 2), k.float().transpose(1, 2)
    scores = mm(qf, kf.transpose(-1, -2)) / math.sqrt(hd)   # (B, H, S, S)
    i = torch.arange(s, device=x.device)
    keep = (i[None, :] <= i[:, None])
    if m.get("window_size"):
        keep &= i[None, :] > i[:, None] - m["window_size"]
    scores = scores.masked_fill(~keep, float("-inf"))
    prob = torch.softmax(scores, -1).to(x.dtype)
    out = mm(prob, v.transpose(1, 2))                       # (B, H, S, D)
    return mm(out.transpose(1, 2).reshape(b, s, h * hd), p["wo"])


def moe(m, p, x, mm):
    """(y, load-balance loss): each token through its top-k experts."""
    b, s, d = x.shape
    e, k = m["num_experts"], m["experts_per_token"]
    xt = x.reshape(b * s, d)
    logits = mm(xt, p["router"]).float()
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    top = order[:, :k]
    weights = torch.softmax(logits.gather(-1, top), -1)
    y = torch.zeros_like(xt)
    for j in range(e):
        tok, slot = (top == j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        he = F.silu(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j])
        ye = mm(he, p["w_down"][j]) * weights[tok, slot][:, None].to(x.dtype)
        y = y.index_add(0, tok, ye)
    probs = torch.softmax(logits, -1)
    share = F.one_hot(top, e).float().sum(1).mean(0)
    aux = e * (share * probs.mean(0)).sum()
    return y.reshape(b, s, d), aux


def loss_fn(m, fl, w: Dict[str, torch.Tensor], tokens, labels, fp8=False):
    """Training loss of one microbatch (B, S) under weights ``w`` (flat
    names, one layer cycle per index of the stacked leaves)."""
    mm = _mm(fp8)
    x = w["embed.embedding"][tokens]
    aux = torch.zeros((), device=x.device)
    for c in range(m["num_layers"]):
        lw = {name[len("layers.0."):]: t[c] for name, t in w.items()
              if name.startswith("layers.0.")}
        x = x + attention(m, {k.split(".", 1)[1]: v for k, v in lw.items()
                              if k.startswith("attn.")},
                          rms_norm(x, lw["norm1.scale"]), mm)
        y, a = moe(m, {k.split(".", 1)[1]: v for k, v in lw.items()
                       if k.startswith("moe.")},
                   rms_norm(x, lw["norm2.scale"]), mm)
        x = x + y
        aux = aux + a
    x = rms_norm(x, w["final_norm.scale"])
    logits = mm(x, w["embed.unembed"]).float()[:, :-1]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels[:, 1:].reshape(-1))
    return ce + fl["aux_weight"] * aux


def local_update(m, fl, w, batch, accum: int, fp8=False):
    """One client's SGD step over ``accum`` microbatches: the gradients
    summed in bfloat16, then w - lr/accum * sum.  Returns (new weights,
    the mean microbatch loss)."""
    names = list(w)
    rows = batch["tokens"].shape[0]
    micro = rows // accum
    g_acc = {n: torch.zeros_like(w[n]) for n in names}
    total = torch.zeros((), device=batch["tokens"].device)
    for i in range(accum):
        sl = slice(i * micro, (i + 1) * micro)
        leaves = [w[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            loss = loss_fn(m, fl, dict(zip(names, leaves)),
                           batch["tokens"][sl], batch["labels"][sl], fp8)
            grads = torch.autograd.grad(loss, leaves)
        for n, g in zip(names, grads):
            g_acc[n] += g
        total = total + loss.detach()
        del grads, leaves, loss
    step = fl["lr"] * (1.0 / accum)
    return {n: w[n] - step * g_acc[n] for n in names}, total / accum


def fl_round(m, fl, w: Dict[str, torch.Tensor], batch, accum: int,
             fp8=False):
    """One FedHC round of one cluster: every client's local step from the
    shared weights ``w``, then stage 1 (Eq. 12: weights 1/L_c
    normalized, the sum in float32), which stage 2 leaves as it is with
    one cluster.  Returns (the cluster's weights, the mean client loss,
    each leaf's norm of the float32 aggregated step over the learning
    rate: the gradient the update applies before bfloat16 rounds it, and
    each client's weights before the aggregation)."""
    c = batch["tokens"].shape[0]
    news: List[Dict[str, torch.Tensor]] = []
    losses = []
    for i in range(c):
        new, loss = local_update(m, fl, w, {k: v[i] for k, v in
                                            batch.items()}, accum, fp8)
        news.append(new)
        losses.append(loss)
    losses = torch.stack(losses)
    inv = 1.0 / losses.clamp_min(1e-8)
    wt = inv / inv.sum()
    out, grads = {}, {}
    for n in w:
        acc = torch.zeros(w[n].shape, dtype=torch.float32, device=w[n].device)
        for i in range(c):
            acc += wt[i] * news[i][n].float()
        out[n] = acc.to(w[n].dtype)
        grads[n] = float(torch.linalg.vector_norm(acc - w[n].float())) \
            / fl["lr"]
    return out, losses.mean(), grads, news
