"""Plain reference of a synchronous FedHC run (FedHC paper, Alg. 1 and
§II-C, §III-B, §III-C) over LeNet-5 clients, in float32 PyTorch.

It imports nothing of the program.  From the benchmark's inputs (data,
partition, initial weights, CPU frequencies, k-means starts, minibatch
picks) it works out again everything the program derives: the Walker
constellation's positions, the initial clusters and their parameter
servers, each round's local SGD, the drift check, the two-stage
aggregation, the Eq. 6-10 time and energy, the re-clustering and its
MAML hand-off, and the evaluation.  LeNet's convolutions are products
over stacked shifted slices of the images, batched over the clients;
the pooling is ``F.max_pool2d``.

``tf32=True`` computes every product in TF32: the control that a sound
comparison has to reject.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

MU_KM3_S2 = 398600.4418
R_EARTH_KM = 6371.0
OMEGA_EARTH = 7.2921159e-5
LEAVES = ("c1", "c2", "f1", "f2", "f3")


# ---------------------------------------------------------------- orbits

def positions(fleet: Dict[str, Any], t_s: torch.Tensor) -> torch.Tensor:
    """(P * S, 3) ECI km of a Walker-delta constellation at time ``t_s``
    (a float32 0-d tensor); satellite i is plane i // S, slot i % S."""
    dev = t_s.device
    p, s = fleet["num_planes"], fleet["sats_per_plane"]
    radius = R_EARTH_KM + fleet["altitude_km"]
    period = 2.0 * math.pi * math.sqrt(radius ** 3 / MU_KM3_S2)
    inc = math.radians(fleet["inclination_deg"])
    plane = torch.arange(p, device=dev)
    slot = torch.arange(s, device=dev)
    raan = 2.0 * math.pi * plane / p
    anomaly = (2.0 * math.pi * slot / s)[None, :] \
        + (2.0 * math.pi * fleet["phasing"] * plane / (p * s))[:, None]
    u = anomaly + 2.0 * math.pi * t_s / period
    cu, su = torch.cos(u), torch.sin(u)
    co, so = torch.cos(raan)[:, None], torch.sin(raan)[:, None]
    x = cu * co - su * so * math.cos(inc)
    y = cu * so + su * co * math.cos(inc)
    z = su * math.sin(inc)
    return (torch.stack([x, y, z], -1) * radius).reshape(p * s, 3)


def ground_station(gs: Dict[str, Any], t_s: torch.Tensor) -> torch.Tensor:
    lat = math.radians(gs["lat_deg"])
    lon = math.radians(gs["lon_deg"]) + OMEGA_EARTH * t_s
    return R_EARTH_KM * torch.stack([
        math.cos(lat) * torch.cos(lon), math.cos(lat) * torch.sin(lon),
        torch.full_like(lon, math.sin(lat))]).reshape(3)


def dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt((d * d).sum(-1))


def sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Eq. 13 squared, (N, K), in the expanded form."""
    return ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
            + (c * c).sum(-1)[None, :])


def kmeans(pos, k: int, start, iters: int = 32, tol: float = 1e-4):
    """Eq. 13-15 from the centroids ``pos[start]``: ``iters`` steps, the
    centroids frozen once a step moves them less than ``tol`` (km^2).
    Returns (assignment, centroids, parameter server of each cluster)."""
    c = pos[start]
    done = False
    for _ in range(iters):
        a = sq_dist(pos, c).argmin(1)
        onehot = F.one_hot(a, k).float()
        n = onehot.sum(0)
        new = torch.where(n[:, None] > 0,
                          (onehot.T @ pos) / n.clamp_min(1.0)[:, None], c)
        shift = ((new - c) ** 2).sum()
        if not done:
            c = new
        done = done or bool(shift < tol)
    a = sq_dist(pos, c).argmin(1)
    return a, c, parameter_servers(pos, c, a, k)


def parameter_servers(pos, c, a, k: int) -> torch.Tensor:
    """The member nearest each centroid (index 0 for an empty cluster)."""
    d = sq_dist(pos, c).T                                        # (K, N)
    member = F.one_hot(a, k).T.bool()
    return torch.where(member, d, torch.inf).argmin(1)


# ---------------------------------------------------------------- costs

def rate_bps(d_km, links, to_ground: bool = False):
    """Eq. 6: B ln(1 + P0 h / N0), h = g0 / d^2 (boosted to the ground)."""
    h = links["gain_km2"] / d_km.clamp_min(1.0) ** 2
    if to_ground:
        h = h * links["gs_gain_boost"]
    return links["bandwidth_hz"] * torch.log(
        1.0 + links["tx_power_w"] * h / links["noise_w"])


def comm_s(bits: float, d_km, links, to_ground: bool = False):
    return bits / rate_bps(d_km, links, to_ground).clamp_min(1.0)


def member_costs(pos, ps_pos, sizes, freqs, bits, links, compute):
    """Eq. 8-9 per member: it computes, uploads to its PS and gets the
    cluster model back.  Returns (seconds, joules), each (C,)."""
    d = dist(pos, ps_pos)
    t_cmp = sizes * compute["cycles_per_sample"] / freqs
    e_cmp = compute["eps0"] * freqs * t_cmp
    t = t_cmp + comm_s(bits, d, links)
    e = 2.0 * links["tx_power_w"] * comm_s(bits, d, links) + e_cmp
    return t, e


def cluster_costs(pos, ps_pos, sizes, freqs, bits, links, compute):
    """Eq. 7 inner max and the members' energy sum."""
    t, e = member_costs(pos, ps_pos, sizes, freqs, bits, links, compute)
    return t.max(), e.sum()


def ground_costs(ps_pos, gs_pos, bits, links):
    """Eq. 7 outer term: every PS uploads to the ground station and gets
    the global model back."""
    t = comm_s(bits, dist(ps_pos, gs_pos[None]), links, to_ground=True)
    return t.max(), (2.0 * links["tx_power_w"] * t).sum()


# ---------------------------------------------------------------- LeNet

def _conv(x, w, b):
    """x (C, B, H, W, cin), w (C, kh, kw, cin, cout) -> (C, B, H', W',
    cout) valid convolution, per client: the kh kw shifted slices of a
    client's images, in the weights' own (kh, kw, cin) order, as the
    columns of one product with its (kh kw cin, cout) matrix, batched over
    the clients."""
    c, bsz, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape[1:]
    ho, wo = h - kh + 1, wd - kw + 1
    cols = torch.stack([x[:, :, i:i + ho, j:j + wo, :]
                        for i in range(kh) for j in range(kw)], 4)
    cols = cols.reshape(c, bsz * ho * wo, kh * kw * cin)
    y = torch.bmm(cols, w.reshape(c, kh * kw * cin, cout))
    return y.reshape(c, bsz, ho, wo, cout) + b[:, None, None, None, :]


def _pool(x):
    """2x2 max pooling of (C, B, H, W, ch)."""
    c, b, h, w, ch = x.shape
    y = F.max_pool2d(x.permute(0, 1, 4, 2, 3).reshape(c * b, ch, h, w), 2)
    return y.reshape(c, b, ch, h // 2, w // 2).permute(0, 1, 3, 4, 2)


def logits(p, images):
    """p: a client stack (C, ...) of LeNet leaves; images (C, B, H, W,
    ch) -> (C, B, classes)."""
    x = _pool(torch.relu(_conv(images, p["c1"]["w"], p["c1"]["b"])))
    x = _pool(torch.relu(_conv(x, p["c2"]["w"], p["c2"]["b"])))
    x = x.flatten(2)                          # (h, w, ch) order
    for name in ("f1", "f2"):
        x = torch.relu(x @ p[name]["w"] + p[name]["b"][:, None, :])
    return x @ p["f3"]["w"] + p["f3"]["b"][:, None, :]


def losses(p, images, labels):
    """(C,) mean cross-entropy of each client on its batch."""
    return F.cross_entropy(logits(p, images).flatten(0, 1),
                           labels.flatten(), reduction="none"
                           ).reshape(labels.shape).mean(1)


def grads(p, images, labels):
    leaves = [p[n][k].detach().requires_grad_(True)
              for n in LEAVES for k in ("w", "b")]
    q = {n: {"w": leaves[2 * i], "b": leaves[2 * i + 1]}
         for i, n in enumerate(LEAVES)}
    with torch.enable_grad():
        loss = losses(q, images, labels)
        g = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), {n: {"w": g[2 * i], "b": g[2 * i + 1]}
                           for i, n in enumerate(LEAVES)}


def tmap(f, *trees):
    return {n: {k: f(*(t[n][k] for t in trees)) for k in ("w", "b")}
            for n in LEAVES}


def sgd(p, g, lr):
    return tmap(lambda a, b: a - lr * b, p, g)


# ---------------------------------------------------------------- run

@contextlib.contextmanager
def _precision(tf32: bool):
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def run(config: Dict[str, Any], inputs: Dict[str, Any], picks, starts,
        rounds: int, eval_every: int, train_rounds: int, *,
        tf32: bool = False) -> Dict[str, Any]:
    """One run of ``rounds`` rounds, evaluated every ``eval_every`` and
    at the last: the per-round history.  The clients train, aggregate,
    hand off and are evaluated in the first ``train_rounds`` rounds (the
    loss and accuracy of later rounds are NaN); the constellation, the
    drift check, the re-clustering decisions and the time and energy are
    worked out for every round, since they do not depend on the
    weights."""
    with _precision(tf32), torch.no_grad():
        state = start(config, inputs, train_rounds > 0)
        hist = {key: [] for key in ("acc", "loss", "time_s", "energy_j",
                                    "reclustered", "evaluated",
                                    "did_global")}
        for rnd in range(rounds):
            state, row = _round(config, inputs, state, picks[rnd],
                                starts[rnd], rnd, rounds, eval_every,
                                rnd < train_rounds)
            for key, v in row.items():
                hist[key].append(v)
    return {"history": hist}


def start(config: Dict[str, Any], inputs: Dict[str, Any],
          train: bool = True) -> Dict[str, Any]:
    """The state before the first round: every client holds ``w0``, the
    clusters and parameter servers of k-means from ``init_idx`` at t = 0,
    no time or energy spent."""
    fleet = config["fleet"]
    c, k = fleet["num_clients"], fleet["num_clusters"]
    zero = torch.zeros((), device=inputs["images"].device)
    params = tmap(lambda x: x[None].expand((c,) + x.shape).clone(),
                  inputs["w0"]) if train else None
    assign, cent, ps = kmeans(positions(fleet, zero), k, inputs["init_idx"])
    return {"params": params, "assign": assign, "cent": cent, "ps": ps,
            "t_sim": zero.clone(), "e_sim": zero.clone()}


def step(config: Dict[str, Any], inputs: Dict[str, Any],
         state: Dict[str, Any], pick, start_idx, rnd: int, rounds: int,
         eval_every: int, *, tf32: bool = False):
    """Round ``rnd`` from ``state`` (the keys of :func:`start`): the next
    state and the round's history row."""
    with _precision(tf32), torch.no_grad():
        return _round(config, inputs, state, pick, start_idx, rnd, rounds,
                      eval_every, True)


def _round(config, inputs, state, pick, start_idx, rnd, rounds, eval_every,
           train):
    fleet, fl = config["fleet"], config["fl"]
    links, compute = config["links"], config["compute"]
    dev = inputs["images"].device
    c, k = fleet["num_clients"], fleet["num_clusters"]
    sizes = torch.full((c,), float(fl["samples_per_client"]), device=dev)
    freqs = inputs["freqs"]
    n_params = sum(inputs["w0"][n][kk].numel() for n in LEAVES
                   for kk in ("w", "b"))
    bits = n_params * 32.0
    params, assign, cent, ps = (state["params"], state["assign"],
                                state["cent"], state["ps"])
    t_sim, e_sim = state["t_sim"], state["e_sim"]

    pos = positions(fleet, t_sim)
    flat = torch.gather(inputs["client_idx"], 1, pick)
    imgs, labs = inputs["images"][flat], inputs["labels"][flat]
    in_region = sq_dist(pos, cent).argmin(1) == assign

    do_global = (rnd + 1) % fl["rounds_per_global"] == 0
    loss = None
    if train:
        params, loss = _train_and_aggregate(fl, k, params, imgs, labs,
                                            assign, sizes, do_global)

    t_r, e_r = cluster_costs(pos, pos[ps][assign], sizes, freqs, bits,
                             links, compute)
    if do_global:
        t_g, e_g = ground_costs(pos[ps], ground_station(
            config["ground_station"], t_sim), bits, links)
        t_r, e_r = t_r + t_g, e_r + e_g

    reclustered = 0
    if do_global:
        member = F.one_hot(assign, k).float()
        dropped = (member * (~in_region).float()[:, None]).sum(0)
        rate = dropped / member.sum(0).clamp_min(1.0)
        if bool(rate.max() > fl["dropout_threshold"]):
            a, cent, ps = kmeans(pos, k, start_idx)
            if train:
                params = _hand_off(fl, k, params, loss, imgs, labs,
                                   assign, a)
            assign = a
            reclustered = 1

    evaluated = (rnd + 1) % eval_every == 0 or rnd == rounds - 1
    acc = math.nan
    if evaluated and train:
        acc = accuracy(params, inputs["test_x"], inputs["test_y"])
    t_sim = t_sim + t_r + fl["round_minutes"] * 60.0
    e_sim = e_sim + e_r
    row = {"acc": acc,
           "loss": math.nan if loss is None else float(loss.mean()),
           "time_s": float(t_sim), "energy_j": float(e_sim),
           "reclustered": reclustered, "evaluated": evaluated,
           "did_global": int(do_global)}
    return ({"params": params, "assign": assign, "cent": cent, "ps": ps,
             "t_sim": t_sim, "e_sim": e_sim}, row)


def accuracy(params, test_x, test_y) -> float:
    """The share of the test set that the mean of the client stack
    classifies right."""
    mean = tmap(lambda x: x.mean(0, keepdim=True), params)
    pred = logits(mean, test_x[None]).argmax(-1)[0]
    return float((pred == test_y).float().mean())


def _train_and_aggregate(fl, k, params, imgs, labs, assign, sizes,
                         do_global):
    """Local SGD, then stage 1 (Eq. 12 inverse-loss weights within each
    cluster) and, on a stage-2 round, the data-weighted global model
    (Alg. 1 line 23) for everyone; else each member gets its cluster's
    model.  Returns (params, each client's loss at its last step)."""
    c = assign.shape[0]
    for _ in range(fl["local_steps"]):
        loss, g = grads(params, imgs, labs)
        params = sgd(params, g, fl["lr"])
    onehot = F.one_hot(assign, k).float()
    inv = 1.0 / loss.clamp_min(1e-8)
    w = inv / (onehot.T @ inv)[assign].clamp_min(1e-12)
    wm = onehot * w[:, None]
    clusters = tmap(lambda x: torch.einsum("ck,c...->k...", wm, x), params)
    if do_global:
        dk = onehot.T @ sizes
        wk = dk / dk.sum()
        glob = tmap(lambda x: torch.einsum("k,k...->...", wk, x), clusters)
        return tmap(lambda x: x[None].expand((c,) + x.shape).contiguous(),
                    glob), loss
    return tmap(lambda x: x[assign], clusters), loss


def _hand_off(fl, k, params, loss, imgs, labs, old, a):
    """Stage 1 under the new layout ``a`` (no participation mask), the
    MAML meta-update of each cluster model over its members (Eq. 16-17,
    first order), and for every member whose cluster changed the
    inherited model after one inner step."""
    onehot = F.one_hot(a, k).float()
    inv = 1.0 / loss.clamp_min(1e-8)
    w = inv / (onehot.T @ inv)[a].clamp_min(1e-12)
    wm = onehot * w[:, None]
    clusters = tmap(lambda x: torch.einsum("ck,c...->k...", wm, x), params)
    member = tmap(lambda x: x[a], clusters)
    _, g = grads(member, imgs, labs)
    adapted = sgd(member, g, fl["maml_alpha"])
    _, g = grads(adapted, imgs, labs)
    clusters = tmap(lambda m, gg: m - fl["maml_beta"] * torch.einsum(
        "ck,c...->k...", onehot, gg), clusters, g)
    inherited = tmap(lambda x: x[a], clusters)
    _, g = grads(inherited, imgs, labs)
    inherited = sgd(inherited, g, fl["maml_alpha"])
    moved = (a != old)
    return tmap(lambda new, cur: torch.where(
        moved.reshape((-1,) + (1,) * (new.dim() - 1)), new, cur),
        inherited, params)
