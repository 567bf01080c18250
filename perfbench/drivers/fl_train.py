"""Driver: FedHC training rounds over transformer clients
(`repro_torch.launch.steps.build_train_step`, the one-device form that
`launch/train.py::train` drives).

Set-up builds the step for the configuration's model (the arch's
published config, depth cut as the configuration says, every other
width checked against the file), fills the (C, ...) client stack with
the benchmark's initial weights (`traffic/lm_tokens.py`), and drives
that stack through the configuration's ``first_steps`` rounds with the
window's own call and fresh rows: they compile nothing but warm every
shape, and they are the steps compared.  A unit of the window is one
global period (``unit_rounds`` rounds), each round on fresh rows.

After the window the plain reference (`reference/moe_lm.py`) follows
the first steps from the same weights and rows.  Compared: each step's
loss, and by the worst leaf the norm of the first step's update over
the learning rate (the gradient as the optimizer applied it) and the
norm of the weights' change after the first steps, each as the gap of
the two norms over the reference's norm of that leaf or of the median
leaf, whichever is larger; and the first update itself, w1 - w0 at a
sample of each leaf's elements drawn from the seed, where the
reference's update spans at least ``MIN_STEPS`` bfloat16 steps of the
initial weight (so that one step of rounding is small beside it), as its
distance from the reference's over the reference's norm, the median over
the leaves.  The norms and the loss average the
precision's per-element errors away (PERF.md); the update's elements do
not.  A leaf whose reference
gradient is under a thousandth of the median leaf's is left out.
"""
from __future__ import annotations

import gc
import statistics
from typing import Any, Dict, List

import torch

from counts import moe_lm as lm_counts
from counts import stage1
from pb import peaks
from reference import moe_lm as ref_lm
from traffic import lm_tokens

SKIP_BELOW = 1e-3     # a leaf's reference gradient norm, against the median
SAMPLE = 1 << 20      # elements a leaf whose first update is compared
MIN_STEPS = 32        # ... where the reference's update spans this many
#                       bfloat16 steps of the initial weight


def _leaf(tree: Any, name: str) -> torch.Tensor:
    x = tree
    for part in name.split("."):
        x = x[int(part)] if isinstance(x, (tuple, list)) else x[part]
    return x


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat leaf names -> the program's tree ("layers" a tuple)."""
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    if "layers" in tree:
        tree["layers"] = tuple(tree["layers"][k]
                               for k in sorted(tree["layers"], key=int))
    tree.setdefault("rem_layers", ())
    return tree


def _rel_dist(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r|| in float64."""
    p, r = p.double(), r.double()
    return float(torch.linalg.vector_norm(p - r)
                 / torch.linalg.vector_norm(r).clamp_min(1e-300))


class Driver:
    unit = "lm_round"             # an FL round of transformer clients

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any],
                 seed: int, device, trace: bool):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.dev, self.trace = torch.device(device), trace
        self.m, self.fl = config["model"], config["fl"]
        self.limits = cell["limits"]
        self.unit_rounds = cell["traffic"]["unit_rounds"]
        self.first = self.fl["first_steps"]

    # ------------------------------------------------------------ set-up
    def program_config(self):
        """The arch's config at the file's depth; every other size the
        file states must be the program's."""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import depth_cut, smoke_variant
        cfg = get_config(self.config["arch"])
        if self.config.get("variant") == "smoke":     # the CPU tests' size
            cfg = smoke_variant(cfg)
        cfg = depth_cut(cfg, self.m["num_layers"])
        for k, v in self.m.items():
            got = getattr(cfg, k)
            got = list(got) if isinstance(got, tuple) else got
            if got != v:
                raise ValueError(f"{self.config['name']}: {k} is {v!r} in "
                                 f"the file and {got!r} in the program")
        return cfg

    def setup(self) -> None:
        from repro_torch.configs import InputShape
        from repro_torch.configs.runtime import RunProfile
        from repro_torch.launch.steps import build_train_step
        cfg = self.program_config()
        prof = RunProfile(arch=self.config["arch"], **self.config["profile"])
        fl = self.fl
        shape = InputShape("benchmark", fl["seq_len"], fl["global_batch"],
                           "train")
        clusters = [tuple(range(fl["num_clients"]))]
        if fl["num_clusters"] != 1:
            raise ValueError("the driver runs one cluster")
        self.bundle = build_train_step(
            self.config["arch"], shape, None, num_clusters=1, lr=fl["lr"],
            rounds_per_global=fl["rounds_per_global"],
            num_clients=fl["num_clients"], clusters=clusters,
            use_kernels=self.config["kernels"], cfg=cfg, profile=prof)
        self.accum = self.bundle.meta["accum"]
        dtype = getattr(torch, prof.param_dtype)
        c = fl["num_clients"]
        flat = {}
        for name, shape_, _ in lm_tokens.leaf_specs(self.m):
            x = torch.empty((c,) + tuple(shape_), dtype=dtype, device=self.dev)
            lm_tokens.init_leaf(self.m, name, self.seed, self.dev, out=x[0])
            x[1:].copy_(x[0].expand_as(x[1:]))
            flat[name] = x
        self.names = list(flat)
        self.stack = _nest(flat)
        del flat
        self.round = 0
        self.losses: List[float] = []
        self.grad_norms = self.change_norms = None
        for _ in range(self.first):
            self._round()
            if self.round == 1:
                self.grad_norms = self._change_norms(1.0 / self.fl["lr"])
                self.first_update = self._sampled_update(
                    lambda name: _leaf(self.stack, name)[0])
        self.change_norms = self._change_norms(1.0)

    def _round(self) -> float:
        batch = lm_tokens.rows(self.fl, self.m, self.seed, self.round,
                               self.dev)
        self.stack, loss = self.bundle.fn(self.stack, batch, self.round)
        self.round += 1
        loss = float(loss)                       # waits for the round
        if self.round <= self.first:
            self.losses.append(loss)
        return loss

    def _change_norms(self, scale: float) -> Dict[str, float]:
        """Per leaf, ||w - w0|| * scale of client 0's row (every row is
        the cluster's model after a round), w0 drawn again a leaf at a
        time."""
        out = {}
        for name in self.names:
            w = _leaf(self.stack, name)[0]
            w0 = lm_tokens.init_leaf(self.m, name, self.seed, self.dev,
                                     dtype=w.dtype)
            out[name] = float(torch.linalg.vector_norm(
                w.float() - w0.float())) * scale
            del w0
        return out

    def _sample_index(self, name: str, numel: int) -> torch.Tensor:
        from pb import seeds
        if numel <= SAMPLE:
            return torch.arange(numel, device=self.dev)
        g = seeds.generator(self.dev, self.seed, "lm/sample", name)
        return torch.randint(0, numel, (SAMPLE,), generator=g,
                             device=self.dev)

    def _sampled_update(self, leaf) -> Dict[str, torch.Tensor]:
        """Per leaf, w - w0 at a sample of its elements drawn from the
        seed (float32, on the host): ``leaf(name)`` gives w."""
        out = {}
        for name in self.names:
            w = leaf(name)
            idx = self._sample_index(name, w.numel())
            w0 = lm_tokens.init_leaf(self.m, name, self.seed, self.dev,
                                     dtype=w.dtype)
            out[name] = (w.reshape(-1)[idx].float()
                         - w0.reshape(-1)[idx].float()).cpu()
            del w0
        return out

    def _sampled_steps(self, w0, update) -> Dict[str, torch.Tensor]:
        """Per leaf, at the sampled elements: the update in bfloat16 steps
        (units in the last place) of the initial weight."""
        out = {}
        for name in self.names:
            idx = self._sample_index(name, w0[name].numel())
            p0 = w0[name].reshape(-1)[idx].float().abs().cpu()
            ulp = torch.exp2(torch.floor(torch.log2(p0.clamp_min(1e-38)))
                             - 7)
            out[name] = update[name].abs() / ulp
        return out

    # ------------------------------------------------------------ window
    def start_window(self) -> None:
        self.window_rounds = 0

    def run_unit(self) -> int:
        for _ in range(self.unit_rounds):
            self._round()
        self.window_rounds += self.unit_rounds
        return self.unit_rounds

    def layer_inputs(self, units: int) -> Dict[str, Any]:
        fl = self.fl
        per_round = lm_counts.train_flops(self.m, fl["seq_len"],
                                          fl["global_batch"])
        return {
            "model_flops": per_round * units,
            "peak_flops": peaks.FLOPS[self.config["precision"]],
            "stage1_calls": units,
            "stage1_bound_s": stage1.bound_s(
                fl["num_clients"], lm_counts.total_params(self.m),
                fl["num_clusters"], 2),
        }

    # ------------------------------------------------------------ check
    def release(self) -> None:
        self.stack = self.bundle = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compared_unit_done(self) -> bool:
        return True

    def program_answer(self) -> Dict[str, Any]:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms,
                "first_update": self.first_update}

    def _reference(self, fp8: bool) -> Dict[str, Any]:
        w0 = lm_tokens.init_weights(self.m, self.seed, self.dev)
        w = dict(w0)
        losses, grad_norms, true_grads = [], None, None
        for r in range(self.first):
            batch = lm_tokens.rows(self.fl, self.m, self.seed, r, self.dev)
            w, loss, grads, clients = ref_lm.fl_round(
                self.m, self.fl, w, batch, self.accum, fp8)
            losses.append(float(loss))
            if r == 0:
                true_grads = grads
                first_update = self._sampled_update(lambda n: w[n])
                steps = self._sampled_steps(w0, first_update)
                grad_norms = {n: float(torch.linalg.vector_norm(
                    w[n].float() - w0[n].float())) / self.fl["lr"]
                    for n in w}
            del clients
        change = {n: float(torch.linalg.vector_norm(
            w[n].float() - w0[n].float())) for n in w}
        del w, w0
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change, "true_grads": true_grads,
                "first_update": first_update, "steps": steps}

    def reference_answer(self, prog) -> Dict[str, Any]:
        return self._reference(fp8=False)

    def control_answer(self, prog) -> Dict[str, Any]:
        """The reference with float8 products, in the program's place."""
        return self._reference(fp8=True)

    def readings(self, prog: Dict[str, Any], ref: Dict[str, Any]
                 ) -> Dict[str, float]:
        med = statistics.median(ref["grad_norms"].values())
        keep = [n for n, v in ref["grad_norms"].items()
                if v >= SKIP_BELOW * med]

        def gap(key):
            r = ref[key]
            floor = statistics.median(r[n] for n in keep)
            return max(abs(prog[key][n] - r[n]) / max(r[n], floor)
                       for n in keep)
        return {
            "loss_rel": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], ref["losses"])),
            "grad_norm_gap": gap("grad_norms"),
            "update_norm_gap": gap("change_norms"),
            "first_update_rel": statistics.median(
                _rel_dist(prog["first_update"][n][m], ref["first_update"][n][m])
                for n in keep
                for m in [ref["steps"][n] >= MIN_STEPS]),
        }

    def leaf_detail(self, prog, ref, ctrl) -> Dict[str, Any]:
        """Per leaf, for the look behind a reading: the reference's
        unrounded gradient norm, each side's norms, and the program's and
        the control's sampled first update against the reference's."""
        return {n: {"true_grad": ref["true_grads"][n],
                    "grad": [prog["grad_norms"][n], ref["grad_norms"][n],
                             ctrl["grad_norms"][n]],
                    "change": [prog["change_norms"][n],
                               ref["change_norms"][n],
                               ctrl["change_norms"][n]],
                    "first_update_rel": [
                        _rel_dist(x["first_update"][n][m],
                                  ref["first_update"][n][m])
                        for x in (prog, ctrl)
                        for m in [ref["steps"][n] >= MIN_STEPS]],
                    "compared_elements": int(
                        (ref["steps"][n] >= MIN_STEPS).sum())}
                for n in ref["grad_norms"]}

    def check(self) -> List[Dict[str, Any]]:
        prog = self.program_answer()
        values = self.readings(prog, self.reference_answer(prog))
        return [{"name": k, "value": v, "limit": self.limits[k]}
                for k, v in values.items()]
