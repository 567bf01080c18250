"""Driver: FedHC's synchronous engine over LeNet clients
(`repro_torch.core.engine`), whole simulated runs back to back.

Set-up makes the inputs from the seed (`traffic/lenet_fl.py`), lets the
program derive the initial clusters (`core/clustering.kmeans`,
``ps_select``) and its round state (``engine.state_from_numpy``), and
warms every shape with one whole run.  A unit of the window is one run
of ``rounds`` rounds through ``engine.simulate`` from that state, on the
run's own minibatch picks; it ends in the run's one history fetch.

After the window one run, drawn from the seed among the first ones, is
checked twice.
- Round by round: the program runs it once more, and each of its rounds
  is held against the plain reference's round (`reference/fedhc.py`)
  from the program's own state before it: the worst relative loss gap,
  the worst leaf's update gap (``compare.update_gap``) and, on the
  evaluation rounds, the worst accuracy gap in test samples.  Local
  SGD, stage 1, stage 2, the drift check, the re-clustering with its
  MAML hand-off and the evaluation are each held to a tight limit in
  the round they run, and nothing accumulates from round to round.
- Whole: the reference runs the window's own run from the same inputs:
  the geometric mean over its first ``compare_rounds`` rounds (all of
  them, as the cell states it) of each round's relative loss gap, and
  over every round the simulated time and energy and the re-cluster /
  stage-2 / evaluation pattern.  This checks the start (the initial
  clusters and parameter servers) that the round-by-round check takes
  from the program.  A free run's worst round, accuracy and final
  models are not compared: the inverse-loss weights (Eq. 12) and the
  ReLUs let a float32 rounding difference grow round by round at a
  rate that differs from seed to seed (PERF.md).
"""
from __future__ import annotations

import gc
from typing import Any, Dict, List

import numpy as np
import torch

from counts import lenet as lenet_counts
from counts import stage1
from pb import peaks, seeds
from reference import compare
from reference import fedhc as ref_fedhc
from reference.fedhc import LEAVES
from traffic import lenet_fl


class Draws:
    """The engine's draws protocol, replaying the benchmark's picks."""

    def __init__(self, picks, starts):
        self.picks, self.starts = picks, starts

    def batch_picks(self, rnd: int):
        return self.picks[rnd]

    def kmeans_init(self, rnd: int):
        return self.starts[rnd]

    def central_picks(self, rnd: int, step: int):
        raise NotImplementedError("no centralized method runs here")


def scenario(config: Dict[str, Any], traffic: Dict[str, Any],
             telemetry: bool):
    from repro_torch.api import (AsyncSpec, DataSpec, ExecSpec, FleetSpec,
                                 Scenario, TrainSpec)
    from repro_torch.data.synthetic import DatasetSpec
    ds, fl, fleet = config["dataset"], config["fl"], config["fleet"]
    a = traffic.get("async", {})
    return Scenario(
        method=traffic["method"],
        data=DataSpec(dataset=DatasetSpec(**ds),
                      samples_per_client=fl["samples_per_client"],
                      dirichlet_alpha=fl["dirichlet_alpha"],
                      eval_size=fl["eval_size"]),
        fleet=FleetSpec(num_clients=fleet["num_clients"],
                        num_clusters=fleet["num_clusters"],
                        dropout_threshold=fl["dropout_threshold"],
                        round_minutes=fl["round_minutes"]),
        train=TrainSpec(rounds=traffic["rounds"],
                        rounds_per_global=fl["rounds_per_global"],
                        local_steps=fl["local_steps"],
                        batch_size=fl["batch_size"], lr=fl["lr"],
                        eval_every=traffic["eval_every"],
                        maml_alpha=fl["maml_alpha"],
                        maml_beta=fl["maml_beta"]),
        async_=AsyncSpec(**a),
        exec=ExecSpec(use_pallas_kernels=config["kernels"],
                      telemetry=telemetry))


def program_setup(eng, cfg, config: Dict[str, Any], inputs: Dict[str, Any],
                  device):
    """The program's set-up from the benchmark's inputs: the initial
    clusters and parameter servers on its constellation, then the engine
    ``eng``'s state and data (its ``state_from_numpy``)."""
    from repro_torch.core import clustering as cl
    from repro_torch.orbits.constellation import Constellation
    fleet = config["fleet"]
    k = fleet["num_clusters"]
    pos0 = Constellation(num_planes=fleet["num_planes"],
                         sats_per_plane=fleet["sats_per_plane"],
                         altitude_km=fleet["altitude_km"],
                         inclination_deg=fleet["inclination_deg"],
                         phasing=fleet["phasing"]).positions(0.0,
                                                            device=device)
    res = cl.kmeans(pos0, k, inputs["init_idx"])
    ps0 = cl.ps_select(pos0, res.centroids, res.assignment, k)
    arrays = {name: inputs[name] for name in
              ("images", "labels", "test_x", "test_y", "client_idx",
               "freqs")}
    arrays.update(w0=inputs["w0"], assignment0=res.assignment,
                  centroids0=res.centroids, ps_index0=ps0)
    arrays = _tree(lambda t: t.cpu(), arrays)
    return eng.state_from_numpy(cfg, arrays, device=device)


def _tree(f, x):
    if isinstance(x, dict):
        return {k: _tree(f, v) for k, v in x.items()}
    return f(x)


class Driver:
    unit = "round"
    scope = "fed_step/local_train"
    step_fn = "fed_step"          # the engine's round, as `simulate` calls it

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any],
                 seed: int, device, trace: bool):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.dev, self.trace = torch.device(device), trace
        self.traffic = cell["traffic"]
        self.rounds = self.traffic["rounds"]
        self.limits = cell["limits"]
        # the run compared after the window: one of the first few
        g = np.random.default_rng(seeds.mix(self.seed, "check_run"))
        self.check_run = int(g.integers(0, self.traffic["check_among"]))
        self.compare_rounds = self.traffic["compare_rounds"]
        self.runs = 0
        self.kept = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.core import engine
        self.engine = engine
        self.cfg = scenario(self.config, self.traffic, self.trace).to_flat()
        inputs = lenet_fl.make_inputs(self.config, self.seed, self.dev)
        self.state0, self.data = program_setup(engine, self.cfg,
                                               self.config, inputs, self.dev)
        self.inputs = _tree(lambda t: t.cpu(), inputs)
        del inputs
        self.starts = lenet_fl.recluster_starts(self.config, self.rounds,
                                                self.dev)
        self._simulate(lenet_fl.batch_picks(self.config, self.rounds,
                                            self.seed, -1, self.dev))

    def _simulate(self, picks):
        from repro_torch.core import engine
        state, outs = self.engine.simulate(
            self.cfg, device=self.dev, state0=self.state0, data=self.data,
            draws=Draws(picks, self.starts))
        return state, engine.split_outputs(outs)[0]

    # ------------------------------------------------------------ window
    def start_window(self) -> None:
        self.window_reclusters = self.window_evals = 0

    def run_unit(self) -> int:
        j = self.runs
        self.runs += 1
        picks = lenet_fl.batch_picks(self.config, self.rounds, self.seed, j,
                                     self.dev)
        state, outs = self._simulate(picks)
        self.window_reclusters += int(np.sum(outs.reclustered))
        self.window_evals += int(np.sum(outs.evaluated))
        if j <= self.check_run:
            self.kept = (j, outs)
        return self.rounds

    def layer_inputs(self, units: int) -> Dict[str, Any]:
        fleet = self.config["fleet"]
        p = lenet_counts.params(self.config["dataset"], self.config["model"])
        return {
            "model_flops": lenet_counts.run_flops(
                self.config, units, self.window_reclusters,
                self.window_evals, fleet["num_clients"]),
            "peak_flops": peaks.FLOPS[self.config["precision"]],
            "stage1_calls": units + self.window_reclusters,
            "stage1_bound_s": stage1.bound_s(fleet["num_clients"], p,
                                             fleet["num_clusters"], 4),
            "scope": self.scope,
        }

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Nothing yet: :meth:`stepwise` runs the compared run once more
        through the program and frees its state after."""

    def _free(self) -> None:
        self.state0 = self.data = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_state(self, state) -> Dict[str, Any]:
        """The program's round state as the reference's."""
        return {"params": state.params, "assign": state.assignment.long(),
                "cent": state.centroids, "ps": state.ps_index.long(),
                "t_sim": state.t_sim, "e_sim": state.e_sim}

    def _ref_step(self, inputs, state, picks, i: int, tf32: bool):
        return ref_fedhc.step(self.config, inputs, state, picks[i],
                              self.starts[i], i, self.rounds,
                              self.traffic["eval_every"], tf32=tf32)

    def _leaves(self, state) -> Dict[str, List[torch.Tensor]]:
        return {f"{n}.{k}": [state["params"][n][k]]
                for n in LEAVES for k in ("w", "b")}

    def stepwise(self, control: bool = False) -> Dict[str, Dict[str, float]]:
        """The compared run once more through the program, each step held
        against the reference's step from the program's own state before
        it: ``step_loss_rel`` (the worst relative gap of the step's mean
        loss), ``step_update_gap`` (the worst leaf's ||P - R|| / ||R - S||,
        S the state before, P and R the program's and the reference's
        after) and ``step_acc_gap`` (the worst accuracy gap of an
        evaluation step, in test samples).  With ``control`` the same of
        the TF32 reference in the program's place ("control").  Frees the
        program's state after."""
        inputs = _tree(lambda t: t.to(self.dev), self.inputs)
        picks = lenet_fl.batch_picks(self.config, self.rounds, self.seed,
                                     self.kept[0], self.dev)
        n_test = self.config["fl"]["eval_size"]
        sides = ("program", "control") if control else ("program",)
        gaps = {side: {"step_loss_rel": 0.0, "step_update_gap": 0.0,
                       "step_acc_gap": 0.0} for side in sides}
        real = getattr(self.engine, self.step_fn)

        def checked(ctx, state, i):
            new, row = real(ctx, state, i)
            before = self._ref_state(state)
            ref, want = self._ref_step(inputs, before, picks, i, False)
            answers = {"program": (self._ref_state(new),
                                   {"loss": float(row[1]),
                                    "acc": float(row[0])})}
            if control:
                answers["control"] = self._ref_step(inputs, before, picks,
                                                    i, True)
            for side, (nxt, got) in answers.items():
                g = gaps[side]
                g["step_loss_rel"] = compare.worse(
                    g["step_loss_rel"],
                    abs(got["loss"] - want["loss"]) / abs(want["loss"]))
                g["step_update_gap"] = compare.worse(
                    g["step_update_gap"], compare.update_gap(
                        self._leaves(nxt), self._leaves(ref),
                        self._leaves(before)))
                if want["evaluated"]:
                    g["step_acc_gap"] = compare.worse(
                        g["step_acc_gap"],
                        abs(got["acc"] - want["acc"]) * n_test)
            return new, row

        setattr(self.engine, self.step_fn, checked)
        try:
            self._simulate(picks)
        finally:
            setattr(self.engine, self.step_fn, real)
        del inputs, picks
        self._free()
        return gaps

    def compared_unit_done(self) -> bool:
        return self.runs > self.check_run

    def _reference(self, j: int, tf32: bool) -> Dict[str, Any]:
        inputs = _tree(lambda t: t.to(self.dev), self.inputs)
        picks = lenet_fl.batch_picks(self.config, self.rounds, self.seed, j,
                                     self.dev)
        out = ref_fedhc.run(self.config, inputs, picks, self.starts,
                            self.rounds, self.traffic["eval_every"],
                            self.compare_rounds, tf32=tf32)
        del inputs, picks
        return out

    def reference_answer(self, prog: Dict[str, Any]) -> Dict[str, Any]:
        return self._reference(prog["run"], tf32=False)

    def control_answer(self, prog: Dict[str, Any]) -> Dict[str, Any]:
        """The reference in TF32 (one precision below the configuration's
        float32), put in the program's place."""
        return self._reference(prog["run"], tf32=True)

    def readings(self, prog: Dict[str, Any], ref: Dict[str, Any]
                 ) -> Dict[str, float]:
        """The compared numbers between two answers of one run."""
        hp, hr = prog["history"], ref["history"]
        e = self.compare_rounds
        keys = ("reclustered", "did_global", "evaluated")
        pattern = sum(int(any(hp[k][r] != hr[k][r] for k in keys))
                      for r in range(self.rounds))
        return {
            "loss_gap_gmean": compare.gmean_rel(hp["loss"][:e],
                                                hr["loss"][:e]),
            "time_rel": compare.worst_rel(hp["time_s"], hr["time_s"]),
            "energy_rel": compare.worst_rel(hp["energy_j"], hr["energy_j"]),
            "pattern": float(pattern),
        }

    def program_answer(self) -> Dict[str, Any]:
        j, outs = self.kept
        return {"run": j, "history": {
            "acc": [float(x) for x in outs.acc],
            "loss": [float(x) for x in outs.loss],
            "time_s": [float(x) for x in outs.time_s],
            "energy_j": [float(x) for x in outs.energy_j],
            "reclustered": [int(x) for x in outs.reclustered],
            "did_global": [int(x) for x in outs.did_global],
            "evaluated": [bool(x) for x in outs.evaluated]}}

    def check(self) -> List[Dict[str, Any]]:
        values = self.stepwise()["program"]
        prog = self.program_answer()
        ref = self.reference_answer(prog)
        values.update(self.readings(prog, ref))
        return [{"name": k, "value": v, "limit": self.limits[k]}
                for k, v in values.items()]
