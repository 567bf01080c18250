"""Quickstart on the PyTorch/CUDA port: hierarchical clustered FL (FedHC)
on a simulated LEO constellation, through the typed Scenario API.

    PYTHONPATH=src python examples/quickstart_torch.py             # cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The flow of ``examples/quickstart.py`` on ``repro_torch``: ``api.run``
routes sync and async strategies and returns a ``RunResult`` (numpy
history arrays, ``time_to_accuracy``, ``save``/``load``); ``api.run_sweep``
runs a scenario over seeds with one shared setup of the contact plan.
It imports nothing of JAX.
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.api import (AsyncSpec, DataSpec, FleetSpec, Scenario,
                             TrainSpec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    base = Scenario(
        method="fedhc",
        data=DataSpec(samples_per_client=64, eval_size=512),
        fleet=FleetSpec(num_clients=16, num_clusters=3),
        train=TrainSpec(rounds=30, eval_every=10, local_steps=2),
    )

    print("== FedHC (hierarchical clustered FL, satellite PS) ==")
    h = api.run(base, device=dev, verbose=True)

    print("\n== C-FedAvg (centralized baseline) ==")
    c = api.run(base.replace(method="c-fedavg"), device=dev, verbose=True)

    print("\n== FedHC on the async event engine (cohorts of 4) ==")
    a = api.run(base.replace(method="fedhc-async",
                             async_=AsyncSpec(cohort=4, buffer=4)),
                device=dev, verbose=True)

    print("\nsummary (30 rounds / events):")
    print(f"  FedHC       acc={h.final_acc:.3f} time={h.time_s[-1]:8.0f}s "
          f"energy={h.energy_j[-1]:9.1f}J reclusters={h.reclusters}")
    print(f"  C-FedAvg    acc={c.final_acc:.3f} time={c.time_s[-1]:8.0f}s "
          f"energy={c.energy_j[-1]:9.1f}J")
    print(f"  FedHC-async acc={a.final_acc:.3f} time={a.time_s[-1]:8.0f}s "
          f"flushes={a.flushes} mean staleness={a.mean_staleness:.2f}")
    print(f"  -> FedHC uses {c.time_s[-1] / h.time_s[-1]:.1f}x less time, "
          f"{c.energy_j[-1] / h.energy_j[-1]:.1f}x less energy")
    target = 0.5
    tta = h.time_to_accuracy(target)
    print(f"  FedHC reached {target:.0%} accuracy "
          + (f"at T={tta.time_s:.0f}s / E={tta.energy_j:.0f}J "
             f"(round {tta.round})" if tta else "never (target too high)"))

    # scenarios are manifests: exact JSON round trip, in either package
    assert Scenario.from_json(base.to_json()) == base
    print(f"\nscenario manifest round-trips through JSON "
          f"({len(base.to_json())} bytes); RunResult.save() embeds it")

    print("\n== multi-seed sweep ==")
    seeds = (0, 1, 2)
    sweep = api.run_sweep(
        base.replace(train=TrainSpec(rounds=10, eval_every=5,
                                     local_steps=2)), seeds, device=dev)
    final_acc = sweep.final_acc
    print(f"  FedHC 10-round final acc over seeds {list(seeds)}: "
          f"{np.mean(final_acc):.3f} +/- {np.std(final_acc):.3f} "
          f"(reclusters per seed: {sweep.reclusters.tolist()})")


if __name__ == "__main__":
    main()
