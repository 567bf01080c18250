"""Orbital mechanics + clustering demo on the PyTorch/CUDA port: watch the
constellation drift, the dropout rate build up (Alg. 1 line 15),
re-clustering restore short intra-cluster links — the time-varying
connectivity substrate: the Earth-occluded ISL graph, multi-hop routes to
each cluster PS, and the ground-station contact windows that gate
fedspace-style global rounds — and the asynchronous buffered engine:
staleness-decay schedules, virtual per-client clocks, and the event
cadence vs a synchronous round.

    PYTHONPATH=src python examples/constellation_demo_torch.py           # cuda
    PYTHONPATH=src python examples/constellation_demo_torch.py --device cpu

The flow of ``examples/constellation_demo.py`` on ``repro_torch``; k-means
starts from seeded ``torch.Generator`` picks where the reference folds a
JAX key, so cluster layouts and numbers differ from its output.
``--rounds`` (sync rounds; the async run takes 4x as many events) and
``--plan-dt`` (seconds between contact-plan samples) shorten a run.  It
imports nothing of JAX.
"""
import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch import device as device_lib
from repro_torch.api import AsyncSpec, DataSpec, FleetSpec, Scenario, TrainSpec
from repro_torch.core import clustering as cl
from repro_torch.core import staleness as stale_lib
from repro_torch.orbits import contact as contact_lib
from repro_torch.orbits import topology
from repro_torch.orbits.constellation import (Constellation,
                                              ground_station_position,
                                              norm, visible)
from repro_torch.orbits.links import LinkParams, rate_bps


def kmeans_seeded(pos, k: int, seed: int):
    """k-means from k distinct satellites picked by ``seed``."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    return cl.kmeans(pos, k, torch.randperm(pos.shape[0], generator=gen,
                                            device=pos.device)[:k])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=6,
                    help="sync fedhc rounds (fedhc-async runs 4x as many "
                         "events at cohort 4: the same client work)")
    ap.add_argument("--plan-dt", type=float, default=60.0,
                    help="seconds between contact-plan samples")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    c = Constellation(num_planes=8, sats_per_plane=8)
    lp = LinkParams()
    k = 4
    pos0 = c.positions(0.0, device=dev)
    res = kmeans_seeded(pos0, k, 0)
    assignment, centroids, ps = res.assignment, res.centroids, res.ps_index
    # the drift loop below re-clusters; keep the t=0 state for the ISL
    # routing stats (which are computed on the t=0 geometry)
    assignment0, ps0 = assignment, ps
    print(f"constellation: {c.num_sats} sats @ {c.altitude_km:.0f} km, "
          f"period {c.period_s/60:.1f} min; K={k} clusters "
          f"(k-means converged in {int(res.iterations)} iters)")

    for minutes in (0, 10, 20, 30, 40):
        t = minutes * 60.0
        pos = c.positions(t, device=dev)
        nearest = cl.assign(pos, centroids)
        d_r = cl.dropout_rate(nearest == assignment, assignment, k)
        dist_ps = norm(pos - pos[ps.long()][assignment.long()])
        rate = rate_bps(dist_ps, lp) / 1e6
        vis = int(visible(pos[ps.long()],
                          ground_station_position(t_s=t, device=dev)).sum())
        print(f"t={minutes:3d}min  max dropout-rate={float(d_r.max()):.2f}  "
              f"mean link {float(dist_ps.mean()):7.1f} km "
              f"({float(rate.mean()):.2f} Mb/s)  PS visible to GS: {vis}/{k}")
        if float(d_r.max()) > 0.5:
            res = kmeans_seeded(pos, k, minutes)
            assignment, centroids, ps = (res.assignment, res.centroids,
                                         res.ps_index)
            dist2 = norm(pos - pos[ps.long()][assignment.long()])
            print(f"          -> RE-CLUSTERED: mean link "
                  f"{float(dist_ps.mean()):7.1f} -> "
                  f"{float(dist2.mean()):7.1f} km")

    # ---- time-varying connectivity: ISL graph + contact plan -------------
    print("\n--- ISL topology & contact plan ---")
    adj = topology.isl_adjacency(pos0, max_range_km=8000.0)
    hops = topology.hop_counts(adj, max_hops=8).cpu().numpy()
    tpb = topology.route_time_per_bit(pos0, lp, max_range_km=8000.0,
                                      max_hops=8).cpu().numpy()
    deg = adj.sum(1).cpu().numpy()
    print(f"t=0: ISL degree min/mean/max = {deg.min()}/{deg.mean():.1f}/"
          f"{deg.max()}, reachable pairs "
          f"{np.isfinite(hops).mean() * 100:.0f}%, max route "
          f"{int(hops[np.isfinite(hops)].max())} hops")
    tpb_ps = tpb[np.arange(c.num_sats),
                 ps0.cpu().numpy()[assignment0.cpu().numpy()]]
    model_bits = 2e6
    routed = np.where(np.isfinite(tpb_ps), tpb_ps * model_bits, np.nan)
    print(f"routed upload of a {model_bits / 1e6:.0f} Mb model to the PS: "
          f"mean {np.nanmean(routed):.1f}s, worst {np.nanmax(routed):.1f}s "
          f"({int(np.isfinite(tpb_ps).sum())}/{c.num_sats} members have a "
          f"route)")

    plan = contact_lib.build_contact_plan(c, lp, dt_s=args.plan_dt,
                                          device=dev)
    gs_visible = plan.gs_visible.cpu().numpy()
    vis_frac = float(gs_visible.any(axis=1).mean())
    print(f"contact plan: {plan.times.shape[0]} samples over one period; "
          f"ground station reachable {vis_frac * 100:.0f}% of the time")
    best_sat = int(gs_visible.sum(0).argmax())
    wins = contact_lib.contact_windows(plan, best_sat)
    pretty = ", ".join(f"{s / 60:.0f}-{e / 60:.0f}min" for s, e in wins)
    print(f"sat {best_sat} contact windows: {pretty}")
    print("fedspace defers any global round that lands outside these "
          "windows (engine carries a pending-aggregation flag)")

    # ---- asynchronous buffered aggregation -------------------------------
    print("\n--- async buffered engine (fedbuff / fedhc-async) ---")
    print("staleness-decay weight s(tau) by schedule "
          "(tau = server versions the update is behind):")
    taus = torch.arange(0.0, 9.0)
    for name in stale_lib.names():
        w = stale_lib.decay(name, taus, a=0.5, b=4.0).cpu().numpy()
        row = " ".join(f"{x:.2f}" for x in w)
        print(f"  {name:10s} tau=0..8: {row}")

    data = DataSpec(samples_per_client=32, eval_size=128)
    fleet = FleetSpec(num_clients=16, num_clusters=4)
    rounds, events = args.rounds, 4 * args.rounds
    # the sync rounds == 4x as many async events at cohort 4: same work
    h_sync = api.run(Scenario(
        method="fedhc", data=data, fleet=fleet,
        train=TrainSpec(rounds=rounds, eval_every=rounds,
                        rounds_per_global=4, local_steps=1, batch_size=16)),
        device=dev)
    h_async = api.run(Scenario(
        method="fedhc-async", data=data, fleet=fleet,
        train=TrainSpec(rounds=events, eval_every=events,
                        rounds_per_global=4, local_steps=1, batch_size=16),
        async_=AsyncSpec(cohort=4, buffer=4, staleness="polynomial")),
        device=dev)
    print(f"matched work ({16 * rounds} client-rounds): sync fedhc finishes "
          f"at T={h_sync.time_s[-1]:.0f}s; fedhc-async at "
          f"T={h_async.time_s[-1]:.0f}s "
          f"(x{h_sync.time_s[-1] / h_async.time_s[-1]:.2f} faster "
          f"simulated clock)")
    print(f"async telemetry: {h_async.flushes} buffer flushes, "
          f"{h_async.global_rounds} buffered stage-2 rounds, mean "
          f"staleness {h_async.mean_staleness:.2f} versions")
    print("the event engine pops the earliest-deadline cohort per step: "
          "fast satellites lap slow ones instead of idling on the "
          "cluster barrier; stale updates land with decayed weight")


if __name__ == "__main__":
    main()
