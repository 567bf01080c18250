"""Run a test body in W ranks of a ``gloo`` process group on the CPU.

A test helper, not a test: each rank is its own Python process (one
thread, ``src`` and ``tests`` on the path) that joins a group through a
file store in the test's temporary directory (TCP ports would collide
between test workers), runs ``body`` with ``rank``, ``world``, ``mesh``
(the client mesh of ``repro_torch.launch.mesh``) and an empty dict
``result`` in scope, and writes ``result`` as JSON.  A rank that fails
fails the call, and every rank is stopped.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
_store, _out = sys.argv[3], sys.argv[4]
from repro_torch.launch import mesh as mesh_lib
mesh_lib.init_process_group("cpu", init_method="file://" + _store,
                            rank=rank, world_size=world)
mesh = mesh_lib.make_client_mesh(0, device_type="cpu")
result = {}
"""

EPILOGUE = """
dist.destroy_process_group()
with open(_out, "w") as f:
    json.dump(result, f)
"""


class Ranks:
    """``world`` rank processes running a body; :meth:`wait` returns each
    rank's ``result``, or fails (stopping every rank) if one failed."""

    def __init__(self, world: int, body: str, tmp_dir, *,
                 timeout: float = 300.0, tag: str = "run"):
        store = os.path.join(str(tmp_dir), f"{tag}.store")
        self.outs = [os.path.join(str(tmp_dir), f"{tag}.{r}.json")
                     for r in range(world)]
        self.timeout = timeout
        code = PRELUDE + textwrap.dedent(body) + EPILOGUE
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src"),
                        os.path.join(ROOT, "tests")]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), store,
             self.outs[r]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]

    def wait(self):
        failures = []
        try:
            for r, p in enumerate(self.procs):
                try:
                    _, err = p.communicate(timeout=self.timeout)
                except subprocess.TimeoutExpired:
                    failures.append(f"rank {r}: timed out after "
                                    f"{self.timeout} s")
                    break
                if p.returncode != 0:
                    failures.append(f"rank {r} exited {p.returncode}:\n"
                                    f"{err[-4000:]}")
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not failures, "\n".join(failures)
        results = []
        for path in self.outs:
            with open(path) as f:
                results.append(json.load(f))
        return results


def run_ranks(world: int, body: str, tmp_dir, *, timeout: float = 300.0,
              tag: str = "run"):
    """Run ``body`` in ``world`` ranks; returns each rank's ``result``."""
    return Ranks(world, body, tmp_dir, timeout=timeout, tag=tag).wait()
