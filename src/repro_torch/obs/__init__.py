"""Flight telemetry: the two-plane observability subsystem.

Counterpart of ``repro/obs``.

* **Device plane** (`obs/telemetry.py`): the opt-in ``ExecSpec.telemetry``
  knob makes the sync and async engines build a typed :class:`Telemetry`
  record each round or event, carried to the host by the run's one
  device-to-host copy: cohort composition, buffer occupancy, staleness
  spread, traffic and energy splits, route hop counts.  Telemetry **off**
  runs the engines without it; telemetry **on** adds outputs only and
  leaves the trajectory, the draws and the kernel launches unchanged
  (pinned by ``tests/test_torch_obs.py``).
* **Host plane** (`obs/trace.py`): a span tracer around setup / compile /
  run / fetch, exported as Chrome trace-event JSON for Perfetto, and
  process-wide counters on the setup cache of `repro_torch.api` and on
  contact-plan builds.
* **Profiler spans** (`obs/trace.py`): ``phase_scope`` and ``grad_scope``
  name the round's phases, the host's reads and the transformer layers'
  cores in a ``torch.profiler`` capture, backward included.  They open
  only while a capture runs, telemetry on or off, and insert nothing
  otherwise.

``RunResult.telemetry`` carries both planes (JSON round-trip through
``save``/``load``, in the reference's format), and
``python -m repro_torch.obs.report run.json`` renders a round-by-round
table, a phase-time breakdown and the trace export.
"""
from repro_torch.obs.telemetry import RunTelemetry, Telemetry, rounds_from_scan
from repro_torch.obs.trace import COUNTERS, Tracer, grad_scope, phase_scope

__all__ = ["Telemetry", "RunTelemetry", "rounds_from_scan",
           "Tracer", "COUNTERS", "phase_scope", "grad_scope"]
