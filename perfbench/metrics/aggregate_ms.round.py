"""aggregate_ms.round: device milliseconds a round inside the program's
``fed_step/aggregate`` span (`core/engine.py::fed_step`: stage 1, and
stage 2 on its rounds)."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "fed_step/aggregate", "round")
