"""eval_ms.round: device milliseconds a round, over all the window's
rounds, inside the program's ``fed_step/eval`` span
(`core/engine.py::_finish`: the global model and its test accuracy)."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "fed_step/eval", "round")
