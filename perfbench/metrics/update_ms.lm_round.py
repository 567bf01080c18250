"""update_ms.lm_round: device milliseconds a round inside the program's
``lm_train/update`` span (`launch/steps.py::_local_update`: the
gradient accumulator's adds and the SGD step)."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "lm_train/update", "lm_round")
