"""attention_ms.lm_round: device milliseconds a round inside the
program's ``attention/core`` span (`models/attention.py::_train_core`,
the train-mode chunked core without the projections): forward, remat
recompute and backward."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "attention/core", "lm_round")
