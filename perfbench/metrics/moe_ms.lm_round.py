"""moe_ms.lm_round: device milliseconds a round inside the program's
``moe/experts`` span (`models/moe.py::apply_moe_scan`, the loop over the
experts): forward, remat recompute and backward.  The layer's recompute
runs inside the experts' backward range; its attention core, the
``attention/core`` span, is taken out (`pb/spans.py`), its projections
and norms stay."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "moe/experts", "lm_round",
                     without=("attention/core",))
