"""recluster_ms.round: device milliseconds a round, over all the window's
rounds, inside the program's ``fed_step/recluster`` span
(`core/engine.py::_recluster`: k-means, the cluster aggregation, the
Eq. 16-17 meta-update, the inner adaptation and the inheritance)."""
from pb.spans import device_ms


def read(ctx):
    return device_ms(ctx, "fed_step/recluster", "round")
