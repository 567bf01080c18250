"""host_read_ms.round: host milliseconds a round inside the program's
``host_read/*`` spans (`core/engine.py::host_read`: the re-cluster
check, a gated window, the history's fetch), clipped to the window: the
time the host waits on the card, where ``engine.HOST_READS`` counts the
reads."""
from pb.spans import host_ms


def read(ctx):
    return host_ms(ctx, "host_read/", "round")
