"""Bytes of one stage-1 aggregation (``weighted_agg_multi``): the (C, P)
client stack read once, the (C, K) f32 weights read once, the (K, P)
cluster models written once."""
from __future__ import annotations

from pb import peaks


def bytes_moved(clients: int, columns: int, clusters: int,
                elem_bytes: int) -> int:
    return (clients * columns * elem_bytes + clients * clusters * 4
            + clusters * columns * elem_bytes)


def bound_s(clients: int, columns: int, clusters: int,
            elem_bytes: int) -> float:
    """The least time the card could take: bytes at the HBM peak."""
    return bytes_moved(clients, columns, clusters, elem_bytes) \
        / peaks.HBM_BYTES_PER_S
