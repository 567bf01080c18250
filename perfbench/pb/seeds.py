"""Seeds: every draw of a run comes from ``--seed`` and a stream name,
mixed into one 63-bit generator seed, so a draw does not depend on the
draws made before it and any whole number is a valid ``--seed``."""
from __future__ import annotations

import hashlib

_MASK64 = (1 << 64) - 1


def mix(*parts) -> int:
    """A 63-bit seed from integers and strings (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        if isinstance(p, str):
            p = int.from_bytes(hashlib.blake2b(p.encode(), digest_size=8)
                               .digest(), "little")
        h = ((h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


def generator(device, *parts):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(mix(*parts))
    return g
