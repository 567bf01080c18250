"""Inter-satellite-link (ISL) topology: line-of-sight adjacency and
bounded multi-hop shortest-path routing.

Counterpart of ``repro/orbits/topology.py``.  Two satellites can talk
when the segment between them clears the Earth and lies within the
terminal's range; a member reaches its cluster PS over a multi-hop route
whose cost is the sum of per-hop seconds-per-bit (``1 / rate``, Eq. 6).

* :func:`min_plus_closure` -- all-pairs shortest paths of at most ``H``
  hops by (min,+) exponentiation by squaring.  One (min,+) product of
  (N,N) matrices would be an (N,N,N) intermediate (2 GB at N = 800), so
  :func:`_min_plus_mul` takes it in row chunks of at most
  :data:`MIN_PLUS_CHUNK_BYTES`; ``min`` is exact, so the chunked product
  is bit-identical to the unchunked one.
* :func:`route_rows_time_per_bit` -- only the ``sources`` rows of that
  closure, by ``max_hops`` Bellman-Ford relaxations with the one-hop
  weights regenerated in column blocks: O(N * block) memory, the form the
  factorized contact plan recomputes every round.

The reference's ``lax.scan``/``lax.map`` loops are Python loops here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.orbits import links as links_lib
from repro_torch.orbits.constellation import R_EARTH_KM, norm

# the largest (rows, N, N) intermediate of one chunk of a (min,+) product
MIN_PLUS_CHUNK_BYTES = 256 << 20


def pairwise_dist_km(positions: torch.Tensor) -> torch.Tensor:
    """(N,3) ECI km -> (N,N) inter-satellite distances."""
    return norm(positions[:, None, :] - positions[None, :, :])


def _segment_min_dist_two(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,3),(B,3) -> (N,B): min distance of the segment a_i -> b_j to the
    geocenter."""
    ab = b[None, :, :] - a[:, None, :]                   # (N,B,3)
    denom = (ab * ab).sum(-1).clamp_min(1e-12)
    t = (-(a[:, None, :] * ab).sum(-1) / denom).clamp(0.0, 1.0)
    closest = a[:, None, :] + t[..., None] * ab
    return norm(closest)


def segment_min_dist_to_origin(positions: torch.Tensor) -> torch.Tensor:
    """(N,3) -> (N,N): min distance of the segment sat_i -> sat_j to the
    geocenter (the occlusion discriminant).  Diagonal = |sat_i|."""
    return _segment_min_dist_two(positions, positions)


def line_of_sight(positions: torch.Tensor,
                  body_radius_km: float = R_EARTH_KM) -> torch.Tensor:
    """(N,N) bool: the straight segment between the two satellites clears
    the occluding body."""
    return segment_min_dist_to_origin(positions) >= body_radius_km


def isl_adjacency(positions: torch.Tensor, max_range_km: float,
                  body_radius_km: float = R_EARTH_KM) -> torch.Tensor:
    """(N,N) bool ISL graph: line of sight and within terminal range.
    Symmetric, no self-loops."""
    n = positions.shape[0]
    d = pairwise_dist_km(positions)
    adj = line_of_sight(positions, body_radius_km) & (d <= max_range_km)
    return adj & ~torch.eye(n, dtype=torch.bool, device=positions.device)


def _reflexive(adj: torch.Tensor, w) -> torch.Tensor:
    """One-hop weights: ``w`` on edges, inf off them, 0 on the diagonal."""
    n = adj.shape[0]
    w = torch.where(adj, w, torch.inf)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    return torch.where(eye, 0.0, w)


def _min_plus_mul(a: torch.Tensor, b: torch.Tensor,
                  chunk_bytes: int = MIN_PLUS_CHUNK_BYTES) -> torch.Tensor:
    """(min,+) matrix product ``out[i,j] = min_k a[i,k] + b[k,j]``, a chunk
    of rows at a time so that no intermediate exceeds ``chunk_bytes``."""
    m, n = a.shape[0], b.shape[1]
    per_row = b.shape[0] * n * a.element_size()
    rows = max(1, chunk_bytes // max(per_row, 1))
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    for i in range(0, m, rows):
        out[i:i + rows] = (a[i:i + rows, :, None]
                           + b[None, :, :]).amin(dim=1)
    return out


def min_plus_closure(w: torch.Tensor, max_hops: int,
                     chunk_bytes: int = MIN_PLUS_CHUNK_BYTES) -> torch.Tensor:
    """All-pairs shortest path weights using <= ``max_hops`` edges,
    exactly.

    ``w`` is the reflexive (N,N) one-hop weight matrix (0 on the diagonal,
    inf where no edge), so ``w^a`` admits up to ``a`` hops and squaring
    gives the exact ``w^max_hops`` in O(log max_hops) products.  The first
    product of the reference's loop multiplies the (min,+) identity, which
    returns its other factor bit for bit (``0 + x`` is ``x``); it is
    skipped."""
    e = max(1, int(max_hops))
    result: Optional[torch.Tensor] = None
    base = w
    while e:
        if e & 1:
            result = (base if result is None
                      else _min_plus_mul(result, base, chunk_bytes))
        e >>= 1
        if e:
            base = _min_plus_mul(base, base, chunk_bytes)
    return result


def _one_hop_tpb_cols(positions: torch.Tensor, col_pos: torch.Tensor,
                      col_ids: torch.Tensor, lp: links_lib.LinkParams,
                      max_range_km: float,
                      body_radius_km: float) -> torch.Tensor:
    """Columns ``col_ids`` of the reflexive one-hop weight matrix: 0 on the
    diagonal, ``1/rate`` where an ISL exists, inf elsewhere.  ``col_ids``
    >= N mark padding columns (all inf).  (N, B)."""
    n = positions.shape[0]
    d = norm(positions[:, None, :] - col_pos[None, :, :])
    los = _segment_min_dist_two(positions, col_pos) >= body_radius_km
    ids = torch.arange(n, dtype=col_ids.dtype, device=col_ids.device)
    same = ids[:, None] == col_ids[None, :]
    valid = (col_ids < n)[None, :]
    adj = los & (d <= max_range_km) & ~same & valid
    w = torch.where(adj, links_lib.time_per_bit(d, lp), torch.inf)
    return torch.where(same & valid, 0.0, w)


def route_rows_time_per_bit(positions: torch.Tensor, sources: torch.Tensor,
                            lp: links_lib.LinkParams, max_range_km: float,
                            max_hops: int,
                            body_radius_km: float = R_EARTH_KM,
                            col_block: int = 0) -> torch.Tensor:
    """Rows ``sources`` of the bounded-hop route closure, memory-linear.

    (S, N) f32 seconds-per-bit of the best ``<= max_hops`` route from each
    source to every satellite, the same quantity as
    ``route_time_per_bit(...)[sources]``, without the (N, N) weight
    matrix: ``max_hops`` relaxations ``r <- r (min,+) w`` with the one-hop
    columns regenerated from geometry per block (peak O(S * N * block)).
    Values match the closure to ~1e-6 relative (the sums associate
    differently); the inf/finite pattern matches exactly.  ``col_block=0``
    picks one block for N <= 2048 and 1024-wide blocks beyond."""
    n = positions.shape[0]
    dev = positions.device
    sources = sources.long()
    if not col_block:
        col_block = n if n <= 2048 else 1024
    block = min(int(col_block), n)
    nb = -(-n // block)
    pad = nb * block - n
    # padding rows sit at the geocenter: occluded from every satellite,
    # and masked out by the column-index guard regardless
    col_pos = (torch.cat([positions, positions.new_zeros((pad, 3))])
               if pad else positions)
    r = torch.where(sources[:, None] == torch.arange(n, device=dev)[None, :],
                    0.0, torch.inf)
    for _ in range(max(1, int(max_hops))):
        out = []
        for b0 in range(0, nb * block, block):
            ids = torch.arange(b0, b0 + block, dtype=torch.int32, device=dev)
            wb = _one_hop_tpb_cols(positions, col_pos[b0:b0 + block], ids,
                                   lp, max_range_km, body_radius_km)
            out.append((r[:, :, None] + wb[None, :, :]).amin(dim=1))
        r = torch.cat(out, dim=1)[:, :n]
    return r


def hop_counts(adj: torch.Tensor, max_hops: int) -> torch.Tensor:
    """(N,N) f32 minimum hop count through the ISL graph (inf when
    unreachable in <= max_hops); diagnostic companion of the time
    closure."""
    return min_plus_closure(_reflexive(adj, 1.0), max_hops)


def hop_rows(adj: torch.Tensor, sources: torch.Tensor,
             max_hops: int) -> torch.Tensor:
    """(S,N) f32 minimum hop count from each source to every satellite
    (inf when unreachable in <= ``max_hops``): the row form of
    :func:`hop_counts` for a small source set, O(max_hops * S * N^2)."""
    w = _reflexive(adj, 1.0)
    rows = w[sources.long()]                       # (S,N): <= 1 hop
    for _ in range(max(0, int(max_hops) - 1)):
        # one more hop: r'[s,j] = min_i r[s,i] + w[i,j]
        rows = torch.minimum(rows, (rows[:, :, None]
                                    + w[None, :, :]).amin(dim=1))
    return rows


def route_time_per_bit(positions: torch.Tensor, lp: links_lib.LinkParams,
                       max_range_km: float, max_hops: int,
                       body_radius_km: float = R_EARTH_KM) -> torch.Tensor:
    """(N,N) f32 seconds-per-bit of the cheapest ISL route of at most
    ``max_hops`` hops (edge weight ``1 / r_ij``): an upload of ``bits``
    costs ``bits * tpb`` seconds and ``P0 * bits * tpb`` joules.  ``inf``
    marks pairs with no such route."""
    d = pairwise_dist_km(positions)
    adj = isl_adjacency(positions, max_range_km, body_radius_km)
    return min_plus_closure(_reflexive(adj, links_lib.time_per_bit(d, lp)),
                            max_hops)
