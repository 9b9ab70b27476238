"""Walk/corpus diagnostics — the counterpart of the reference's accumulators
and per-superstep prints (SURVEY.md §5.1, §5.5).

The reference tracks two error counters — "Wrong Transports" (walker landed on a
partition that doesn't know its vertex) and "Zero Neighbors" (dead ends) — plus
unfinished-walker counts per superstep (RandomWalk.scala:89-90,117,124,150-160) and
per-executor replica/edge stats (UniformRandomWalk.scala:48-79). In this design:

  - Wrong Transports cannot happen by construction (routing is a total function
    route[v]; the owner always holds row(v)) — there is nothing to count.
  - Zero Neighbors = walks shorter than walk_length+2 (dead-end masked), counted here.
  - replica stats come from ShardedGraphHost.num_local / replication_factor.
  - boundary traffic (the all-to-all volume the reference shuffles per superstep)
    is computed from realized walks + the routing table.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class WalkStats:
    num_paths: int
    num_steps: int             # sampled transitions (first-order + second-order)
    full_paths: int            # reached walk_length + 2
    dead_ends: int             # "Zero Neighbors": stopped early at a 0-degree vertex
    isolated_starts: int       # length-1 paths (isolated source vertices)
    mean_length: float

    def as_dict(self) -> dict:
        return asdict(self)


def walk_stats(walks: np.ndarray) -> WalkStats:
    """Diagnostics over a dense [N, L+2] corpus (-1 padded)."""
    lengths = (walks >= 0).sum(axis=1)
    full = int(walks.shape[1])
    return WalkStats(
        num_paths=int(walks.shape[0]),
        num_steps=int(lengths.sum() - len(lengths)),
        full_paths=int((lengths == full).sum()),
        dead_ends=int(((lengths < full) & (lengths > 1)).sum()),
        isolated_starts=int((lengths == 1).sum()),
        mean_length=float(lengths.mean()) if len(lengths) else 0.0,
    )


def validate_walks(walks: np.ndarray, graph) -> dict:
    """Runtime invariant checks over a realized corpus — the product-surface
    analog of the reference's per-superstep sanity warnings (walker-count
    monotonicity RandomWalk.scala:150-153, paths-per-round == |V| :164-167),
    plus the stronger property the reference never checks: every consecutive
    pair in every walk is a real arc of the graph.

    Returns a dict of violation counts (all zero on a correct corpus); raises
    AssertionError on any violation.
    """
    V = graph.num_vertices
    a = walks[:, :-1]
    b = walks[:, 1:]
    valid = (a >= 0) & (b >= 0)
    # arc membership via packed sorted keys (vectorized; O(E log E))
    deg = (graph.offsets[1:] - graph.offsets[:-1]).astype(np.int64)
    src = np.repeat(np.arange(V, dtype=np.int64), deg)
    keys = np.unique(src * V + graph.cols.astype(np.int64))
    trans = a[valid].astype(np.int64) * V + b[valid].astype(np.int64)
    pos = np.searchsorted(keys, trans)
    pos = np.minimum(pos, max(len(keys) - 1, 0))
    bad_arcs = int((keys[pos] != trans).sum()) if len(keys) else int(valid.sum())
    # no resurrection: once -1, a row stays -1 (monotone completion mask)
    resurrect = int(((a < 0) & (b >= 0)).sum())
    # ids in range
    oob = int(((walks >= V) | (walks < -1)).sum())
    out = {"bad_arcs": bad_arcs, "resurrected": resurrect, "out_of_range": oob}
    assert not any(out.values()), f"walk invariant violations: {out}"
    return out


def boundary_traffic(walks: np.ndarray, route: np.ndarray) -> dict:
    """Fraction / count of walk transitions that cross shard boundaries — the volume
    the reference pays a Spark shuffle for per superstep (RandomWalk.scala:186-192)
    and this framework pays a device all-to-all for."""
    a = walks[:, :-1]
    b = walks[:, 1:]
    valid = (a >= 0) & (b >= 0)
    cross = valid & (route[np.maximum(a, 0)] != route[np.maximum(b, 0)])
    total = int(valid.sum())
    return {
        "transitions": total,
        "boundary_crossings": int(cross.sum()),
        "crossing_fraction": float(cross.sum() / total) if total else 0.0,
    }
