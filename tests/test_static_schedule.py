"""Static-cascade rejection schedule (ops/sampling.rejection_sample_static).

The static plan replaces the dynamic sampler's while-loops (which keeps
`lax.while_loop` out of the walk scan) with a fixed compaction-level cascade
whose trials are
evaluated as batched blocks. Trial j consumes the same uniforms in both plans, so corpora
must be BITWISE identical whenever no compaction buffer overflows; on overflow
the engine re-dispatches dynamically (full trial-budget semantics preserved).
"""

import numpy as np
import pytest

import stellar_rw_tpu.ops.sampling as sp
from stellar_rw_tpu.graph.csr import CSRGraph, from_edge_arrays
from stellar_rw_tpu.parallel import distributed
from stellar_rw_tpu.walk import engine


def _random_graph(V=300, E=2400, seed=0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    keep = src != dst
    w = rng.uniform(0.5, 2.0, keep.sum()).astype(np.float32)
    return from_edge_arrays(src[keep], dst[keep], weights=w, num_vertices=V,
                            symmetrize=True)


@pytest.mark.parametrize("p,q", [(0.25, 0.25), (4.0, 0.25), (0.5, 2.0),
                                 (1.0, 0.25), (0.25, 1.0), (1.0, 1.0)])
def test_static_matches_dynamic_bitwise(p, q):
    g = _random_graph(seed=3)
    kw = dict(walk_length=12, num_walks=2, p=p, q=q, seed=7,
              sampler="rejection")
    static = engine.random_walks(g, schedule="static", **kw)
    dynamic = engine.random_walks(g, schedule="dynamic", **kw)
    np.testing.assert_array_equal(static, dynamic)


def test_static_overflow_reported_and_fallback(monkeypatch):
    """Shrink the compaction buffers until real stragglers cannot fit: the
    static dispatch must REPORT the overflow, and random_walks must fall back
    to the dynamic schedule and still produce the exact dynamic corpus."""
    import jax.numpy as jnp

    g = _random_graph(V=500, E=6000, seed=11)
    # p=q=4: non-member acceptance is 1/4 -> plenty of stragglers after the
    # two dense trials
    kw = dict(walk_length=8, num_walks=2, p=4.0, q=4.0, seed=2,
              sampler="rejection")
    dynamic = engine.random_walks(g, schedule="dynamic", **kw)

    monkeypatch.setattr(sp, "STATIC_S_FLOOR", 4)
    monkeypatch.setattr(sp, "STATIC_LEVELS", ((10**9, 4), (10**9, 0)))
    engine.walk_corpus.clear_cache()
    try:
        # the raw dispatch reports overflow
        from stellar_rw_tpu.ops import sampling as s2
        dg = s2.device_put_graph(g)
        spec = engine.WalkSpec(
            walk_length=8, p=4.0, q=4.0, sampler="rejection",
            max_degree=max(g.max_degree, 1),
            n_search_iters=s2.search_iters(g.max_degree),
            n_stream=g.num_vertices)
        starts = jnp.arange(g.num_vertices, dtype=jnp.int32)
        _, ovf = engine.walk_corpus(dg, starts, s2.make_key(2, "threefry"),
                                    spec, 2)
        assert int(np.asarray(ovf)) > 0

        # the product path falls back and matches the dynamic corpus exactly
        fallback = engine.random_walks(g, schedule="static", **kw)
        np.testing.assert_array_equal(fallback, dynamic)
    finally:
        engine.walk_corpus.clear_cache()


def test_distributed_static_matches_single_chip():
    """The sharded engine on the static schedule stays bitwise identical to
    the single-chip engine across shard counts (the cross-layout guarantee)."""
    g = _random_graph(V=240, E=2000, seed=5)
    kw = dict(walk_length=10, num_walks=2, p=0.25, q=0.25, seed=9,
              sampler="rejection")
    single = engine.random_walks(g, **kw)
    for S in (2, 4):
        sharded = distributed.distributed_random_walks(
            g, num_shards=S, schedule="static", **kw)
        np.testing.assert_array_equal(sharded, single)


def test_distributed_static_overflow_fallback(monkeypatch):
    """Distributed overflow: diag column 3 triggers the automatic dynamic
    re-dispatch inside distributed_random_walks."""
    g = _random_graph(V=200, E=2400, seed=13)
    kw = dict(walk_length=6, num_walks=1, p=4.0, q=4.0, seed=4,
              sampler="rejection")
    dynamic = engine.random_walks(g, schedule="dynamic", **kw)
    monkeypatch.setattr(sp, "STATIC_S_FLOOR", 4)
    monkeypatch.setattr(sp, "STATIC_LEVELS", ((10**9, 4), (10**9, 0)))
    distributed.distributed_walk_corpus.clear_cache()
    engine.walk_corpus.clear_cache()
    try:
        sharded = distributed.distributed_random_walks(
            g, num_shards=2, schedule="static", **kw)
        np.testing.assert_array_equal(sharded, dynamic)
    finally:
        distributed.distributed_walk_corpus.clear_cache()
        engine.walk_corpus.clear_cache()


def test_rbg_keys_route_to_dynamic_schedule():
    """'rbg' keys have no vmap-stable per-lane tail streams, so the engine must
    run the dynamic schedule under them even when schedule='static' (the
    static cascade would otherwise draw full-width uniforms for every tail
    trial). Both spellings must agree bitwise."""
    g = _random_graph(V=200, E=1600, seed=17)
    kw = dict(walk_length=8, num_walks=2, p=0.5, q=2.0, seed=3,
              sampler="rejection", rng_impl="rbg")
    static = engine.random_walks(g, schedule="static", **kw)
    dynamic = engine.random_walks(g, schedule="dynamic", **kw)
    np.testing.assert_array_equal(static, dynamic)
