"""Multi-chip engine tests on the 8-device virtual CPU mesh (the same
local-cluster-in-one-process technique the reference uses with local[*] + 8 RDD
partitions, UniformRandomWalkTest.scala:12-24; SURVEY.md §4 implication (c))."""

import jax
import numpy as np
import pytest

from stellar_rw_tpu.graph import io, partition
from stellar_rw_tpu.graph.csr import from_edge_arrays
from stellar_rw_tpu.parallel import distributed
from stellar_rw_tpu.walk import engine


def test_partition_halo_invariant(karate_path):
    """Every neighbor (either direction) of a shard's owned vertices has a local row
    replica — the invariant that makes prev-membership tests shard-local."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    hsg = partition.partition_graph(g, 4, build_glob2loc=True)
    for s in range(4):
        owned = np.nonzero(hsg.route == s)[0]
        for v in owned:
            cols, _ = g.neighbors(int(v))
            for u in cols:
                assert hsg.glob2loc[s, int(u)] >= 0, (s, v, u)
    # local rows replicate the global adjacency exactly
    for s in range(hsg.num_shards):
        for v in range(g.num_vertices):
            loc = hsg.glob2loc[s, v]
            if loc < 0:
                continue
            a, b = hsg.offsets[s, loc], hsg.offsets[s, loc + 1]
            gc, gw = g.neighbors(v)
            np.testing.assert_array_equal(hsg.cols[s, a:b], gc)
            np.testing.assert_array_equal(hsg.weights[s, a:b], gw)
    assert hsg.replication_factor >= 1.0


def test_partition_respects_explicit_route(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    rng = np.random.default_rng(0)
    route = rng.integers(0, 3, size=g.num_vertices).astype(np.int32)
    hsg = partition.partition_graph(g, 3, route=route)
    np.testing.assert_array_equal(hsg.route, route)
    for s in range(3):
        assert hsg.num_owned[s] == int((route == s).sum())


@pytest.mark.parametrize("sampler", ["cdf", "rejection"])
@pytest.mark.parametrize("directed", [False, True])
def test_distributed_matches_single_chip(karate_path, sampler, directed):
    """Bitwise parity: the sharded engine must produce the identical corpus to the
    single-chip engine (counter-based per-walker streams make layout irrelevant)."""
    g = io.load_edge_list(karate_path, weighted=False, directed=directed)
    kw = dict(walk_length=15, num_walks=2, p=0.5, q=2.0, seed=11, sampler=sampler)
    if sampler == "cdf":
        kw["dtype"] = "float64"
    single = engine.random_walks(g, **kw)
    multi = distributed.distributed_random_walks(g, num_shards=8, **kw)
    np.testing.assert_array_equal(single, multi)


def test_distributed_vcut_route(karate_path):
    """Explicit (VCut-style) vertex->shard routing produces the same corpus too —
    routing changes placement, never the sampled walks."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    rng = np.random.default_rng(3)
    route = rng.integers(0, 8, size=g.num_vertices).astype(np.int32)
    kw = dict(walk_length=10, num_walks=1, p=1.0, q=1.0, seed=5, sampler="cdf",
              dtype="float64")
    single = engine.random_walks(g, **kw)
    multi = distributed.distributed_random_walks(g, num_shards=8, route=route, **kw)
    np.testing.assert_array_equal(single, multi)


def test_distributed_shard_count_invariance(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=8, num_walks=1, seed=2, sampler="rejection")
    w2 = distributed.distributed_random_walks(g, num_shards=2, **kw)
    w8 = distributed.distributed_random_walks(g, num_shards=8, **kw)
    np.testing.assert_array_equal(w2, w8)


def test_bounded_exchange_overflow_identical(karate_path):
    """A tiny all-to-all capacity forces multi-round (overflow) exchanges; the
    corpus must be bitwise identical regardless (SURVEY.md §7 hard-part 3: the
    bounded exchange only changes WHEN a request is served, never its uniforms)."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=10, num_walks=2, seed=7, sampler="rejection")
    single = engine.random_walks(g, **kw)
    multi, stats = distributed.distributed_random_walks(
        g, num_shards=8, capacity=1, return_stats=True, **kw)
    np.testing.assert_array_equal(single, multi)
    # with C=1 and ~34*2/8 walkers per shard mostly crossing (hash route), some
    # supersteps MUST take >1 exchange round — otherwise the cap wasn't binding
    assert stats["overflow_steps"] > 0, stats
    assert stats["capacity"] == 1


def test_superstep_diagnostics(karate_path):
    """Per-superstep psum'd counters: boundary walkers + zero neighbors (the
    reference's per-superstep prints, RandomWalk.scala:150-160)."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks, stats = distributed.distributed_random_walks(
        g, walk_length=6, num_walks=1, seed=3, num_shards=4, return_stats=True)
    diag = stats["diag"]
    # walk_length + 1 supersteps (first-order + L) x (crossings, dead, rounds,
    # static-schedule overflow)
    assert diag.shape == (7, 4)
    assert stats["static_schedule_overflow"] == 0
    # karate has no dead ends (connected, undirected)
    assert stats["zero_neighbors"] == 0
    # hash routing on karate: most transitions cross shards
    assert stats["boundary_walkers"] > 0
    # diag boundary counts must equal a host-side recount from the corpus: a
    # request at superstep t is remote iff route[cur_t] differs from the shard
    # HOSTING the walker (walkers are hosted by contiguous gid slice, gid // n)
    from stellar_rw_tpu.graph.partition import partition_graph
    route = partition_graph(g, 4).route
    S, W = 4, g.num_vertices
    W_pad = -(-W // S) * S
    n = 1 * W_pad // S                      # num_walks=1
    host_shard = (np.arange(W) // n).astype(np.int32)   # gid = w for round 0
    # walker samples at superstep t (t = 0..L) iff it was alive: for t=0 always
    # (real start), for t>=1 iff walks[:, t] >= 0 (it arrived somewhere at t)
    cur = walks[:, :-1]                     # position when sampling superstep t
    alive = cur >= 0
    remote = alive & (route[np.maximum(cur, 0)] != host_shard[:, None])
    assert stats["boundary_walkers"] == int(remote.sum()), (
        stats["boundary_walkers"], int(remote.sum()))


def test_distributed_dead_ends(testgraph_path):
    g = io.load_edge_list(testgraph_path, weighted=False, directed=True)
    idx = {int(o): i for i, o in enumerate(g.ids)}
    walks = distributed.distributed_random_walks(
        g, walk_length=5, num_walks=1, seed=0, num_shards=2)
    by_start = {int(r[0]): r for r in walks}
    assert by_start[idx[1]][1] == idx[2] and np.all(by_start[idx[1]][2:] == -1)
    assert np.all(by_start[idx[2]][1:] == -1)


def test_partitioner_scales(karate_path):
    """Host preprocessing perf guard (round-1 verdict item 6): building + alias +
    hash + 8-way partitioning of a 200K-vertex / ~2.8M-arc power-law graph must
    take seconds, not minutes. Structure is validated by spot-check against
    the whole graph."""
    import os
    import sys
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    t0 = time.time()
    g = bench.synth_power_law_graph(200_000, 1_400_000, seed=11)
    g.build_alias_tables()
    g.build_hash_tables()
    hsg = partition.partition_graph(g, 8, build_glob2loc=True)
    dt = time.time() - t0
    # 120s: ~3x the unloaded time on this 2-vCPU host — the guard targets the
    # minutes-scale per-row-Python regressions, not scheduler noise
    assert dt < 120, f"host preprocessing took {dt:.1f}s at 200K vertices"
    assert hsg.replication_factor >= 1.0
    # spot-check: a few owned rows replicate the global adjacency exactly
    rng = np.random.default_rng(0)
    for v in rng.integers(0, g.num_vertices, 32):
        s = int(hsg.route[v])
        loc = hsg.glob2loc[s, v]
        a, b = hsg.offsets[s, loc], hsg.offsets[s, loc + 1]
        gc, gw = g.neighbors(int(v))
        np.testing.assert_array_equal(hsg.cols[s, a:b], gc)
        np.testing.assert_array_equal(hsg.weights[s, a:b], gw)


def test_rbg_impl_shard_invariance(karate_path):
    """The fast 'rbg' PRNG must keep the cross-engine / any-layout bitwise
    guarantee: same corpus at 1, 2, 8 shards and on the single-chip engine."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    ref = engine.random_walks(g, walk_length=11, num_walks=2, p=0.5, q=2.0,
                              seed=3, rng_impl="rbg")
    assert not np.array_equal(
        ref, engine.random_walks(g, walk_length=11, num_walks=2, p=0.5, q=2.0,
                                 seed=3, rng_impl="threefry")), \
        "rbg must actually change the stream"
    for S in (2, 8):
        w = distributed.distributed_random_walks(
            g, walk_length=11, num_walks=2, p=0.5, q=2.0, seed=3,
            num_shards=S, rng_impl="rbg")
        np.testing.assert_array_equal(w, ref, err_msg=f"S={S}")


def test_shard_padding_beyond_draw_width():
    """Round-2 advisor fix, end to end: W one below a DRAW_QUANTUM multiple with
    a shard count that does not divide the quantum makes W_pad = ceil(W/S)*S
    exceed draw_width(W); the sharded engine must still be bitwise identical to
    the single-chip engine (the old clamp misaligned every gid-gathered uniform
    for rounds r >= 1)."""
    from stellar_rw_tpu.graph.csr import from_edge_arrays
    from stellar_rw_tpu.ops import sampling
    V = sampling.DRAW_QUANTUM - 1                 # 8191; S=3 -> W_pad 8193 > 8192
    src = np.arange(V)
    dst = (src + 1) % V
    g = from_edge_arrays(src, dst, num_vertices=V, symmetrize=True)
    kw = dict(walk_length=4, num_walks=2, p=0.25, q=0.25, seed=9,
              sampler="rejection")
    single = engine.random_walks(g, **kw)
    multi = distributed.distributed_random_walks(g, num_shards=3, **kw)
    np.testing.assert_array_equal(single, multi)


def test_distributed_cdf_chunked_parity(karate_path, monkeypatch):
    """The streaming exact-CDF path must keep the cross-layout bitwise
    guarantee (its result depends only on row data + the walker's uniform,
    never on batch composition or serving shard)."""
    from stellar_rw_tpu.ops import sampling
    monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", 1)
    monkeypatch.setattr(sampling, "CDF_CHUNK", 4)
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=10, num_walks=2, p=100.0, q=100.0, seed=11,
              sampler="cdf", dtype="float64")
    single = engine.random_walks(g, **kw)
    multi = distributed.distributed_random_walks(g, num_shards=8, **kw)
    np.testing.assert_array_equal(single, multi)


def test_lanes_share_graph_shards(karate_path):
    """--lanes: several devices share one graph shard (the reference's
    per-executor GraphMap sharing, GraphMap.scala:11). The corpus must stay
    bitwise identical to the single-chip engine, and the replication factor
    must drop to the (device_count / lanes)-way partition's."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=9, num_walks=2, p=0.5, q=2.0, seed=4,
              sampler="rejection")
    single = engine.random_walks(g, **kw)
    multi, stats = distributed.distributed_random_walks(
        g, num_shards=8, lanes=2, return_stats=True, **kw)
    np.testing.assert_array_equal(single, multi)
    assert stats["num_shards"] == 4 and stats["lanes"] == 2
    rf4 = partition.partition_graph(g, 4).replication_factor
    rf8 = partition.partition_graph(g, 8).replication_factor
    assert abs(stats["replication_factor"] - rf4) < 1e-9
    assert rf4 <= rf8
    # boundary accounting still exact: requests for vertices on my own shard
    # are local regardless of lane
    assert stats["boundary_walkers"] > 0


def test_lanes_dead_ends_and_directed(testgraph_path):
    """Dead-end semantics through the lanes path (directed chain fixture):
    identical to the single-chip engine."""
    g = io.load_edge_list(testgraph_path, weighted=False, directed=True)
    single = engine.random_walks(g, walk_length=5, num_walks=2, seed=1)
    multi = distributed.distributed_random_walks(
        g, walk_length=5, num_walks=2, seed=1, num_shards=2, lanes=2)
    np.testing.assert_array_equal(single, multi)


def test_cdf_path_choice_is_layout_invariant(karate_path, monkeypatch):
    """The chunked-vs-padded exact-CDF decision must derive from the same
    corpus-level quantity in every engine (round-3 advisor, medium): the two
    paths are only distribution-identical, so a layout-local decision silently
    breaks the cross-layout bitwise guarantee when batch*max_degree straddles
    CDF_PAD_LIMIT."""
    from stellar_rw_tpu.ops import sampling

    calls = []
    orig = sampling.plan_cdf_chunk_corpus

    def spy(num_walks, n_starts, max_degree):
        calls.append((num_walks, n_starts, max_degree))
        return orig(num_walks, n_starts, max_degree)

    monkeypatch.setattr(sampling, "plan_cdf_chunk_corpus", spy)
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=5, num_walks=3, p=0.5, q=2.0, seed=3,
              sampler="cdf", dtype="float64")
    single = engine.random_walks(g, **kw)
    multi = distributed.distributed_random_walks(g, num_shards=8, **kw)
    np.testing.assert_array_equal(single, multi)
    assert len(calls) == 2 and calls[0] == calls[1], calls


def test_resolve_lanes_divisor_fallback():
    """--lanes must divide the device count; non-divisors degrade to the
    largest divisor instead of crashing (round-3 advisor, low)."""
    from stellar_rw_tpu.models.node2vec import resolve_lanes

    assert resolve_lanes(6, 4) == 3
    assert resolve_lanes(8, 3) == 2
    assert resolve_lanes(8, 4) == 4
    assert resolve_lanes(8, 99) == 8   # clamped to S first
    assert resolve_lanes(7, 2) == 1
    assert resolve_lanes(1, 1) == 1


def test_compact_halo_routing_tables(karate_path):
    """Hash-policy compact routing (round-3 verdict item 5): owned rows must
    be exactly v // S (the arithmetic the device uses), every halo vertex must
    resolve through its 32-byte bucket row, and the glob2loc-free build must
    produce identical tables."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    S = 4
    hsg = partition.partition_graph(g, S, build_glob2loc=True)
    assert hsg.halo_buckets is not None and hsg.halo_nb is not None

    def halo_lookup(s, v):
        nb = int(hsg.halo_nb[s])
        h = int((np.uint64(v) * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF))
        row = hsg.halo_buckets[s, h & (nb - 1)]
        for i in range(4):
            if row[i] == v:
                return int(row[4 + i])
        return -1

    for s in range(S):
        for v in range(g.num_vertices):
            loc = int(hsg.glob2loc[s, v])
            if v % S == s:
                assert loc == v // S, (s, v, loc)       # owned: arithmetic row
                assert halo_lookup(s, v) == -1          # never in halo table
            else:
                assert halo_lookup(s, v) == loc, (s, v) # halo or absent (-1)

    hsg2 = partition.partition_graph(g, S, build_glob2loc=False)
    assert hsg2.glob2loc is None
    np.testing.assert_array_equal(hsg.halo_buckets, hsg2.halo_buckets)
    np.testing.assert_array_equal(hsg.halo_nb, hsg2.halo_nb)

    # explicit (VCut) routes are compact too (round-4 verdict missing item
    # 4): one packed route array + halo buckets, no per-shard glob2loc
    route = (np.arange(g.num_vertices) * 7 % 3).astype(np.int32)
    hsg3 = partition.partition_graph(g, 3, route=route)
    assert hsg3.halo_buckets is not None and hsg3.glob2loc is None
    assert hsg3.route_packed is not None
    bits = partition.shard_bits(3)
    hsg3d = partition.partition_graph(g, 3, route=route, build_glob2loc=True)
    for v in range(g.num_vertices):
        pr = int(hsg3.route_packed[v])
        assert pr & ((1 << bits) - 1) == route[v]          # owner shard
        assert pr >> bits == hsg3d.glob2loc[route[v], v]   # owned local row


def test_unpacked_partition_matches(karate_path):
    """build_packed=False (memory-lean validation mode) must still produce a
    bitwise-identical corpus through the unpacked sampler fallback."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=9, num_walks=2, p=0.5, q=2.0, seed=6,
              sampler="rejection")
    single = engine.random_walks(g, **kw)

    import numpy as np
    from stellar_rw_tpu.walk.engine import WalkSpec
    from stellar_rw_tpu.ops import sampling
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    hsg = partition.partition_graph(g, 4, build_glob2loc=False,
                                    build_packed=False)
    assert hsg.row_meta is None and hsg.halo_buckets is not None
    mesh = distributed.make_mesh(4)
    arrays, route_dev = distributed.device_put_sharded_graph(hsg, mesh)
    V = g.num_vertices
    W_pad = -(-V // 4) * 4
    starts_pad = np.full(W_pad, -1, np.int32)
    starts_pad[:V] = np.arange(V)
    sampler, max_rounds = sampling.plan_sampler("rejection", 0.5, 2.0)
    spec = WalkSpec(walk_length=9, p=0.5, q=2.0, sampler=sampler,
                    max_degree=g.max_degree,
                    n_search_iters=sampling.search_iters(g.max_degree),
                    max_rounds=max_rounds, n_stream=V, rng_impl="threefry")
    starts_dev = jax.device_put(
        jnp.asarray(starts_pad),
        NamedSharding(mesh, P((distributed.AXIS, distributed.LANE))))
    key = sampling.make_key(6, "threefry")
    paths, _ = distributed.distributed_walk_corpus(
        arrays, route_dev, starts_dev, key, np.int32(0), spec, 2, 4, 16,
        mesh, 1)
    multi = np.asarray(paths).reshape(2, W_pad, -1)[:, :V].reshape(2 * V, -1)
    np.testing.assert_array_equal(single, multi)


def test_streamed_upload_matches_stacked(karate_path):
    """device_put_sharded_graph_streamed must produce device arrays — and a
    corpus — bitwise identical to the stacked path, for hash and explicit
    routes and with lanes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from stellar_rw_tpu.ops import sampling
    from stellar_rw_tpu.walk.engine import WalkSpec

    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    V = g.num_vertices

    def corpus(arrays, route_dev, mesh, S, L, spec, W_pad):
        starts_pad = np.full(W_pad, -1, np.int32)
        starts_pad[:V] = np.arange(V)
        starts_dev = jax.device_put(
            jnp.asarray(starts_pad),
            NamedSharding(mesh, P((distributed.AXIS, distributed.LANE))))
        key = sampling.make_key(6, "threefry")
        paths, _ = distributed.distributed_walk_corpus(
            arrays, route_dev, starts_dev, key, np.int32(0), spec, 2, S, 16,
            mesh, L)
        return np.asarray(paths)

    for route, S, L in [(None, 4, 1), (None, 2, 2),
                        ((np.arange(V) * 3 % 3).astype(np.int32), 3, 1)]:
        D = S * L
        mesh = distributed.make_mesh(S, L)
        hsg = partition.partition_graph(g, S, route=route)
        a_stacked, r_stacked = distributed.device_put_sharded_graph(hsg, mesh)
        a_str, r_str, plan = distributed.device_put_sharded_graph_streamed(
            g, mesh, route=route)
        assert abs(plan.replication_factor - hsg.replication_factor) < 1e-9
        # deterministically-filled device arrays bitwise equal (np.empty
        # padding tails beyond each shard's fill differ and are never read:
        # cols/weights/alias/htab are checked through the corpus instead)
        for i in (0, 8):  # offsets, glob2loc/dummy
            np.testing.assert_array_equal(
                np.asarray(a_stacked[i]), np.asarray(a_str[i]),
                err_msg=str(i))
        assert set(a_stacked[-1]) == set(a_str[-1])
        for f in a_stacked[-1]:
            if f == "alias_packed":
                continue  # zero-padded in stacked, same live prefix; the
                #           prefix is validated through the corpus
            np.testing.assert_array_equal(
                np.asarray(a_stacked[-1][f]), np.asarray(a_str[-1][f]),
                err_msg=f)
        np.testing.assert_array_equal(np.asarray(r_stacked),
                                      np.asarray(r_str))
        W_pad = -(-V // D) * D
        sampler, max_rounds = sampling.plan_sampler("rejection", 0.5, 2.0)
        spec = WalkSpec(walk_length=7, p=0.5, q=2.0, sampler=sampler,
                        max_degree=g.max_degree,
                        n_search_iters=sampling.search_iters(g.max_degree),
                        max_rounds=max_rounds, n_stream=V,
                        rng_impl="threefry")
        np.testing.assert_array_equal(
            corpus(a_stacked, r_stacked, mesh, S, L, spec, W_pad),
            corpus(a_str, r_str, mesh, S, L, spec, W_pad))


def test_auto_capacity_spreads_over_remote_lanes():
    """A device's boundary walkers go to the (S-1) * lanes devices of the
    other graph shards, never to a lane of its own shard: the bucket holds
    1.5x that expected share, so lanes 2 halves it, and with lanes 2 over 2
    graph shards the expected share fits (it overflowed when the share was
    divided over S*lanes - 1 devices)."""
    rng = np.random.default_rng(0)
    V = 4000
    src = rng.integers(0, V, 40_000)
    dst = rng.integers(0, V, 40_000)
    keep = src != dst
    g = from_edge_arrays(src[keep], dst[keep], num_vertices=V,
                         symmetrize=True)
    route = (np.arange(V) % 2).astype(np.int32)
    n = 1000
    deg = np.diff(g.offsets)
    cross = float((np.repeat(route, deg) != route[g.cols]).mean())
    c1 = distributed.auto_capacity(g, route, 2, n)
    c2 = distributed.auto_capacity(g, route, 2, n, lanes=2)
    assert c1 == int(np.ceil(1.5 * cross * n))
    assert c2 == int(np.ceil(1.5 * cross * n / 2))
    assert c2 >= cross * n / 2          # one remote shard, two lanes
