"""Single-chip dense walk engine.

The accelerator replacement for the reference's BSP walk orchestration
(reference algorithm/RandomWalk.scala:75-176). Design changes (SURVEY.md §7):

  - No driver-side superstep loop, no unfinished-walker filtering, no walker transfer:
    ALL walkers advance in lock-step inside one `lax.scan`; dead-ends and completion are
    masks over a dense [W, walk_length+2] i32 buffer (-1 padding).
  - The reference's walk-shape invariants hold exactly: a full path has walk_length+2
    vertices (source + first-order step + walk_length second-order steps,
    RandomWalk.scala:103,132); dead-ends cut it short; an isolated source yields a
    length-1 path (RandomWalk.scala:59-61); the corpus is num_walks paths per vertex
    (RandomWalk.scala:82, README.md:146).
  - Randomness is counter-based: the uniform consumed by walker w at step t is
    uniform(fold_in(key, t))[w], so runs are reproducible and independent of device
    layout — the counterpart of the reference's injected `nextFloat` seam used by its
    deterministic tests (RandomWalk.scala:75-76).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import CSRGraph
from ..ops import sampling
from ..ops.sampling import DeviceGraph


class WalkSpec(NamedTuple):
    """Static walk configuration (hashable: used as a jit static argument)."""

    walk_length: int
    p: float
    q: float
    sampler: str = "rejection"   # "rejection" | "cdf"
    max_degree: int = 0          # static padded degree (cdf sampler)
    n_search_iters: int = 32     # binary-search iterations (>= log2(max_degree)+1)
    max_rounds: int = 16         # rejection-sampler round cap
    k_candidates: int = 4        # candidates evaluated per rejection round
    dtype: str = "float32"       # CDF accumulation dtype ("float64" for oracle parity)
    n_stream: int = 0            # unpadded walker count the uniform-stream width
    #                              derives from (0 = use the batch size); sharded
    #                              engines set it so padded layouts share streams
    rng_impl: str = "threefry"   # 'threefry' (cross-platform streams) or 'rbg'
    #                              (XLA RngBitGenerator: ~10x cheaper draws)
    cdf_chunk: int = 0           # >0: stream the exact-CDF sampler in chunk-wide
    #                              row slices (O(W*chunk) memory) instead of
    #                              padding every row to max_degree — the
    #                              extreme-p/q path on power-law graphs
    schedule: str = "static"     # rejection trial execution plan: "static"
    #                              (control-flow-free cascade + overflow
    #                              counter; the default) or "dynamic"
    #                              (while-loop compaction — the exact-in-all-
    #                              regimes fallback walk_corpus callers
    #                              re-dispatch on overflow)


def sample_next(g: DeviceGraph, spec: WalkSpec, cur, prev, alive, step_key):
    """One second-order transition for every walker (masked by `alive`).

    Always runs the DYNAMIC trial schedule (walk_once is the reference path;
    the static cascade — bitwise-identical absent overflow — lives in
    walk_corpus, which plumbs the overflow counter)."""
    dt = jnp.dtype(spec.dtype)
    if spec.sampler == "cdf":
        u = jax.random.uniform(step_key, cur.shape, dtype=dt)
        if spec.cdf_chunk:
            dst = sampling.cdf_sample_second_order_chunked(
                g, cur, prev, prev, u, spec.p, spec.q, spec.cdf_chunk, dt)
        else:
            dst = sampling.cdf_sample_second_order(
                g, cur, prev, prev, u, spec.p, spec.q, spec.max_degree,
                spec.n_search_iters, dt)
    else:
        dst = sampling.rejection_sample(
            g, cur, prev, prev, alive,
            sampling.round_uniforms(step_key, cur.shape[0],
                                    spec.n_stream or None),
            spec.p, spec.q, spec.n_search_iters, spec.max_rounds,
            k_candidates=spec.k_candidates,
            tail_draw=(sampling.tail_uniforms_batched(step_key[None],
                                                      cur.shape[0])
                       if sampling.use_tail_draws(spec.rng_impl) else None))
    return dst


def first_step(g: DeviceGraph, spec: WalkSpec, starts, step_key):
    """First-order step (reference RandomWalk.initFirstStep:51-66)."""
    dt = jnp.dtype(spec.dtype)
    if spec.sampler == "cdf":
        u = jax.random.uniform(step_key, starts.shape, dtype=dt)
        if spec.cdf_chunk:
            dst = sampling.cdf_sample_first_order_chunked(
                g, starts, u, spec.cdf_chunk, dt)
        else:
            dst = sampling.cdf_sample_first_order(
                g, starts, u, spec.max_degree, dt)
    else:
        u_pos, u_keep, _ = sampling.round_uniforms(
            step_key, starts.shape[0], spec.n_stream or None)(0)
        dst = sampling.alias_draw(g, starts, u_pos, u_keep)
    return dst


@partial(jax.jit, static_argnames=("spec",))
def walk_once(g: DeviceGraph, starts: jax.Array, key: jax.Array, spec: WalkSpec) -> jax.Array:
    """One walk per start vertex -> [W, walk_length+2] dense ids, -1 padded."""
    deg = g.offsets[1:] - g.offsets[:-1]
    deg_s = deg[starts]
    alive0 = deg_s > 0
    dst0 = first_step(g, spec, starts, jax.random.fold_in(key, 0))
    first = jnp.where(alive0, dst0, -1)

    def body(carry, t):
        cur, prev, alive = carry
        # clamp: cur is -1 for walkers dead since the first step; gathers
        # never see a negative index
        curc = jnp.maximum(cur, 0)
        alive = alive & (deg[curc] > 0)
        dst = sample_next(g, spec, curc, prev, alive,
                          jax.random.fold_in(key, t))
        out = jnp.where(alive, dst, -1)
        new_cur = jnp.where(alive, dst, cur)
        new_prev = jnp.where(alive, cur, prev)
        return (new_cur, new_prev, alive), out

    (_, _, _), cols = jax.lax.scan(
        body, (first, starts, alive0), jnp.arange(1, spec.walk_length + 1))
    return jnp.concatenate(
        [starts[:, None], first[:, None], cols.T.astype(jnp.int32)], axis=1)


@partial(jax.jit, static_argnames=("spec", "num_walks"))
def walk_corpus(g: DeviceGraph, starts: jax.Array, key: jax.Array,
                spec: WalkSpec, num_walks: int,
                round_offset: jax.Array | int = 0
                ) -> tuple[jax.Array, jax.Array]:
    """All `num_walks` rounds in ONE device dispatch ->
    ([num_walks*W, L+2] walks, i32 overflow counter).

    Bitwise identical to stacking num_walks calls of walk_once(g, starts,
    fold_in(key, r), spec): every walker consumes the same counter-based uniform
    stream (see round_uniforms_batched), but the device sees a num_walks-times
    larger dense batch per step — amortizing per-step gather latency and fixed
    kernel overhead that dominate small-graph rounds.

    The overflow counter sums rejection_sample_static's skipped-straggler
    counts across steps (always 0 for the dynamic/cdf paths); a nonzero value
    means the caller must re-dispatch with schedule="dynamic" to preserve the
    full trial-budget semantics (random_walks does this automatically).
    """
    W = starts.shape[0]
    R = num_walks
    dt = jnp.dtype(spec.dtype)
    keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(round_offset + jnp.arange(R))

    starts_b = jnp.tile(starts, R)
    deg = g.offsets[1:] - g.offsets[:-1]
    alive0 = deg[starts_b] > 0

    def step_keys(t):
        return jax.vmap(lambda k: jax.random.fold_in(k, t))(keys)

    def uniforms_1d(t):
        return jax.vmap(
            lambda k: jax.random.uniform(k, (W,), dtype=dt))(step_keys(t)).reshape(-1)

    use_vmeta = spec.sampler == "rejection" and g.vmeta is not None

    if use_vmeta:
        # vmeta carry: ONE [V,4] row gather per step serves the degree/alive
        # check, the alias row start, AND (carried one step) prev's membership
        # bucket meta — replacing three separate per-step gathers (deg[cur],
        # row_meta[cur], hash_meta[prev]). Bitwise-identical corpus: the same
        # values flow to the sampler, only their fetch path changes.
        vm0 = g.vmeta[starts_b]
        alive0 = vm0[:, 1] > 0
        u_pos, u_keep, _ = sampling.round_uniforms_batched(
            step_keys(0), W, spec.n_stream or None)(0)
        dst0 = sampling.alias_draw(g, starts_b, u_pos, u_keep,
                                   meta=(vm0[:, 0], vm0[:, 1]))
        first = jnp.where(alive0, dst0, -1)

        def body_vm(carry, t):
            cur, prev, alive, pm, ovf = carry
            vm = g.vmeta[jnp.maximum(cur, 0)]
            alive = alive & (vm[:, 1] > 0)
            kw = dict(
                k_candidates=spec.k_candidates,
                tail_draw=(sampling.tail_uniforms_batched(step_keys(t), W)
                           if sampling.use_tail_draws(spec.rng_impl)
                           else None),
                meta=(vm[:, 0], vm[:, 1], pm[:, 2], pm[:, 3]))
            args = (g, cur, prev, prev, alive,
                    sampling.round_uniforms_batched(step_keys(t), W,
                                                    spec.n_stream or None),
                    spec.p, spec.q, spec.n_search_iters, spec.max_rounds)
            # static needs the per-lane tail streams; 'rbg' keys (no
            # vmap-stable slices) would otherwise draw full-width uniforms
            # for EVERY tail trial — route them to the dynamic schedule
            if spec.schedule == "static" and kw["tail_draw"] is not None:
                dst, step_ovf = sampling.rejection_sample_static(*args, **kw)
                ovf = ovf + step_ovf
            else:
                dst = sampling.rejection_sample(*args, **kw)
            out = jnp.where(alive, dst, -1)
            new_cur = jnp.where(alive, dst, cur)
            new_prev = jnp.where(alive, cur, prev)
            new_pm = jnp.where(alive[:, None], vm, pm)
            return (new_cur, new_prev, alive, new_pm, ovf), out

        (_, _, _, _, ovf), cols = jax.lax.scan(
            body_vm, (jnp.where(alive0, first, starts_b), starts_b, alive0,
                      vm0, jnp.int32(0)),
            jnp.arange(1, spec.walk_length + 1))
        return jnp.concatenate(
            [starts_b[:, None], first[:, None], cols.T.astype(jnp.int32)],
            axis=1), ovf

    if spec.sampler == "cdf":
        if spec.cdf_chunk:
            dst0 = sampling.cdf_sample_first_order_chunked(
                g, starts_b, uniforms_1d(0), spec.cdf_chunk, dt)
        else:
            dst0 = sampling.cdf_sample_first_order(
                g, starts_b, uniforms_1d(0), spec.max_degree, dt)
    else:
        u_pos, u_keep, _ = sampling.round_uniforms_batched(
            step_keys(0), W, spec.n_stream or None)(0)
        dst0 = sampling.alias_draw(g, starts_b, u_pos, u_keep)
    first = jnp.where(alive0, dst0, -1)

    def body(carry, t):
        cur, prev, alive, ovf = carry
        # clamp before any gather: cur is -1 for walkers dead since step 1 (see
        # body_vm / walk_once note — negative fused-gather indices can fault)
        cur = jnp.maximum(cur, 0)
        alive = alive & (deg[cur] > 0)
        if spec.sampler == "cdf":
            if spec.cdf_chunk:
                dst = sampling.cdf_sample_second_order_chunked(
                    g, cur, prev, prev, uniforms_1d(t), spec.p, spec.q,
                    spec.cdf_chunk, dt)
            else:
                dst = sampling.cdf_sample_second_order(
                    g, cur, prev, prev, uniforms_1d(t), spec.p, spec.q,
                    spec.max_degree, spec.n_search_iters, dt)
        else:
            kw = dict(
                k_candidates=spec.k_candidates,
                tail_draw=(sampling.tail_uniforms_batched(step_keys(t), W)
                           if sampling.use_tail_draws(spec.rng_impl)
                           else None))
            args = (g, cur, prev, prev, alive,
                    sampling.round_uniforms_batched(step_keys(t), W,
                                                    spec.n_stream or None),
                    spec.p, spec.q, spec.n_search_iters, spec.max_rounds)
            # static needs the per-lane tail streams; 'rbg' keys (no
            # vmap-stable slices) would otherwise draw full-width uniforms
            # for EVERY tail trial — route them to the dynamic schedule
            if spec.schedule == "static" and kw["tail_draw"] is not None:
                dst, step_ovf = sampling.rejection_sample_static(*args, **kw)
                ovf = ovf + step_ovf
            else:
                dst = sampling.rejection_sample(*args, **kw)
        out = jnp.where(alive, dst, -1)
        new_cur = jnp.where(alive, dst, cur)
        new_prev = jnp.where(alive, cur, prev)
        return (new_cur, new_prev, alive, ovf), out

    (_, _, _, ovf), cols = jax.lax.scan(
        body, (first, starts_b, alive0, jnp.int32(0)),
        jnp.arange(1, spec.walk_length + 1))
    return jnp.concatenate(
        [starts_b[:, None], first[:, None], cols.T.astype(jnp.int32)],
        axis=1), ovf


@jax.jit
def corpus_invariants(g: DeviceGraph, walks: jax.Array) -> jax.Array:
    """On-device runtime invariant counters over a dense corpus (SURVEY.md §5.2).

    The reference only warns host-side on invariant violations (walker-count
    monotonicity RandomWalk.scala:150-153, paths-per-round :164-167); here the
    stronger properties are counted ON DEVICE as pure functional reductions (no
    checkify side-band needed — a 12-byte host read replaces error plumbing):
      [0] bad_arcs: consecutive pairs that are not real arcs (exact neighbor-set
          membership via the hash tables),
      [1] resurrected: -1 followed by a live vertex (completion must be monotone),
      [2] out_of_range: ids outside [-1, V).
    All zero on a correct corpus. Host wrapper: assert_corpus_invariants.
    """
    V = g.num_vertices
    a, b = walks[:, :-1], walks[:, 1:]
    valid = (a >= 0) & (b >= 0)
    member = sampling.in_row_hash(g, jnp.maximum(a, 0), jnp.maximum(b, 0))
    bad_arcs = jnp.sum(valid & ~member)
    resurrected = jnp.sum((a < 0) & (b >= 0))
    oob = jnp.sum((walks >= V) | (walks < -1))
    return jnp.stack([bad_arcs, resurrected, oob]).astype(jnp.int32)


def assert_corpus_invariants(g: DeviceGraph, walks: jax.Array) -> dict:
    """Raise if the device-side invariant counters are nonzero; returns them."""
    c = np.asarray(corpus_invariants(g, jnp.asarray(walks)))
    out = {"bad_arcs": int(c[0]), "resurrected": int(c[1]),
           "out_of_range": int(c[2])}
    assert not any(out.values()), f"walk invariant violations: {out}"
    return out


def random_walks(
    graph: CSRGraph,
    walk_length: int,
    num_walks: int,
    p: float = 1.0,
    q: float = 1.0,
    seed: int = 0,
    sampler: str = "rejection",
    dtype: str = "float32",
    starts: np.ndarray | None = None,
    device_graph: DeviceGraph | None = None,
    max_batch_walkers: int = 2_000_000,
    as_numpy: bool = True,
    rng_impl: str = "threefry",
    schedule: str = "static",
) -> np.ndarray:
    """Full corpus: num_walks rounds of one walk per vertex (reference
    RandomWalk.scala:82). Returns [num_walks * W, walk_length + 2] dense ids (-1 pad);
    round r of walker w sits at row r*W + w.

    Rounds are grouped into as few walk_corpus dispatches as fit max_batch_walkers
    (whole rounds only — the uniform streams are indexed by in-round walker position,
    so splitting a round would change which uniform a walker consumes).

    as_numpy=False returns the jax.Array instead — the device-resident handoff
    to train_skipgram (no corpus re-upload for the node2vec command)."""
    g = device_graph if device_graph is not None else sampling.device_put_graph(graph)
    if starts is None:
        starts = np.arange(graph.num_vertices, dtype=np.int32)
    sampler, max_rounds = sampling.plan_sampler(sampler, p, q)
    spec = WalkSpec(
        walk_length=walk_length, p=float(p), q=float(q), sampler=sampler,
        max_degree=max(graph.max_degree, 1),
        n_search_iters=sampling.search_iters(graph.max_degree),
        max_rounds=max_rounds,
        dtype=dtype,
        n_stream=len(starts),
        rng_impl=rng_impl,
        cdf_chunk=(sampling.plan_cdf_chunk_corpus(
            num_walks, len(starts), graph.max_degree)
            if sampler == "cdf" else 0),
        schedule=schedule,
    )
    starts_dev = jnp.asarray(starts, dtype=jnp.int32)
    base = sampling.make_key(seed, rng_impl)
    W = len(starts)
    per_batch = max(1, min(num_walks, max_batch_walkers // max(W, 1)))

    def run(spec):
        rounds, ovfs = [], []
        r = 0
        while r < num_walks:
            rb = min(per_batch, num_walks - r)
            # np (host) scalar, not jnp: no eager device op runs between the
            # async dispatches
            w, ovf = walk_corpus(g, starts_dev, base, spec, rb, np.int32(r))
            rounds.append(w)
            ovfs.append(ovf)
            r += rb
        out = jnp.concatenate(rounds, axis=0) if len(rounds) > 1 else rounds[0]
        return out, sum(int(np.asarray(o)) for o in ovfs)

    out, overflow = run(spec)
    if overflow:
        # static-cascade capacity exceeded (extreme straggler rate): re-run on
        # the dynamic schedule so every walker gets its full trial budget.
        # Bias regimes the planner routes here make this effectively
        # unreachable (capacities are 4-20x measured straggler rates).
        import logging
        logging.getLogger("stellar_rw_tpu").warning(
            "static rejection schedule overflowed (%d walkers); re-running "
            "corpus on the dynamic schedule", overflow)
        out, _ = run(spec._replace(schedule="dynamic"))
    return np.asarray(out) if as_numpy else out
