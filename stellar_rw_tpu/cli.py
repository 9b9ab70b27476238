"""CLI entry point: the counterpart of the reference `Main`
(reference Main.scala:18-27,109-127).

Same three subcommands dispatched on --cmd:
  node2vec   : walks + skip-gram, writes /path, /vec, /bin
  randomwalk : walks only, writes /path
  embedding  : reads a walks file from --input, trains skip-gram, writes /vec, /bin

Usage example (flag surface identical to the reference spark-submit app):
  python -m stellar_rw_tpu --cmd node2vec --input graph.txt --output out \
      --walkLength 80 --numWalks 10 --p 1.0 --q 1.0 --dim 128 --window 10
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np

from .graph import io as gio
from .models import node2vec as n2v
from .utils.config import Params, TaskName, parse

logger = logging.getLogger("stellar_rw_tpu")


def _load_graph(params: Params):
    """-> (graph, home): home = per-vertex home partition for VCut routing
    (reference VCutRandomWalk.scala:92-97), None on the uniform path."""
    if params.partitioned:
        return gio.load_edge_list_partitioned(
            params.input, weighted=params.weighted, directed=params.directed,
            partitioned=True, num_partitions=params.rdd_partitions, seed=params.seed)
    g = gio.load_edge_list(
        params.input, weighted=params.weighted, directed=params.directed)
    return g, None


def do_random_walk(params: Params) -> tuple[np.ndarray, "gio.csr.CSRGraph"]:
    """Load graph, run walks, save corpus (reference Main.doRandomWalk:53-62)."""
    t0 = time.time()
    graph, home = _load_graph(params)
    # graph stats logging, the reference's V/E accumulators (UniformRandomWalk.scala:67-79)
    logger.info("vertices: %d", graph.num_vertices)
    logger.info("edges: %d", graph.num_edges)
    print(f"vertices: {graph.num_vertices}")
    print(f"edges: {graph.num_edges}")
    walks = n2v.run_walks(graph, params, home)
    dt = time.time() - t0
    walks_np = np.asarray(walks)  # one D2H view for stats + /path output; the
    #                               device buffer (if any) flows to the trainer
    from .utils.stats import walk_stats
    ws = walk_stats(walks_np)
    print(f"walks: {ws.num_paths} paths, {ws.num_steps} steps in {dt:.2f}s "
          f"({ws.num_steps / max(dt, 1e-9):,.0f} steps/s)")
    # the reference's per-run diagnostics (Zero Neighbors dead-end counter,
    # RandomWalk.scala:155-160); Wrong Transports cannot occur by construction
    print(f"Zero Neighbors: {ws.dead_ends}  (isolated starts: {ws.isolated_starts}, "
          f"full paths: {ws.full_paths}, mean length: {ws.mean_length:.1f})")
    logger.info("walk stats: %s", ws.as_dict())
    # corpus-size invariant, warned (not failed) like the reference's per-round
    # path-count check (RandomWalk.scala:164-167)
    expect = params.num_walks * graph.num_vertices
    if ws.num_paths != expect:
        logger.warning("corpus has %d paths, expected numWalks*|V| = %d",
                       ws.num_paths, expect)
    if params.validate:
        from .utils.stats import validate_walks
        validate_walks(walks_np, graph)
        print("walk invariants: ok")
    gio.save_walks(walks_np, graph, params.output, n2v.output_partitions(params))
    return walks, graph


def _global_walk_stats(local_rows: np.ndarray):
    """WalkStats summed across all processes (one tiny allgather): the
    reference's driver-side accumulators are cluster-global
    (RandomWalk.scala:155-167); per-process stats alone would under-report."""
    import jax
    from jax.experimental import multihost_utils

    from .utils.stats import WalkStats, walk_stats

    ws = walk_stats(local_rows) if len(local_rows) else WalkStats(
        0, 0, 0, 0, 0, 0.0)
    vec = np.asarray([ws.num_paths, ws.num_steps, ws.full_paths, ws.dead_ends,
                      ws.isolated_starts], dtype=np.int64)
    if jax.process_count() > 1:
        # gather as (hi, lo) uint32 halves: without x64 (the production
        # default) jax would silently truncate int64 payloads to int32, and
        # per-host step counts exceed 2^31 at production scale
        halves = np.stack([vec >> 32, vec & 0xFFFFFFFF]).astype(np.uint32)
        gathered = np.asarray(
            multihost_utils.process_allgather(halves)).astype(np.int64)
        vec = ((gathered[:, 0] << 32) | gathered[:, 1]).sum(axis=0)
    paths = int(vec[0])
    return WalkStats(
        num_paths=paths, num_steps=int(vec[1]), full_paths=int(vec[2]),
        dead_ends=int(vec[3]), isolated_starts=int(vec[4]),
        mean_length=(int(vec[1]) + paths) / paths if paths else 0.0)


def _run_job_multihost(params: Params) -> str:
    """Multi-host dispatch (jax.process_count() > 1): the product path of
    `SRW_COORDINATOR=... python -m stellar_rw_tpu` on every host — walks run
    on the global mesh with each process keeping and WRITING only its own
    corpus rows, and the trainer consumes the same blocks SPMD (the reference
    cluster execution, Main.scala:53-62,93,116). Process 0 writes the model /
    vectors and prints global stats.

    --streaming and walk-round checkpoints are single-host features (the
    trainer's epoch checkpoints DO work here, written by process 0 and
    broadcast on resume)."""
    import jax

    me = jax.process_index()
    if params.streaming:
        raise ValueError(
            "--streaming is not supported in multi-host runs; drop the flag "
            "(the multi-host corpus is already distributed per process)")
    if params.checkpoint_every:
        logger.warning("multi-host: walk-round checkpoints are single-host "
                       "only and are skipped; trainer epoch checkpoints "
                       "still apply (written by process 0)")
    from .utils.stats import validate_walks

    if params.cmd in (TaskName.node2vec, TaskName.randomwalk):
        t0 = time.time()
        graph, home = _load_graph(params)
        if me == 0:
            print(f"vertices: {graph.num_vertices}")
            print(f"edges: {graph.num_edges}")
        blocks, diag, num_rows, D = n2v.run_walks_multihost(graph, params, home)
        if me == 0:
            from .parallel.distributed import log_superstep_diag
            log_superstep_diag(diag)   # diag is psum'd -> global counters
        local = (np.concatenate([rows[rows[:, 0] >= 0] for _, rows in blocks])
                 if blocks else np.zeros((0, params.walk_length + 2), np.int32))
        ws = _global_walk_stats(local)
        dt = time.time() - t0
        if me == 0:
            print(f"walks: {ws.num_paths} paths, {ws.num_steps} steps in "
                  f"{dt:.2f}s ({ws.num_steps / max(dt, 1e-9):,.0f} steps/s, "
                  f"{jax.process_count()} processes x "
                  f"{len(jax.local_devices())} devices)")
            print(f"Zero Neighbors: {ws.dead_ends}  (isolated starts: "
                  f"{ws.isolated_starts}, full paths: {ws.full_paths}, "
                  f"mean length: {ws.mean_length:.1f})")
            expect = params.num_walks * graph.num_vertices
            if ws.num_paths != expect:
                logger.warning("corpus has %d paths, expected numWalks*|V| = "
                               "%d", ws.num_paths, expect)
        if params.validate:
            validate_walks(local, graph)   # every process checks its rows
            print(f"walk invariants: ok (process {me})")
        gio.save_walk_blocks(blocks, graph, params.output)
        if params.cmd == TaskName.node2vec:
            tokens, w_in, w_out = n2v.embed_walk_blocks(
                blocks, num_rows, graph, params, num_devices=D,
                row_width=params.walk_length + 2)
            if me == 0:
                n2v.save_model(params.output, tokens, w_in, w_out, params)
                gio.save_vectors(np.asarray(tokens), w_in, params.output,
                                 n2v.output_partitions(params))
    elif params.cmd == TaskName.embedding:
        # every host reads the same walks file; the trainer scatters it.
        # Trainer epoch checkpoints apply here too (written by process 0,
        # broadcast on --resume) — same wiring as the node2vec path.
        from .models import word2vec as w2v
        values, offsets = gio.load_walks_ragged(params.input)
        corpus, vocab = w2v.corpus_from_ragged(values, offsets)
        blocks, num_rows = w2v.full_corpus_blocks(corpus)
        tokens = vocab
        w_in, w_out = n2v.train_multiproc_with_ckpt(
            blocks, num_rows, len(vocab), params,
            row_width=corpus.shape[1] if corpus.size else 1)
        if me == 0:
            n2v.save_model(params.output, tokens, w_in, w_out, params)
            gio.save_vectors(np.asarray(tokens), w_in, params.output,
                             n2v.output_partitions(params))
    return params.output


def run_job(params: Params) -> str:
    import jax

    if jax.process_count() > 1:
        return _run_job_multihost(params)
    if params.cmd == TaskName.node2vec and params.streaming:
        # memory-bounded pipeline: one walk round resident at a time
        graph, home = _load_graph(params)
        print(f"vertices: {graph.num_vertices}")
        print(f"edges: {graph.num_edges}")
        tokens, w_in, w_out, ws = n2v.run_node2vec_streaming(graph, params, home)
        print(f"walks (streamed): {ws.num_paths} paths, {ws.num_steps} steps")
        print(f"Zero Neighbors: {ws.dead_ends}  (isolated starts: "
              f"{ws.isolated_starts}, full paths: {ws.full_paths}, "
              f"mean length: {ws.mean_length:.1f})")
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    elif params.cmd == TaskName.node2vec:
        walks, graph = do_random_walk(params)
        t0 = time.time()
        tokens, w_in, w_out = n2v.embed_walks(walks, graph, params)
        print(f"embeddings: {len(tokens)} x {w_in.shape[1]} trained in "
              f"{time.time() - t0:.2f}s ({params.w2v_iter} epochs)")
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    elif params.cmd == TaskName.randomwalk:
        do_random_walk(params)
    elif params.cmd == TaskName.embedding:
        # vectorized walks-file ingest (ragged arrays): the per-token Python
        # reader costs hours at the reference-default corpus (Main.scala:119-121)
        values, offsets = gio.load_walks_ragged(params.input)
        tokens, w_in, w_out = n2v.embed_ragged_corpus(values, offsets, params)
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    return params.output


def main(argv: list[str] | None = None) -> int:
    params = parse(sys.argv[1:] if argv is None else argv)
    if params is None:
        return 1
    # console + optional rolling-file logging (the reference's log4j appenders,
    # src/main/resources/log4j.properties; SURVEY.md §5.5)
    from .utils.logging import configure
    configure(params.log_dir)
    from .utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    # multi-host: join the jax.distributed process group when SRW_COORDINATOR /
    # SRW_NUM_PROCESSES are set (one process per host; see parallel/multihost.py)
    from .parallel.multihost import maybe_initialize_from_env
    maybe_initialize_from_env()
    print(params)
    if params.profile_dir:
        import jax
        with jax.profiler.trace(params.profile_dir):
            run_job(params)
    else:
        run_job(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
