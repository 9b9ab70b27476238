"""Multi-host execution: process bootstrap + global-mesh walks with per-host output.

The reference scales across machines with a Spark driver + executors
(SURVEY.md §2.3-6); the counterpart here is `jax.distributed`: ONE PROCESS PER
HOST, each attached to its local cards, all members of one global
`jax.sharding.Mesh`. Collectives ride NVLink within a host and the network
across hosts — the walk engine (parallel/distributed.py) is written purely against the
mesh axis, so the superstep path is untouched; this module only adds

  * process-group initialization (explicit args or SRW_* env vars),
  * global-array construction from process-local host data
    (`jax.make_array_from_callback` — every host holds the partitioned graph,
    the mesh assembles the sharded global views), and
  * process-local output: each host keeps exactly its shard of the corpus and
    writes its own part files, like Spark executors writing their partitions
    (reference RandomWalk.scala:234-241 repartition/save).

Launch (per host):
  SRW_COORDINATOR=host0:9731 SRW_NUM_PROCESSES=4 SRW_PROCESS_ID=<i> \
      python -m stellar_rw_tpu --cmd randomwalk --shards 16 ...
Nothing tells JAX of a cluster by default: the three variables are required.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..graph.csr import CSRGraph
from ..ops import sampling
from ..walk.engine import WalkSpec
from . import distributed
from .distributed import AXIS

logger = logging.getLogger("stellar_rw_tpu.multihost")

ENV_COORD = "SRW_COORDINATOR"
ENV_NPROC = "SRW_NUM_PROCESSES"
ENV_PID = "SRW_PROCESS_ID"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join (or bootstrap) the jax.distributed process group. Returns True if a
    multi-process group was initialized; False for single-process runs."""
    import jax

    coordinator = coordinator or os.environ.get(ENV_COORD)
    num_processes = num_processes or int(os.environ.get(ENV_NPROC, 0)) or None
    process_id = (process_id if process_id is not None
                  else (int(os.environ[ENV_PID])
                        if ENV_PID in os.environ else None))
    if coordinator is None and num_processes is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    logger.info("multihost: process %d/%d, %d local / %d global devices",
                jax.process_index(), jax.process_count(),
                len(jax.local_devices()), len(jax.devices()))
    return True


def maybe_initialize_from_env() -> bool:
    """CLI hook: join a process group iff the SRW_* env vars are set."""
    if ENV_COORD in os.environ or ENV_NPROC in os.environ:
        return initialize()
    return False


def global_mesh(num_shards: int | None = None, lanes: int = 1):
    """(shards x lanes) mesh over the GLOBAL device list (all processes).

    lanes groups CONSECUTIVE global devices (jax.devices() is process-major),
    so lanes <= chips-per-host keeps each replicated graph shard inside one
    host — the per-executor GraphMap sharing of the reference, with the shard
    served over the host's links instead of the network."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = (num_shards or len(devs) // max(lanes, 1))
    return Mesh(np.array(devs[:n * lanes]).reshape(n, lanes),
                (AXIS, distributed.LANE))


def _put_global(x: np.ndarray, mesh, spec):
    """Build a global sharded array from host-replicated data: every process
    supplies only its addressable shards (multi-process-safe device_put)."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def multihost_random_walks(
    graph: CSRGraph,
    walk_length: int,
    num_walks: int,
    p: float = 1.0,
    q: float = 1.0,
    seed: int = 0,
    sampler: str = "rejection",
    dtype: str = "float32",
    num_shards: int | None = None,
    route: np.ndarray | None = None,
    capacity: int | None = None,
    rng_impl: str = "threefry",
    lanes: int = 1,
) -> tuple[list[tuple[int, np.ndarray]], np.ndarray]:
    """Sharded corpus across ALL processes' devices; every process receives only
    ITS OWN corpus rows.

    Every process must call this with identical arguments (SPMD). The walks are
    bitwise identical to the single-chip engine; global corpus row r*W + w is
    round r of walker w, and each returned (global_row_start, rows) block is a
    contiguous slice of the PADDED global corpus [num_walks * W_pad, L+2]
    (rows whose start slot was padding are all -1; W_pad = W rounded up to the
    shard count). Returns (local_blocks, diag)."""
    import jax
    from jax.sharding import PartitionSpec as P

    import jax as _jax

    D_req = num_shards or len(_jax.devices())
    lanes = max(1, min(lanes, D_req))
    assert D_req % lanes == 0, \
        f"device count {D_req} not divisible by lanes={lanes}"
    mesh = global_mesh(D_req // lanes, lanes)
    S = mesh.devices.shape[0]      # graph shards
    L = lanes
    D = S * L                      # walk devices
    # shard-at-a-time streamed build: THIS process builds and uploads only the
    # shards its own devices hold (the reference analog: each executor fills
    # only its GraphMap, GraphMap.scala:11) — per-host memory is the graph +
    # one shard, not all S stacked shards
    arrays, route_dev, plan = distributed.device_put_sharded_graph_streamed(
        graph, mesh, route)
    route_host = plan.route
    W = graph.num_vertices
    W_pad = -(-W // D) * D
    starts_pad = np.full(W_pad, -1, dtype=np.int32)
    starts_pad[:W] = np.arange(W, dtype=np.int32)
    n = num_walks * W_pad // D
    C = capacity if capacity is not None else distributed.auto_capacity(
        graph, route_host, S, n, L)
    C = max(1, min(C, n))
    sampler, max_rounds = sampling.plan_sampler(sampler, p, q)
    spec = WalkSpec(
        walk_length=walk_length, p=float(p), q=float(q), sampler=sampler,
        max_degree=max(graph.max_degree, 1),
        n_search_iters=sampling.search_iters(graph.max_degree),
        max_rounds=max_rounds,
        dtype=dtype,
        n_stream=W,
        rng_impl=rng_impl,
        cdf_chunk=(sampling.plan_cdf_chunk_corpus(
            num_walks, W, graph.max_degree)
            if sampler == "cdf" else 0),
    )
    starts_dev = _put_global(starts_pad, mesh,
                             P((AXIS, distributed.LANE)))
    key = sampling.make_key(seed, rng_impl)
    paths, diag = distributed.distributed_walk_corpus(
        arrays, route_dev, starts_dev, key, np.int32(0), spec, num_walks, S, C,
        mesh, L)
    ovf = int(np.asarray(diag.addressable_data(0))[:, 3].sum())
    if ovf > 0:
        # static-cascade capacity exceeded: re-dispatch on the dynamic
        # schedule (full trial budget; same decision on every process since
        # diag is psum'd/replicated — SPMD-safe)
        paths, diag = distributed.distributed_walk_corpus(
            arrays, route_dev, starts_dev, key, np.int32(0),
            spec._replace(schedule="dynamic"), num_walks, S, C, mesh, L)
    blocks = []
    rows_per_device = num_walks * W_pad // D
    for sh in paths.addressable_shards:
        start_row = sh.index[0].start or 0
        blocks.append((int(start_row), np.asarray(sh.data)))
        assert sh.data.shape[0] == rows_per_device
    # diag is replicated -> addressable everywhere
    diag_np = np.asarray(diag.addressable_data(0))
    return blocks, diag_np
