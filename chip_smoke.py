"""Smoke run of the node2vec system on NVIDIA GPUs: the main path at a real
size, and every device result against its plain reference.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # only the four-card phase

One card:
  * `--cmd node2vec` through the CLI on a BlogCatalog-shaped synthetic graph
    (10,312 V / 333,983 undirected edges, power-law degrees, made from --seed
    and written to an edge file, so the native builder and the text loader
    are on the path) under the reference protocol with one epoch;
  * `--cmd randomwalk` on a 1M V / 16M arc graph, whose tables live in HBM;
  * the walk corpus on the card against the same engine on the host CPU
    (bitwise), and against itself (run to run);
  * transition frequencies at a high-degree state against the exact node2vec
    probabilities of walk/oracle.py, at p=q=0.25 and at p=100, q=1;
  * one SGNS epoch over one walk per vertex on the card against the host
    CPU (exact and shared negatives), and against itself; link-prediction
    AUC of both;
  * SpMM / SDDMM against NumPy float64.
Four cards: the sharded walk engine (hash, hash with 2 lanes, VCut; one walk
per vertex) against the one-card corpus, and the trainer mesh
(--w2vPartitions 4, --w2vModelShards 4) against the same mesh program on 4
CPU devices. The three sharded walk programs are compiled at once, each in its
own thread, while the cards run the rest.

Each phase prints its result on its own line. The last line of standard output,
printed only when every phase passed, is
    {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}
Without a GPU the script exits non-zero at once.

Float32 matrix products on the GPU may run in TF32 (the program does not set
a precision), and scatter-adds with duplicate indices sum in no fixed order.
The tolerances below follow from that.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

BLOG_V, BLOG_E = 10_312, 333_983          # BlogCatalog, node2vec paper
HBM_V, HBM_E = 1_000_000, 8_000_000       # 16M arcs: tables ~2.5 GB >> L2
TRANSITION_WALKERS = 1_000_000
# One SGNS epoch, card vs CPU, as a share of the largest update the epoch
# made: sound H100 runs read 1.9e-6 (exact) and 1.8e-5 (shared-128 conv);
# 2e-4 is 10x the larger. The trained table rounded to bf16 reads 1.2e-2 and
# 5.8e-2 (tests/test_chip_smoke.py holds a bf16 result to failing it).
SGNS_TOL = 2e-4
AUC_TOL = 0.01
# SpMM/SDDMM sum float32 terms in another order than NumPy; the error bound
# of such a sum is n * 2^-24 of the sum of |terms|. 1e-4 covers rows of up to
# ~1700 terms at that bound (and realistic sqrt(n) growth far beyond), while
# one missing or doubled term of a row moves it by ~1/n of that sum.
SPMM_TOL = 1e-4


def protocol(num_walks: int = 10) -> list[str]:
    """The reference protocol (node2vec paper) with one epoch."""
    return ["--walkLength", "80", "--numWalks", str(num_walks), "--p", "0.25",
            "--q", "0.25", "--dim", "128", "--window", "10", "--iter", "1"]


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


@contextlib.contextmanager
def on_host_cpu():
    """Run on the host CPU, compiling without the persistent cache: its
    entries would hold code for this host's CPU model, and the cache may be
    read on another machine."""
    import jax

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def last_line(devices) -> str:
    """The contract's last line for a list of JAX devices."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def power_law_edges(V: int, E: int, seed: int):
    """E distinct undirected edges over V vertices, no self loops, every
    vertex touched. Each vertex first gets one edge to a partner drawn from
    the power law; edges between two power-law endpoints fill the rest. The
    law is bench.synth_power_law_graph's: p(rank r) ~ r^-0.7.
    Returns (src, dst) int64 arrays."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return np.minimum((V * rng.random(n) ** (1 / 0.3)).astype(np.int64),
                          V - 1)

    a = np.arange(V, dtype=np.int64)
    b = draw(V)
    b = np.where(b == a, (a + 1) % V, b)
    keys = np.zeros(0, np.int64)
    while True:
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        keys = np.concatenate([keys, (lo * V + hi)[lo != hi]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]            # distinct, in draw order
        if len(keys) >= E:
            keys = keys[:E]
            return keys // V, keys % V
        n = int((E - len(keys)) * 1.5) + 1024
        a, b = draw(n), draw(n)


def write_edge_file(path: str, *columns: np.ndarray) -> None:
    """Whitespace-separated integer columns, one edge per line, written as
    fixed-width text without a per-line Python loop."""
    n = len(columns[0])
    parts = []
    for c in columns:
        width = len(str(int(c.max()))) if n else 1
        p10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
        txt = ((c[:, None] // p10) % 10 + 48).astype(np.uint8)
        txt[(c[:, None] < p10) & (p10 > 1)] = 32     # leading zeros -> spaces
        parts += [txt, np.full((n, 1), 32, np.uint8)]
    parts[-1] = np.full((n, 1), 10, np.uint8)
    np.concatenate(parts, axis=1).tofile(path)


def run_cli(argv: list[str]) -> str:
    """`python -m stellar_rw_tpu <argv>` in this process; returns its stdout."""
    from stellar_rw_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if re.match(r"(vertices|edges|walks|walk invariants|embeddings):",
                    line):
            print("  cli| " + line, flush=True)
    check(rc == 0, f"cli exited {rc}")
    return out


def count_lines(directory: str) -> int:
    n = 0
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            while chunk := f.read(1 << 24):
                n += chunk.count(b"\n")
    return n


def cli_walk_rate(out: str) -> float:
    m = re.search(r"walks: \d+ paths, (\d+) steps in ([\d.]+)s", out)
    check(m is not None, "no walk line in the CLI output")
    return int(m.group(1)) / float(m.group(2))


def graph_edges(g) -> np.ndarray:
    """Undirected edges (u < v) of a CSR graph."""
    src = np.repeat(np.arange(g.num_vertices), g.degrees)
    keep = src < g.cols
    return np.stack([src[keep], g.cols[keep]], 1)


def compare_embeddings(got: np.ndarray, want: np.ndarray,
                       init: np.ndarray) -> dict:
    """Difference of two trained tables, relative to the tables and to what
    training changed (want - init): the tables start equal, so the update
    is where precision shows."""
    d = np.abs(got.astype(np.float64) - want)
    upd = want - init
    return {"max_abs": float(d.max()),
            "max_rel": float(d.max() / np.abs(want).max()),
            "max_rel_update": float(d.max() / np.abs(upd).max()),
            "fro_rel_update": float(np.linalg.norm(d) / np.linalg.norm(upd))}


# --- one-card phases -------------------------------------------------------

def phase_node2vec_job(work: str, seed: int, card: str) -> dict:
    src, dst = power_law_edges(BLOG_V, BLOG_E, seed)
    path = os.path.join(work, "blogcatalog_shape.txt")
    write_edge_file(path, src, dst)
    out_dir = os.path.join(work, "n2v")
    t0 = time.time()
    out = run_cli(["--cmd", "node2vec", "--input", path, "--output", out_dir,
                   "--weighted", "false", "--validate", "true",
                   "--seed", str(seed)] + protocol())
    wall = time.time() - t0
    check(f"vertices: {BLOG_V}\n" in out, "vertex count")
    check(f"edges: {2 * BLOG_E}\n" in out, "arc count")
    check("walk invariants: ok" in out, "--validate did not pass")
    rows = count_lines(os.path.join(out_dir, "path"))
    check(rows == 10 * BLOG_V, f"/path has {rows} rows, want {10 * BLOG_V}")
    vec = np.loadtxt(os.path.join(out_dir, "vec", "part-00000"),
                     delimiter="\t", ndmin=2)
    check(vec.shape == (BLOG_V, 129), f"/vec shape {vec.shape}")
    check(np.isfinite(vec).all(), "/vec has non-finite values")
    check(len(np.unique(vec[:, 0])) == BLOG_V, "/vec ids not distinct")
    from stellar_rw_tpu.models import eval as ev
    by_id = vec[np.argsort(vec[:, 0]), 1:]        # ids are 0..V-1 here
    probe = np.random.default_rng(0).choice(BLOG_E, min(20_000, BLOG_E),
                                            replace=False)
    auc = ev.link_prediction_auc(
        by_id, np.stack([src[probe], dst[probe]], 1), BLOG_V, seed=0)
    m = re.search(r"embeddings: .* trained in ([\d.]+)s", out)
    check(m is not None, "no trainer line in the CLI output")
    walk_rate = cli_walk_rate(out)
    print(f"  node2vec job: walk {walk_rate:.1f} steps/s (CLI: edge file to "
          f"corpus, load and compile included) | {card}")
    print(f"  node2vec job: trainer wall {float(m.group(1))} s (1 epoch, "
          f"exact SGNS, compile included) | {card}")
    return {"path": path, "job_wall_s": round(wall, 2),
            "walk_steps_per_s_cli": walk_rate,
            "train_wall_s": float(m.group(1)), "path_rows": rows,
            "vec_shape": list(vec.shape), "vec_link_pred_auc": round(auc, 5)}


def phase_randomwalk_hbm(work: str, seed: int, card: str) -> dict:
    import jax

    from stellar_rw_tpu.graph import io as gio
    from stellar_rw_tpu.walk import engine

    src, dst = power_law_edges(HBM_V, HBM_E, seed + 1)
    path = os.path.join(work, "hbm_1m.txt")
    write_edge_file(path, src, dst)
    del src, dst
    out_dir = os.path.join(work, "rw1m")
    walk = ["--walkLength", "80", "--numWalks", "1", "--p", "0.25",
            "--q", "0.25"]
    out = run_cli(["--cmd", "randomwalk", "--input", path, "--output",
                   out_dir, "--weighted", "false", "--validate", "true",
                   "--seed", str(seed)] + walk)
    check("walk invariants: ok" in out, "--validate did not pass")
    check(f"edges: {2 * HBM_E}\n" in out, "arc count")
    rows = count_lines(os.path.join(out_dir, "path"))
    shutil.rmtree(out_dir)
    check(rows == HBM_V, f"/path has {rows} rows, want {HBM_V}")
    # steady state: the CLI's program again, compiled, on a fresh load
    g = gio.load_edge_list(path, weighted=False)
    os.remove(path)
    from stellar_rw_tpu.ops import sampling
    dg = sampling.device_put_graph(g)
    table_bytes = sum(x.nbytes for x in dg if x is not None)
    kw = dict(walk_length=80, num_walks=1, p=0.25, q=0.25, seed=seed,
              device_graph=dg, as_numpy=False)
    first = jax.block_until_ready(engine.random_walks(g, **kw))
    t0 = time.time()
    w = jax.block_until_ready(engine.random_walks(g, **kw))
    dt = time.time() - t0
    check(bool(jax.numpy.array_equal(first, w)),
          "1M corpus differs run to run on the card")
    steps = int(np.asarray((w >= 0).sum())) - HBM_V
    rate = steps / dt
    print(f"  randomwalk 1M V / {2 * HBM_E} arcs: CLI {cli_walk_rate(out):.1f}"
          f" steps/s (load and compile included), steady {rate:.1f} steps/s,"
          f" device tables {table_bytes} bytes | {card}")
    return {"path_rows": rows, "max_degree": int(g.max_degree),
            "table_bytes": table_bytes, "steady_steps_per_s": rate,
            "steady_s": round(dt, 4), "bitwise_run_to_run": True}


def phase_walks_card_vs_cpu(g, seed: int, card: str) -> dict:
    import jax

    from stellar_rw_tpu.walk import engine

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    kw = dict(walk_length=80, num_walks=1, p=0.25, q=0.25, seed=seed,
              sampler="rejection", as_numpy=False)
    w_card = engine.random_walks(g, **kw)
    check(w_card.devices() == {gpu}, f"card corpus on {w_card.devices()}")
    with on_host_cpu():
        w_cpu = engine.random_walks(g, **kw)
    check(w_cpu.devices() == {cpu}, f"CPU corpus on {w_cpu.devices()}")
    a, b = np.asarray(w_card), np.asarray(w_cpu)
    differ = int((a != b).any(axis=1).sum())
    check(differ == 0, f"{differ} of {len(a)} walks differ card vs CPU")
    # run to run, and the steady rate, on the reference protocol's corpus
    # (the node2vec job compiled this program; tables uploaded once)
    from stellar_rw_tpu.ops import sampling
    kw10 = dict(kw, num_walks=10, device_graph=sampling.device_put_graph(g))
    first = jax.block_until_ready(engine.random_walks(g, **kw10))
    t0 = time.time()
    second = jax.block_until_ready(engine.random_walks(g, **kw10))
    dt = time.time() - t0
    check(bool(np.array_equal(np.asarray(first), np.asarray(second))),
          "walk corpus differs run to run on the card")
    steps = int(np.asarray((second >= 0).sum())) - second.shape[0]
    print(f"  walks 10K V, R=10, L=80: steady {steps / dt:.1f} steps/s | "
          f"{card}")
    return {"corpus": a.shape, "bitwise_card_vs_cpu": True,
            "bitwise_run_to_run": True,
            "steady_steps_per_s_r10": steps / dt}


def transition_check(g, p: float, q: float, walkers: int, seed: int) -> dict:
    """Realized next-step frequencies at (prev, hub) against the exact node2vec
    probabilities: hub is the highest-degree vertex, prev its lowest-degree
    neighbor; walkers start at prev, and those whose first step reaches hub
    give one sample each."""
    from stellar_rw_tpu.walk import engine, oracle

    deg = g.degrees
    hub = int(np.argmax(deg))
    nbrs = np.unique(g.neighbors(hub)[0])
    prev = int(nbrs[np.argmin(deg[nbrs])])
    starts = np.full(walkers, prev, np.int32)
    w = engine.random_walks(g, walk_length=1, num_walks=1, p=p, q=q,
                            seed=seed, starts=starts)
    nxt = w[w[:, 1] == hub, 2]
    n = len(nxt)
    check(n > 0, "no walker reached the hub")
    exact = oracle.exact_transition_probs(g, prev, hub, p, q)
    keys = np.asarray(sorted(exact), dtype=np.int64)
    pr = np.asarray([exact[k] for k in keys])
    counts = np.bincount(nxt, minlength=g.num_vertices)
    check(counts.sum() == counts[keys].sum(),
          "a transition left the hub's neighbor set")
    z = (counts[keys] / n - pr) / np.sqrt(pr * (1 - pr) / n)
    prev_nbrs = set(int(c) for c in g.neighbors(prev)[0])
    cls = np.asarray([0 if k == prev else 1 if k in prev_nbrs else 2
                      for k in keys])
    class_z = []
    for c in range(3):
        pc = pr[cls == c].sum()
        if 0 < pc < 1:
            fc = counts[keys[cls == c]].sum() / n
            class_z.append(float((fc - pc) / np.sqrt(pc * (1 - pc) / n)))
    max_z = float(np.abs(z).max())
    check(max_z < 5, f"neighbor frequency off by {max_z:.2f} sigma")
    check(max(abs(x) for x in class_z) < 5,
          f"bias-class frequency off: {class_z}")
    return {"hub": hub, "hub_degree": int(deg[hub]), "prev": prev,
            "prev_degree": int(deg[prev]), "samples": n,
            "max_abs_z": round(max_z, 3),
            "class_z(return,common,outward)": [round(x, 3) for x in class_z]}


def sgns_train(corpus, V: int, device, shared: int, seed: int):
    """One epoch of the trainer on `device`; returns (w_in, its initial
    value)."""
    import jax

    from stellar_rw_tpu.models import word2vec as w2v

    cfg = w2v.SGNSConfig(dim=128, window=10, negatives=5, lr=0.025, iters=1,
                         seed=seed, shared_negatives=shared)
    host = device.platform == "cpu"
    with on_host_cpu() if host else jax.default_device(device):
        w_in, _ = w2v.train_skipgram(jax.device_put(corpus, device), V, cfg)
        w0, _ = w2v._init_embeddings(
            V, cfg.dim, jax.random.fold_in(jax.random.PRNGKey(seed), 0x1A17))
    return w_in, np.asarray(w0)


def phase_sgns_card_vs_cpu(g, corpus: np.ndarray, seed: int) -> dict:
    import jax

    from stellar_rw_tpu.models import eval as ev

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    edges = graph_edges(g)
    edges = edges[np.random.default_rng(0).choice(
        len(edges), min(20_000, len(edges)), replace=False)]
    V = g.num_vertices
    out = {}
    for label, shared in (("exact", 0), ("shared128_conv", 128)):
        a, w0 = sgns_train(corpus, V, gpu, shared, seed)
        b, _ = sgns_train(corpus, V, gpu, shared, seed)
        ref, w0_cpu = sgns_train(corpus, V, cpu, shared, seed)
        check(np.array_equal(w0, w0_cpu), f"{label}: initial tables differ")
        check(np.isfinite(a).all(), f"{label}: non-finite w_in")
        r = compare_embeddings(a, ref.astype(np.float64), w0)
        r["run_to_run_max_abs"] = float(np.abs(a - b).max())
        auc_card = ev.link_prediction_auc(a, edges, V, seed=0)
        auc_cpu = ev.link_prediction_auc(ref, edges, V, seed=0)
        r["auc_card"], r["auc_cpu"] = round(auc_card, 5), round(auc_cpu, 5)
        check(r["max_rel_update"] <= SGNS_TOL,
              f"{label}: card vs CPU {r} beyond {SGNS_TOL}")
        check(abs(auc_card - auc_cpu) <= AUC_TOL,
              f"{label}: AUC {auc_card} vs {auc_cpu}")
        out[label] = r
    return out


def phase_spmm(g, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from stellar_rw_tpu.ops import spmm as sp

    rng = np.random.default_rng(seed)
    D = 128
    x = rng.standard_normal((g.num_vertices, D)).astype(np.float32)
    y = rng.standard_normal((g.num_vertices, D)).astype(np.float32)
    es = sp.EdgeStructure.from_csr(g)
    got_y = np.asarray(jax.jit(lambda x: sp.spmm(es, x))(jnp.asarray(x)))
    got_s = np.asarray(jax.jit(lambda x, y: sp.sddmm(es, x, y))(
        jnp.asarray(x), jnp.asarray(y)))
    row, col = np.asarray(es.row), np.asarray(es.col)
    w = np.asarray(es.weight, np.float64)[:, None]
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    starts = g.offsets[:-1]
    check((g.degrees > 0).all(), "isolated vertex in the SpMM graph")
    want_y = np.add.reduceat(x64[col] * w, starts, axis=0)
    mag_y = np.add.reduceat(np.abs(x64[col] * w), starts, axis=0)
    want_s = np.einsum("ed,ed->e", x64[row], y64[col])
    mag_s = np.einsum("ed,ed->e", np.abs(x64[row]), np.abs(y64[col]))
    err_y = float((np.abs(got_y - want_y) / mag_y).max())
    err_s = float((np.abs(got_s - want_s) / mag_s).max())
    check(err_y <= SPMM_TOL, f"SpMM error {err_y} of sum|terms|")
    check(err_s <= SPMM_TOL, f"SDDMM error {err_s} of sum|terms|")
    return {"D": D, "arcs": int(g.num_edges),
            "spmm_max_err_over_abs_sum": err_y,
            "sddmm_max_err_over_abs_sum": err_s}


def phase_precision() -> dict:
    """What a float32 matrix product and an einsum of the trainer's shape
    give on the card, against float64: a relative error near 1e-3 means TF32,
    near 1e-7 float32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = rng.standard_normal((512, 128)).astype(np.float32)
    b = rng.standard_normal((128, 512)).astype(np.float32)
    c = rng.standard_normal((512, 6, 128)).astype(np.float32)
    a64, b64, c64 = (t.astype(np.float64) for t in (a, b, c))

    def rel(got, want, mag):
        return float((np.abs(np.asarray(got, np.float64) - want) / mag).max())

    return {
        "dot_[512,128]x[128,512]": rel(
            jax.jit(jnp.dot)(a, b), a64 @ b64, np.abs(a64) @ np.abs(b64)),
        "einsum_pd,pkd->pk": rel(
            jax.jit(lambda u, v: jnp.einsum("pd,pkd->pk", u, v))(a, c),
            np.einsum("pd,pkd->pk", a64, c64),
            np.einsum("pd,pkd->pk", np.abs(a64), np.abs(c64))),
    }


def one_card(work: str, seed: int, card: str, run) -> None:
    from stellar_rw_tpu.graph import io as gio

    job = run("node2vec_job", phase_node2vec_job, work, seed, card)
    run("randomwalk_1m_hbm", phase_randomwalk_hbm, work, seed, card)
    if job is None:
        return
    g = gio.load_edge_list(job["path"], weighted=False)
    run("precision", phase_precision)
    walks = run("walks_card_vs_cpu", phase_walks_card_vs_cpu, g, seed, card)
    run("transition_p0.25_q0.25", transition_check, g, 0.25, 0.25,
        TRANSITION_WALKERS, seed)
    run("transition_p100_q1_exact_cdf", transition_check, g, 100.0, 1.0,
        TRANSITION_WALKERS, seed)
    if walks is not None:
        from stellar_rw_tpu.walk import engine
        corpus = engine.random_walks(g, walk_length=80, num_walks=1, p=0.25,
                                     q=0.25, seed=seed)
        run("sgns_card_vs_cpu", phase_sgns_card_vs_cpu, g, corpus, seed)
    run("spmm_sddmm_vs_numpy", phase_spmm, g, seed)


# --- four cards ------------------------------------------------------------

_CPU_MESH_TRAINER = r"""
import sys, numpy as np, jax
jax.config.update("jax_num_cpu_devices", 4)
sys.path.insert(0, sys.argv[1])
from stellar_rw_tpu.models import node2vec as n2v, word2vec as w2v
from stellar_rw_tpu.utils.config import parse
corpus, V = np.load(sys.argv[2]), int(sys.argv[3])
out = {}
for i, argv in enumerate(sys.argv[5:]):
    params = parse(argv.split())
    w, _ = w2v.train_skipgram(corpus, V, n2v.sgns_config(params),
                              num_partitions=params.w2v_partitions)
    out[str(i)] = w
np.savez(sys.argv[4], **out)
"""


class _Compiled(Exception):
    """Ends a walk call once its sharded program is compiled."""


@contextlib.contextmanager
def compile_in_threads(jobs: dict):
    """Compile the sharded walk program of each job (name -> a walk call with
    no arguments) in its own thread, all at once: XLA compiles them in
    parallel, and the same calls made later find their programs in JAX's
    in-memory compilation cache. No thread runs a program on the cards; the
    caller's thread may, inside the block. Yields a dict that, once the block
    ends, maps each name to (ids of the devices its sharded graph was placed
    on, compile seconds) or to the exception the call raised."""
    from stellar_rw_tpu.parallel import distributed as dist

    real = dist.distributed_walk_corpus
    local = threading.local()
    result: dict = {}

    def compile_only(*a):
        if not getattr(local, "on", False):
            return real(*a)
        real.lower(*a).compile()
        local.devices = sorted({d.id for x in jax_leaves(a[0])
                                for d in x.sharding.device_set})
        raise _Compiled

    def work(name, call):
        local.on = True
        t0 = time.time()
        try:
            call()
            result[name] = CheckFailed("the walk ran no sharded program")
        except _Compiled:
            result[name] = (local.devices, time.time() - t0)
        except Exception as e:
            result[name] = e

    threads = [threading.Thread(target=work, args=j) for j in jobs.items()]
    dist.distributed_walk_corpus = compile_only
    try:
        for t in threads:
            t.start()
        yield result
    finally:
        for t in threads:
            t.join()
        dist.distributed_walk_corpus = real


def jax_leaves(tree) -> list:
    import jax

    return [x for x in jax.tree.leaves(tree) if hasattr(x, "sharding")]


def four_cards(work: str, seed: int, card: str, run) -> None:
    import jax

    from stellar_rw_tpu.graph import io as gio
    from stellar_rw_tpu.models import node2vec as n2v
    from stellar_rw_tpu.models import word2vec as w2v
    from stellar_rw_tpu.utils.config import parse

    devs = jax.devices()
    check(len(devs) == 4 and all(d.platform == "gpu" for d in devs),
          f"--four-cards needs 4 GPUs, found {devs}")
    src, dst = power_law_edges(BLOG_V, BLOG_E, seed)
    path = os.path.join(work, "blogcatalog_shape.txt")
    part_path = os.path.join(work, "blogcatalog_shape_part.txt")
    write_edge_file(path, src, dst)
    write_edge_file(part_path, src, dst,
                    np.random.default_rng(seed + 2).integers(0, 4, len(src)))
    base = ["--cmd", "randomwalk", "--output", os.path.join(work, "unused"),
            "--weighted", "false", "--seed", str(seed)] + protocol(1)

    def peaks():
        return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for d in devs]

    def walks(g, argv, home=None):
        return np.asarray(n2v.run_walks(g, parse(base + argv), home))

    g = gio.load_edge_list(path, weighted=False)
    gp, home = gio.load_edge_list_partitioned(
        part_path, weighted=False, partitioned=True, num_partitions=4,
        seed=seed)
    vcut = ["--input", part_path, "--partitioned", "true",
            "--rddPartitions", "4"]
    cases = {"hash": (g, ["--input", path, "--shards", "4"], None),
             "2_lanes": (g, ["--input", path, "--shards", "4", "--lanes", "2"],
                         None),
             "vcut": (gp, vcut, home)}
    trainer_argv = ["--w2vPartitions 4", "--w2vModelShards 4"]
    full = [f"--cmd node2vec --input x --output y --iter 1 --seed {seed} {a}"
            for a in trainer_argv]
    ref_path = os.path.join(work, "cpu_mesh.npz")
    cpu_mesh = None
    got = []
    t0 = time.time()
    try:
        with compile_in_threads(
                {k: (lambda c=c: walks(c[0], c[1], c[2]))
                 for k, c in cases.items()}) as compiled:
            single = walks(g, ["--input", path, "--shards", "1"])
            single_p = walks(gp, vcut + ["--shards", "1"], home)
            print(f"  one-card corpora {single.shape}, {single_p.shape}; peak "
                  f"bytes per card {peaks()}", flush=True)
            # the trainer's reference: the same mesh programs on 4 CPU
            # devices, in a CPU-only subprocess (it opens no card)
            corpus_path = os.path.join(work, "corpus.npy")
            np.save(corpus_path, single)
            cpu_mesh = subprocess.Popen(
                [sys.executable, "-c", _CPU_MESH_TRAINER, HERE, corpus_path,
                 str(g.num_vertices), ref_path] + full,
                env=dict(os.environ, JAX_PLATFORMS="cpu",
                         JAX_ENABLE_COMPILATION_CACHE="false"))
            for argv in full:
                params = parse(argv.split())
                t1 = time.time()
                try:
                    w, _ = w2v.train_skipgram(
                        single, g.num_vertices, n2v.sgns_config(params),
                        num_partitions=params.w2v_partitions)
                    got.append((np.asarray(w), time.time() - t1, peaks()))
                except Exception as e:       # re-raised by its phase below
                    traceback.print_exc()
                    got.append(e)
        print(f"  sharded walk programs compiled, three threads at once, and "
              f"one-card corpora and trainers run: {time.time() - t0:.1f}s",
              flush=True)

        def sharded(name):
            info = compiled[name]
            if isinstance(info, Exception):
                raise info
            placed, compile_s = info
            check(placed == sorted(d.id for d in devs),
                  f"sharded graph placed on devices {placed}")
            graph, argv, hm = cases[name]
            t1 = time.time()
            w = walks(graph, argv, hm)
            dt = time.time() - t1
            ref = single_p if name == "vcut" else single
            differ = int((w != ref).any(axis=1).sum())
            check(differ == 0, f"{differ} of {len(w)} walks differ from the "
                  f"one-card corpus")
            return {"bitwise_equal_to_one_card": True, "walks": len(w),
                    "graph_on_devices": placed,
                    "compile_s_in_thread": round(compile_s, 1),
                    "walk_call_s": round(dt, 2), "peak_bytes": peaks()}

        for name in cases:
            run(f"walks_4_shards_{name}", sharded, name)
    finally:
        rc = None
        if cpu_mesh is not None:
            try:
                rc = cpu_mesh.wait(timeout=900)
            except subprocess.TimeoutExpired:
                cpu_mesh.kill()
                cpu_mesh.wait()

    w0 = np.asarray(w2v._init_embeddings(
        g.num_vertices, 128,
        jax.random.fold_in(jax.random.PRNGKey(seed), 0x1A17))[0])
    for i, (name, res) in enumerate(zip(trainer_argv, got)):
        def trainer(res=res, i=i):
            if isinstance(res, Exception):
                raise res
            w, dt, pk = res
            check(rc == 0, f"CPU mesh reference exited {rc}")
            check(np.isfinite(w).all(), "non-finite w_in")
            ref = np.load(ref_path)[str(i)].astype(np.float64)
            r = compare_embeddings(w, ref, w0)
            check(r["max_rel_update"] <= SGNS_TOL,
                  f"4 cards vs 4 CPU devices {r} beyond {SGNS_TOL}")
            return dict(r, wall_s_compile_included=round(dt, 2),
                        peak_bytes=pk)
        run(f"trainer {name} vs 4 CPU devices", trainer)


# --- main ------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase and its references")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX finds no GPU (default backend {backend!r})",
              file=sys.stderr)
        return 2
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import stellar_rw_tpu

    pkg_root = os.path.dirname(os.path.dirname(stellar_rw_tpu.__file__))
    if os.path.realpath(pkg_root) != os.path.realpath(HERE):
        print(f"chip_smoke: stellar_rw_tpu comes from {pkg_root}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    from stellar_rw_tpu import native
    from stellar_rw_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    card = card_line()
    print(f"card: {card}")
    print(f"jax {jax.__version__}, devices {jax.devices()}, compile cache "
          f"{cache}", flush=True)
    if not native.available():
        print("chip_smoke: the native graph builder did not build",
              file=sys.stderr)
        return 1

    failed: list[str] = []

    def run(name, fn, *a):
        t0 = time.time()
        try:
            r = fn(*a)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.time() - t0:.1f}s", flush=True)
            return None
        print(f"[{name}] ok in {time.time() - t0:.1f}s: {r}", flush=True)
        return r

    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    t0 = time.time()
    try:
        if args.four_cards:
            four_cards(work, args.seed, card, run)
        else:
            one_card(work, args.seed, card, run)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"total {time.time() - t0:.1f}s; card: {card}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(last_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    # the card-vs-CPU phases need the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.exit(main())
