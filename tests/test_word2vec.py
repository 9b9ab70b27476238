"""Skip-gram trainer quality + mechanics.

The reference delegates to MLlib and never tests word2vec (SURVEY.md §4 "Not tested");
BASELINE.json makes embedding quality the spec, so these tests train on karate walks
and assert downstream quality (link-prediction AUC, faction classification)."""

import numpy as np
import pytest

from stellar_rw_tpu.graph import io
from stellar_rw_tpu.models import eval as ev
from stellar_rw_tpu.models import word2vec as w2v
from stellar_rw_tpu.walk import engine


def test_pair_generation_masks():
    import jax
    block = np.array([[0, 1, 2, -1, -1]], dtype=np.int32)
    c, x, v = w2v._pairs_for_block(jax.numpy.asarray(block), jax.random.PRNGKey(0), 2)
    c, x, v = np.asarray(c), np.asarray(x), np.asarray(v)
    # no valid pair may involve padding or out-of-bounds
    assert np.all(c[v] >= 0) and np.all(x[v] >= 0)
    # at offset distance 1 pairs (0,1),(1,0),(1,2),(2,1) must be present
    # (dynamic window >= 1 always)
    got = set(zip(c[v].tolist(), x[v].tolist()))
    assert {(0, 1), (1, 0), (1, 2), (2, 1)} <= got
    assert (0, -1) not in got


def test_negative_table_distribution():
    import jax
    from stellar_rw_tpu.ops.alias import build_alias
    counts = np.array([1.0, 10.0, 100.0])
    keep, alias = build_alias(counts ** 0.75)
    negs = w2v._draw_negatives(
        jax.random.PRNGKey(0), (50000,), jax.numpy.asarray(keep),
        jax.numpy.asarray(alias))
    freq = np.bincount(np.asarray(negs), minlength=3) / 50000
    expect = counts ** 0.75 / (counts ** 0.75).sum()
    np.testing.assert_allclose(freq, expect, atol=0.01)


@pytest.fixture(scope="module")
def karate_embeddings(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, p=1.0, q=1.0, seed=2)
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20, seed=1)
    w_in, w_out = w2v.train_skipgram(walks, g.num_vertices, cfg)
    return g, w_in


def test_loss_decreases(karate_path):
    import jax
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=10, num_walks=3, seed=0)
    cfg = w2v.SGNSConfig(dim=16, window=4, negatives=4, lr=0.05, iters=1, seed=0)

    def probe_loss(w_in, w_out):
        key = jax.random.PRNGKey(9)
        centers = jax.random.randint(key, (512,), 0, g.num_vertices)
        # contexts = actual neighbors (positive pairs should score high after training)
        ctx = []
        for c in np.asarray(centers):
            cols, _ = g.neighbors(int(c))
            ctx.append(int(cols[0]) if len(cols) else int(c))
        negs = jax.random.randint(jax.random.fold_in(key, 1), (512, 4), 0,
                                  g.num_vertices)
        return float(w2v.sgns_loss(
            jax.numpy.asarray(w_in), jax.numpy.asarray(w_out), centers,
            jax.numpy.asarray(np.asarray(ctx)), negs))

    key = jax.random.PRNGKey(0)
    w_in0, w_out0 = w2v._init_embeddings(g.num_vertices, 16, key)
    loss0 = probe_loss(np.asarray(w_in0), np.asarray(w_out0))
    cfg10 = w2v.SGNSConfig(dim=16, window=4, negatives=4, lr=0.05, iters=10, seed=0)
    w_in, w_out = w2v.train_skipgram(walks, g.num_vertices, cfg10)
    loss1 = probe_loss(w_in, w_out)
    assert loss1 < loss0, (loss0, loss1)


def test_karate_link_prediction(karate_embeddings):
    g, w_in = karate_embeddings
    edges = []
    for v in range(g.num_vertices):
        cols, _ = g.neighbors(v)
        for d in cols:
            if v < int(d):
                edges.append((v, int(d)))
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices, seed=0)
    assert auc > 0.75, auc


def test_karate_faction_classification(karate_embeddings):
    g, w_in = karate_embeddings
    labels = ev.karate_labels(g.ids)
    acc = ev.node_classification_accuracy(w_in, labels, train_frac=0.5, seed=0)
    assert acc >= 0.90, acc


def test_token_corpus_roundtrip():
    corpus, vocab = w2v.corpus_from_token_lists([["a", "b", "a"], ["b", "c"]])
    assert vocab[0] in ("a", "b")  # both have count 2, order by token as tiebreak
    assert corpus.shape == (2, 3)
    assert corpus[1, 2] == -1
    inv = {i: t for i, t in enumerate(vocab)}
    assert [inv[int(i)] for i in corpus[0]] == ["a", "b", "a"]


def test_shared_negatives_training(karate_path):
    """The matmul path (block-shared negatives, weighted k/kB) must reach the same
    downstream quality as exact per-pair negative sampling."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2)
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20, seed=1,
                         shared_negatives=32)
    w_in, w_out = w2v.train_skipgram(walks, g.num_vertices, cfg)
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices, seed=0)
    acc = ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids), seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


def test_dim_sharded_apply_matches_replicated():
    """One SGNS step with the tables dim-sharded over a 2-device mesh must equal
    the replicated step (column parallelism only changes WHERE partial dots are
    summed, not the math)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    rng = np.random.default_rng(0)
    V, D, P, k = 50, 16, 64, 3
    w_in = rng.normal(size=(V, D)).astype(np.float32) * 0.1
    w_out = rng.normal(size=(V, D)).astype(np.float32) * 0.1
    centers = rng.integers(0, V, P).astype(np.int32)
    contexts = rng.integers(0, V, P).astype(np.int32)
    valid = rng.random(P) < 0.9
    negs = rng.integers(0, V, (P, k)).astype(np.int32)
    lr = np.float32(0.1)

    ref_in, ref_out = w2v._sgns_apply(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(valid), jnp.asarray(negs), lr)

    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    sh = NamedSharding(mesh, PS(None, "mp"))
    fn = jax.shard_map(
        lambda wi, wo, c, x, v, n: w2v._sgns_apply(
            wi, wo, c, x, v, n, lr, dim_axis="mp"),
        mesh=mesh,
        in_specs=(PS(None, "mp"), PS(None, "mp"), PS(), PS(), PS(), PS()),
        out_specs=(PS(None, "mp"), PS(None, "mp")))
    got_in, got_out = fn(
        jax.device_put(jnp.asarray(w_in), sh), jax.device_put(jnp.asarray(w_out), sh),
        jnp.asarray(centers), jnp.asarray(contexts), jnp.asarray(valid),
        jnp.asarray(negs))
    # per-device slice is [V, D/2] — the tables genuinely live sharded
    assert got_in.sharding.shard_shape(got_in.shape) == (V, D // 2)
    np.testing.assert_allclose(np.asarray(got_in), np.asarray(ref_in),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-6)


def test_model_sharded_training(karate_path):
    """model_shards=2 (optionally x dp) trains with the tables stored [V, D/2]
    per device and reaches the same downstream quality (SURVEY.md §2.3-5 sharded
    embedding tables)."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2)
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20, seed=1,
                         model_shards=2)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, num_partitions=2)
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices, seed=0)
    acc = ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids), seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


def test_model_sharded_training_one_dp_row(karate_path):
    """model_shards=2 with a single data-parallel row (the
    `--w2vModelShards N` flag alone): the corpus is replicated over the one dp
    row and training reaches the same downstream quality."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2)
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20, seed=1,
                         model_shards=2)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg)
    assert w_in.shape == (g.num_vertices, 32) and np.isfinite(w_in).all()
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices, seed=0)
    acc = ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids), seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


def test_data_parallel_training(karate_path):
    """w2vPartitions semantics: data-parallel shards with per-epoch parameter merge
    (reference Main.scala:93 / MLlib numPartitions). Quality must hold at P=4."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2)
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20, seed=1)
    w_in, w_out = w2v.train_skipgram(walks, g.num_vertices, cfg, num_partitions=4)
    assert w_in.shape == (g.num_vertices, 32)
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices, seed=0)
    acc = ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids), seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


def test_shared_pos_matches_pair_granular():
    """The block-position-granular shared-negative step (the table-traffic
    lever) must compute the same update as the pair-granular form — same
    pairs, same gradients, same scatter-mean normalization (fp order aside)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    V, D, B, T, win, kB = 500, 32, 8, 21, 5, 64
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[0, :3] = -1                      # padding present
    key = jax.random.PRNGKey(7)
    centers, contexts, valid = w2v._pairs_for_block(jnp.asarray(block), key, win)
    pos_c, pos_x, valid2 = w2v._pairs_pos_for_block(jnp.asarray(block), key, win)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid2))
    # positions resolve to the same tokens wherever the pair is valid
    flat = block.reshape(-1)
    v = np.asarray(valid)
    np.testing.assert_array_equal(flat[np.asarray(pos_c)][v],
                                  np.asarray(centers)[v])
    np.testing.assert_array_equal(flat[np.asarray(pos_x)][v],
                                  np.asarray(contexts)[v])
    negs = jnp.asarray(rng.integers(0, V, kB).astype(np.int32))
    w_in = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    w_out = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    a_in, a_out = w2v._sgns_apply_shared(
        w_in, w_out, centers, contexts, valid, negs, 0.1, neg_weight=5 / kB)
    b_in, b_out = w2v._sgns_apply_shared_pos(
        w_in, w_out, jnp.asarray(block), pos_c, pos_x, valid2, negs, 0.1,
        neg_weight=5 / kB)
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out),
                               rtol=2e-4, atol=2e-6)


def test_shared_conv_matches_pos_granular():
    """The dense shifted-window shared-negative step (round-4: no pair
    gathers/scatters at all) must compute the same update as the
    position-granular form — same pair set, same gradients, same
    normalization (fp order aside)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    V, D, B, T, win, kB = 400, 32, 6, 23, 5, 64
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[1, 17:] = -1                     # padding present
    key = jax.random.PRNGKey(9)
    pos_c, pos_x, validf = w2v._pairs_pos_for_block(jnp.asarray(block), key, win)
    valid, _ = w2v._valid_for_block(jnp.asarray(block), key, win)
    np.testing.assert_array_equal(np.asarray(validf),
                                  np.asarray(valid).reshape(-1))
    negs = jnp.asarray(rng.integers(0, V, kB).astype(np.int32))
    w_in = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    w_out = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    a_in, a_out = w2v._sgns_apply_shared_pos(
        w_in, w_out, jnp.asarray(block), pos_c, pos_x, validf, negs, 0.1,
        neg_weight=5 / kB)
    b_in, b_out = w2v._sgns_apply_shared_conv(
        w_in, w_out, jnp.asarray(block), valid, negs, 0.1,
        neg_weight=5 / kB, window=win)
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out),
                               rtol=2e-4, atol=2e-6)


def test_shared_conv_dp_branch_matches_pos_dp_branch():
    """The conv formulation's psum (dp) branch must be update-identical to the
    position-granular psum branch — same accumulator/count merge semantics
    (the dp branch normalizes negative-row/context collisions differently
    from the single-replica branch by design, so the comparison is
    branch-to-branch)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    rng = np.random.default_rng(2)
    V, D, B, T, win, kB = 200, 16, 4, 12, 3, 32
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    pos_c, pos_x, validf = w2v._pairs_pos_for_block(jnp.asarray(block), key, win)
    valid, _ = w2v._valid_for_block(jnp.asarray(block), key, win)
    negs = jnp.asarray(rng.integers(0, V, kB).astype(np.int32))
    w_in = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    w_out = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))

    def run(fn):
        return jax.shard_map(fn, mesh=mesh, in_specs=(PS(), PS()),
                             out_specs=(PS(), PS()))(w_in, w_out)

    a_in, a_out = run(lambda wi, wo: w2v._sgns_apply_shared_pos(
        wi, wo, jnp.asarray(block), pos_c, pos_x, validf, negs, 0.1,
        neg_weight=5 / kB, axis_name="dp"))
    b_in, b_out = run(lambda wi, wo: w2v._sgns_apply_shared_conv(
        wi, wo, jnp.asarray(block), valid, negs, 0.1,
        neg_weight=5 / kB, window=win, axis_name="dp"))
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out),
                               rtol=2e-4, atol=2e-6)


def test_shared_band_matches_conv():
    """The banded-matmul formulation (shared_impl="band" — kept as the
    ablation of conv) must compute the same update as the conv formulation,
    including with padding present."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    V, D, B, T, win, kB = 400, 32, 6, 23, 5, 64
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[2, 15:] = -1                     # padding present
    key = jax.random.PRNGKey(11)
    valid, _ = w2v._valid_for_block(jnp.asarray(block), key, win)
    negs = jnp.asarray(rng.integers(0, V, kB).astype(np.int32))
    w_in = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    w_out = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    a_in, a_out = w2v._sgns_apply_shared_conv(
        w_in, w_out, jnp.asarray(block), valid, negs, 0.1,
        neg_weight=5 / kB, window=win)
    b_in, b_out = w2v._sgns_apply_shared_conv(
        w_in, w_out, jnp.asarray(block), valid, negs, 0.1,
        neg_weight=5 / kB, window=win, band=True)
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out),
                               rtol=2e-4, atol=2e-6)


def _sgns_shared_reference(w_in, w_out, centers, contexts, valid, negs, lr,
                           neg_weight):
    """Float64 NumPy statement of one block-shared-negative SGNS step:
    manual gradients, scatter-MEAN updates of the center and context rows,
    and the shared-negative rows moved by their summed gradient over the
    block's weighted pair count."""
    w_in = w_in.astype(np.float64)
    w_out = w_out.astype(np.float64)
    vf = valid.astype(np.float64)
    c = np.where(valid, centers, 0)
    x = np.where(valid, contexts, 0)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    vi, vo, wn = w_in[c], w_out[x], w_out[negs]
    g_pos = (sig(np.sum(vi * vo, axis=1)) - 1.0) * vf
    g_neg = sig(vi @ wn.T) * (vf * neg_weight)[:, None]
    d_vi = g_pos[:, None] * vo + g_neg @ wn
    d_vo = g_pos[:, None] * vi
    d_wn = g_neg.T @ vi
    V = w_in.shape[0]
    cnt_in = np.maximum(np.bincount(c, weights=vf, minlength=V), 1.0)
    cnt_out = np.maximum(np.bincount(x, weights=vf, minlength=V), 1.0)
    acc_in = np.zeros_like(w_in)
    np.add.at(acc_in, c, d_vi)
    acc_out = np.zeros_like(w_out)
    np.add.at(acc_out, x, d_vo)
    new_in = w_in - lr * acc_in / cnt_in[:, None]
    new_out = w_out - lr * acc_out / cnt_out[:, None]
    np.add.at(new_out, negs, -lr * d_wn / max(vf.sum() * neg_weight, 1.0))
    return new_in, new_out


@pytest.mark.parametrize("P,D,kB", [
    (512, 128, 128),   # aligned
    (300, 50, 37),     # no axis a power of two
    (7, 128, 256),     # fewer pairs than shared negatives
])
def test_sgns_shared_steps_match_float64_reference(P, D, kB):
    """The pair-granular and the block-position-granular shared-negative steps
    both equal the float64 statement of the update. Float32 with sums of at
    most max(P, kB, D) terms: 2e-5 relative, 1e-6 absolute."""
    import jax.numpy as jnp

    rng = np.random.default_rng(P + D + kB)
    V, lr, neg_weight = 97, 0.05, 5 / kB
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    block = rng.integers(0, V, (1, 2 * P)).astype(np.int32)
    pos_c = rng.integers(0, 2 * P, P).astype(np.int32)
    pos_x = rng.integers(0, 2 * P, P).astype(np.int32)
    valid = rng.random(P) > 0.3
    negs = rng.integers(0, V, kB).astype(np.int32)
    centers, contexts = block[0][pos_c], block[0][pos_x]
    want_in, want_out = _sgns_shared_reference(
        w_in, w_out, centers, contexts, valid, negs, lr, neg_weight)

    got_pair = w2v._sgns_apply_shared(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(valid), jnp.asarray(negs), lr,
        neg_weight=neg_weight)
    got_pos = w2v._sgns_apply_shared_pos(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(block),
        jnp.asarray(pos_c), jnp.asarray(pos_x), jnp.asarray(valid),
        jnp.asarray(negs), lr, neg_weight=neg_weight)
    for got_in, got_out in (got_pair, got_pos):
        assert got_in.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(got_in), want_in,
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(got_out), want_out,
                                   rtol=2e-5, atol=1e-6)


def test_shared_pos_matches_pair_granular_dp_branch():
    """Through the data-parallel (psum) branch too, the block-position step
    applies the same update as the pair-granular step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    rng = np.random.default_rng(5)
    V, D, B, T, win, kB = 60, 16, 4, 15, 3, 24   # small V: many duplicates
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[3, 11:] = -1                     # padding present
    key = jax.random.PRNGKey(21)
    centers, contexts, valid = w2v._pairs_for_block(jnp.asarray(block), key,
                                                    win)
    pos_c, pos_x, valid2 = w2v._pairs_pos_for_block(jnp.asarray(block), key,
                                                    win)
    negs = jnp.asarray(rng.integers(0, V, kB).astype(np.int32))
    w_in = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    w_out = jnp.asarray((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))

    def run(fn):
        return jax.shard_map(fn, mesh=mesh, in_specs=(PS(), PS()),
                             out_specs=(PS(), PS()))(w_in, w_out)

    a_in, a_out = run(lambda wi, wo: w2v._sgns_apply_shared(
        wi, wo, centers, contexts, valid, negs, 0.1, neg_weight=5 / kB,
        axis_name="dp"))
    b_in, b_out = run(lambda wi, wo: w2v._sgns_apply_shared_pos(
        wi, wo, jnp.asarray(block), pos_c, pos_x, valid2, negs, 0.1,
        neg_weight=5 / kB, axis_name="dp"))
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out),
                               rtol=2e-4, atol=2e-6)


def test_sgns_config_has_no_kernel_switch():
    """The shared-negative gradients have one implementation (plain XLA):
    the config takes no kernel option."""
    with pytest.raises(TypeError):
        w2v.SGNSConfig(shared_negatives=128, use_pallas=True)
    assert "use_pallas" not in w2v.SGNSConfig.__dataclass_fields__
