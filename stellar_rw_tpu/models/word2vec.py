"""Skip-gram word2vec with negative sampling (SGNS) on the accelerator.

Replaces the reference's delegation to Spark-MLlib Word2Vec (reference Main.scala:89-97,
116,123: skip-gram + hierarchical softmax, minCount=0, lr/iter/dim/window from Params).
Per BASELINE.json's north star, hierarchical softmax is swapped for negative sampling;
the parity target is embedding *quality* (link prediction / node classification), not
bit parity.

Design (idiomatic XLA, SURVEY.md §7 milestone 3):
  - the walk corpus is a dense [N, T] i32 buffer (-1 padded) living on device;
  - pair generation is a static-shape enumeration: every (position, offset) cell of
    [N, T, 2*window] is a potential pair, masked by sentence bounds, padding, and the
    per-center dynamic window (word2vec's `b = rand % window` reduced-window rule,
    which MLlib inherits from the C implementation);
  - one jitted epoch = lax.scan over row blocks; each block generates its pairs,
    draws negatives from a unigram^0.75 alias table, computes the classic SGNS
    manual gradients, and applies them with scatter-adds; embeddings are donated so
    updates stay in HBM;
  - learning rate decays linearly over all epochs to lr/1e4, MLlib-style.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.alias import build_alias


@dataclass(frozen=True)
class SGNSConfig:
    dim: int = 128
    window: int = 10
    negatives: int = 5
    lr: float = 0.025
    min_lr_frac: float = 1e-4
    iters: int = 10
    row_block: int = 32      # walks per scan step (one scatter-mean update each)
    seed: int = 0
    power: float = 0.75      # unigram smoothing for negative table
    shared_negatives: int = 0  # >0: kB block-shared negatives (matmul path, see below)
    shared_impl: str = "conv"  # "conv": dense shifted-window shared path (no
    #                            pair gathers/scatters — the default);
    #                            "band": the same math as banded [T,T]
    #                            matmuls (the ablation; not yet measured on
    #                            the GPU); "pos": position-granular scatters
    #                            (update-identical)
    model_shards: int = 1    # >1: shard embedding tables over the embedding dim
    #                          (column parallelism: each device stores [V, D/mp],
    #                          gathers/scatters stay local, only the [pairs, 1+k]
    #                          logits cross devices via psum — the "sharded
    #                          embedding table" of SURVEY.md §2.3-5)

    def __post_init__(self):
        # a typo'd shared_impl must error, not silently select another path
        # (ablation results would be mislabeled — round-4 advisor finding)
        if self.shared_impl not in ("band", "conv", "pos"):
            raise ValueError(f"shared_impl must be 'band', 'conv' or 'pos', "
                             f"got {self.shared_impl!r}")


def _init_embeddings(vocab: int, dim: int, key) -> tuple[jax.Array, jax.Array]:
    """word2vec-style init: input uniform in [-0.5/dim, 0.5/dim), output zeros."""
    w_in = (jax.random.uniform(key, (vocab, dim), jnp.float32) - 0.5) / dim
    w_out = jnp.zeros((vocab, dim), jnp.float32)
    return w_in, w_out


def _pairs_for_block(block: jax.Array, key: jax.Array, window: int):
    """Enumerate skip-gram pairs for a [B, T] block.

    Returns (centers, contexts, valid) flattened to [B*T*2*window]. The dynamic
    window per center position is c ~ Uniform{1..window}; a pair at offset d is valid
    iff |d| <= c, both tokens in-bounds and not padding (-1).
    """
    B, T = block.shape
    offs = jnp.concatenate(
        [jnp.arange(-window, 0), jnp.arange(1, window + 1)]).astype(jnp.int32)  # [2w]
    pos = jnp.arange(T, dtype=jnp.int32)
    ctx_pos = pos[:, None] + offs[None, :]                      # [T, 2w]
    in_bounds = (ctx_pos >= 0) & (ctx_pos < T)
    ctx_pos_c = jnp.clip(ctx_pos, 0, T - 1)
    centers = jnp.broadcast_to(block[:, :, None], (B, T, 2 * window))
    contexts = block[:, ctx_pos_c]                              # [B, T, 2w]
    cwin = jax.random.randint(key, (B, T), 1, window + 1)       # dynamic window
    valid = (
        in_bounds[None, :, :]
        & (jnp.abs(offs)[None, None, :] <= cwin[:, :, None])
        & (centers >= 0)
        & (contexts >= 0)
    )
    flat = lambda x: x.reshape(-1)
    return flat(centers), flat(contexts), flat(valid)


def _valid_for_block(block: jax.Array, key: jax.Array, window: int):
    """[B, T, 2w] pair-validity mask (identical enumeration + key consumption
    as _pairs_for_block): cell (b, t, o) is the pair (center (b,t), context
    (b, t+offs[o])), valid iff in-bounds, non-padding on both sides, and
    |offs[o]| <= the center's dynamic window draw."""
    B, T = block.shape
    offs = jnp.concatenate(
        [jnp.arange(-window, 0), jnp.arange(1, window + 1)]).astype(jnp.int32)
    pos = jnp.arange(T, dtype=jnp.int32)
    ctx_pos = pos[:, None] + offs[None, :]                      # [T, 2w]
    in_bounds = (ctx_pos >= 0) & (ctx_pos < T)
    ctx_pos_c = jnp.clip(ctx_pos, 0, T - 1)
    centers = jnp.broadcast_to(block[:, :, None], (B, T, 2 * window))
    contexts = block[:, ctx_pos_c]
    cwin = jax.random.randint(key, (B, T), 1, window + 1)       # dynamic window
    valid = (
        in_bounds[None, :, :]
        & (jnp.abs(offs)[None, None, :] <= cwin[:, :, None])
        & (centers >= 0)
        & (contexts >= 0)
    )
    return valid, ctx_pos_c


def _pairs_pos_for_block(block: jax.Array, key: jax.Array, window: int):
    """Skip-gram pairs as POSITIONS into the flattened [B*T] block.

    Same enumeration and dynamic-window mask as _pairs_for_block (identical
    `key` consumption), but returns (pos_center, pos_context, valid) flat
    indices instead of token ids. This is what lets the shared-negative path
    gather/scatter embedding rows at BLOCK-POSITION granularity (B*T rows)
    instead of pair granularity (B*T*2w rows): embedding-table row traffic is
    the measured binding resource of the trainer, and the dedup cuts it ~2w x.
    """
    B, T = block.shape
    valid, ctx_pos_c = _valid_for_block(block, key, window)
    pos = jnp.arange(T, dtype=jnp.int32)
    row = jnp.arange(B, dtype=jnp.int32)[:, None, None] * T
    pos_c = jnp.broadcast_to(pos[None, :, None] + row, valid.shape)
    pos_x = jnp.broadcast_to(ctx_pos_c[None, :, :] + row, valid.shape)
    flat = lambda x: x.reshape(-1)
    return flat(pos_c), flat(pos_x), flat(valid)


def _draw_negatives(key, shape, neg_keep: jax.Array, neg_alias: jax.Array):
    n = neg_keep.shape[0]
    u1 = jax.random.uniform(key, shape)
    u2 = jax.random.uniform(jax.random.fold_in(key, 1), shape)
    j = jnp.minimum((u1 * n).astype(jnp.int32), n - 1)
    return jnp.where(u2 < neg_keep[j], j, neg_alias[j])


def _sgns_apply(w_in, w_out, centers, contexts, valid, negs, lr, axis_name=None,
                dim_axis=None):
    """One mini-batch of SGNS SGD with manual gradients and scatter-MEAN updates.

    P pairs, k negatives: targets = [context | negs], labels = [1 | 0...]. Invalid
    pairs are masked to zero gradient/count. Duplicate rows within a batch are
    averaged, not summed: summed scatter explodes on small vocabularies where a hub
    vertex collides thousands of times per batch (each row moves by ≈ one sequential
    SGD step per batch, which is also closer to MLlib's per-sentence sequential
    updates than a summed mega-batch would be).

    dim_axis: mesh axis the embedding DIM is sharded over (w_in/w_out are local
    [V, D/mp] slices). Dots become partial sums merged with one tiny psum; every
    gather, gradient, and scatter stays local to the dim slice.
    """
    P = centers.shape[0]
    k = negs.shape[1]
    c = jnp.where(valid, centers, 0)
    targets = jnp.concatenate([jnp.where(valid, contexts, 0)[:, None], negs], axis=1)  # [P,1+k]
    vi = w_in[c]                                   # [P, D]
    vo = w_out[targets]                            # [P, 1+k, D]
    logits = jnp.einsum("pd,pkd->pk", vi, vo)
    if dim_axis is not None:
        logits = jax.lax.psum(logits, dim_axis)
    labels = jnp.concatenate(
        [jnp.ones((P, 1), jnp.float32), jnp.zeros((P, k), jnp.float32)], axis=1)
    g = (jax.nn.sigmoid(logits) - labels) * valid[:, None]        # [P, 1+k]
    d_vi = jnp.einsum("pk,pkd->pd", g, vo)
    d_vo = (g[:, :, None] * vi[:, None, :]).reshape(-1, vi.shape[-1])  # [P*(1+k), D]
    tflat = targets.reshape(-1)
    vmask = jnp.broadcast_to(valid[:, None], (P, 1 + k)).reshape(-1).astype(jnp.float32)

    cnt_in = jnp.zeros((w_in.shape[0],), jnp.float32).at[c].add(
        valid.astype(jnp.float32), mode="drop")
    cnt_out = jnp.zeros((w_out.shape[0],), jnp.float32).at[tflat].add(
        vmask, mode="drop")
    if axis_name is not None:
        # synchronous data parallelism: every device applies the identical merged
        # update, so parameters stay replicated (equivalent to one device with a
        # P-times-larger block — no per-epoch model averaging needed)
        acc_in = jnp.zeros_like(w_in).at[c].add(d_vi, mode="drop")
        acc_out = jnp.zeros_like(w_out).at[tflat].add(d_vo, mode="drop")
        acc_in = jax.lax.psum(acc_in, axis_name)
        cnt_in = jax.lax.psum(cnt_in, axis_name)
        acc_out = jax.lax.psum(acc_out, axis_name)
        cnt_out = jax.lax.psum(cnt_out, axis_name)
        w_in = w_in - lr * acc_in / jnp.maximum(cnt_in, 1.0)[:, None]
        w_out = w_out - lr * acc_out / jnp.maximum(cnt_out, 1.0)[:, None]
        return w_in, w_out
    # single-replica: scatter the mean update straight into the tables — only the
    # touched rows move, no [V, D] accumulator traffic (matters at LiveJournal-scale
    # vocabularies where a full-table pass per block would dominate)
    w_in = w_in.at[c].add(-lr * d_vi / jnp.maximum(cnt_in, 1.0)[c][:, None],
                          mode="drop")
    w_out = w_out.at[tflat].add(
        -lr * d_vo / jnp.maximum(cnt_out, 1.0)[tflat][:, None], mode="drop")
    return w_in, w_out


def _sgns_apply_shared(w_in, w_out, centers, contexts, valid, negs, lr,
                       neg_weight: float, axis_name=None, dim_axis=None):
    """SGNS step with BLOCK-SHARED negatives — the matmul formulation.

    Instead of k private negatives per pair (P·k embedding gathers + elementwise
    dots), the whole block shares kB negative rows: the negative logits become one
    [P, D] x [D, kB] matmul and the two negative gradients become matmuls too, so the
    dominant FLOPs are dense matrix products instead of gathers. Each
    negative's gradient is weighted by neg_weight = k / kB, making the expected
    gradient identical to per-pair sampling (negative-sample sharing, the standard
    trick in batched word2vec implementations). Quality parity is asserted by the
    same link-prediction/classification tests as the exact path.
    """
    P = centers.shape[0]
    c = jnp.where(valid, centers, 0)
    x = jnp.where(valid, contexts, 0)
    vf = valid.astype(jnp.float32)
    vi = w_in[c]                                   # [P, D]
    vo = w_out[x]                                  # [P, D]
    wn = w_out[negs]                               # [kB, D]
    pos = jnp.sum(vi * vo, axis=-1)                # [P]
    if dim_axis is not None:
        pos = jax.lax.psum(pos, dim_axis)
    g_pos = (jax.nn.sigmoid(pos) - 1.0) * vf                     # [P]
    neg = jnp.dot(vi, wn.T, preferred_element_type=jnp.float32)  # [P, kB]
    if dim_axis is not None:
        neg = jax.lax.psum(neg, dim_axis)
    g_neg = jax.nn.sigmoid(neg) * (vf * neg_weight)[:, None]     # [P, kB]
    d_vi = g_pos[:, None] * vo + jnp.dot(
        g_neg, wn, preferred_element_type=jnp.float32)           # [P, D]
    d_vo = g_pos[:, None] * vi                                   # [P, D]
    d_wn = jnp.dot(g_neg.T, vi, preferred_element_type=jnp.float32)  # [kB, D]

    cnt_in = jnp.zeros((w_in.shape[0],), jnp.float32).at[c].add(vf, mode="drop")
    cnt_out = jnp.zeros((w_out.shape[0],), jnp.float32).at[x].add(vf, mode="drop")
    # every valid pair touches every shared negative with weight neg_weight
    cnt_n = jnp.maximum(jnp.sum(vf) * neg_weight, 1.0)
    if axis_name is not None:
        acc_in = jnp.zeros_like(w_in).at[c].add(d_vi, mode="drop")
        acc_out = jnp.zeros_like(w_out).at[x].add(d_vo, mode="drop")
        acc_out = acc_out.at[negs].add(
            d_wn * (jnp.sum(vf) * neg_weight / cnt_n), mode="drop")
        cnt_out = cnt_out.at[negs].add(cnt_n, mode="drop")
        acc_in = jax.lax.psum(acc_in, axis_name)
        cnt_in = jax.lax.psum(cnt_in, axis_name)
        acc_out = jax.lax.psum(acc_out, axis_name)
        cnt_out = jax.lax.psum(cnt_out, axis_name)
        w_in = w_in - lr * acc_in / jnp.maximum(cnt_in, 1.0)[:, None]
        w_out = w_out - lr * acc_out / jnp.maximum(cnt_out, 1.0)[:, None]
        return w_in, w_out
    w_in = w_in.at[c].add(-lr * d_vi / jnp.maximum(cnt_in, 1.0)[c][:, None],
                          mode="drop")
    w_out = w_out.at[x].add(-lr * d_vo / jnp.maximum(cnt_out, 1.0)[x][:, None],
                            mode="drop")
    w_out = w_out.at[negs].add(-lr * d_wn / cnt_n, mode="drop")
    return w_in, w_out


def _sgns_apply_shared_pos(w_in, w_out, block, pos_c, pos_x, valid, negs, lr,
                           neg_weight: float, axis_name=None, dim_axis=None):
    """Shared-negative SGNS step with BLOCK-POSITION-granular table traffic.

    Identical update semantics to _sgns_apply_shared (same gradients, same
    scatter-mean normalization; fp summation order differs), but embedding
    rows are gathered/scattered once per BLOCK POSITION (B*T rows) rather than
    once per pair (B*T*2*window rows): pairs index into the block-local
    [B*T, D] arrays, which are ~2*window-times smaller. Embedding-row
    gather/scatter transactions are expected to bind the trainer, so this is
    the direct lever (not yet measured on the GPU).
    """
    N = block.size
    flat = block.reshape(-1)
    tok = jnp.maximum(flat, 0)
    vf = valid.astype(jnp.float32)
    ein = w_in[tok]                    # [N, D] — the only w_in row gathers
    eout = w_out[tok]                  # [N, D]
    vi = ein[pos_c]                    # block-local gathers [P, D]
    vo = eout[pos_x]
    wn = w_out[negs]                   # [kB, D]
    pos = jnp.sum(vi * vo, axis=-1)
    if dim_axis is not None:
        pos = jax.lax.psum(pos, dim_axis)
    g_pos = (jax.nn.sigmoid(pos) - 1.0) * vf
    neg = jnp.dot(vi, wn.T, preferred_element_type=jnp.float32)
    if dim_axis is not None:
        neg = jax.lax.psum(neg, dim_axis)
    g_neg = jax.nn.sigmoid(neg) * (vf * neg_weight)[:, None]
    d_vi = g_pos[:, None] * vo + jnp.dot(
        g_neg, wn, preferred_element_type=jnp.float32)
    d_vo = g_pos[:, None] * vi
    d_wn = jnp.dot(g_neg.T, vi, preferred_element_type=jnp.float32)

    # pair -> block-position accumulation (small [N, D] scatters)
    acc_in_pos = jnp.zeros((N, vi.shape[-1]), jnp.float32).at[pos_c].add(d_vi)
    acc_out_pos = jnp.zeros((N, vi.shape[-1]), jnp.float32).at[pos_x].add(d_vo)
    cnt_in_pos = jnp.zeros((N,), jnp.float32).at[pos_c].add(vf)
    cnt_out_pos = jnp.zeros((N,), jnp.float32).at[pos_x].add(vf)
    cnt_in = jnp.zeros((w_in.shape[0],), jnp.float32).at[tok].add(
        cnt_in_pos, mode="drop")
    cnt_out = jnp.zeros((w_out.shape[0],), jnp.float32).at[tok].add(
        cnt_out_pos, mode="drop")
    cnt_n = jnp.maximum(jnp.sum(vf) * neg_weight, 1.0)
    if axis_name is not None:
        acc_in = jnp.zeros_like(w_in).at[tok].add(acc_in_pos, mode="drop")
        acc_out = jnp.zeros_like(w_out).at[tok].add(acc_out_pos, mode="drop")
        acc_out = acc_out.at[negs].add(
            d_wn * (jnp.sum(vf) * neg_weight / cnt_n), mode="drop")
        cnt_out = cnt_out.at[negs].add(cnt_n, mode="drop")
        acc_in = jax.lax.psum(acc_in, axis_name)
        cnt_in = jax.lax.psum(cnt_in, axis_name)
        acc_out = jax.lax.psum(acc_out, axis_name)
        cnt_out = jax.lax.psum(cnt_out, axis_name)
        w_in = w_in - lr * acc_in / jnp.maximum(cnt_in, 1.0)[:, None]
        w_out = w_out - lr * acc_out / jnp.maximum(cnt_out, 1.0)[:, None]
        return w_in, w_out
    # token-level scatter-mean: N row scatters per table (duplicate tokens
    # accumulate, then each row moves by the mean of its gradients)
    w_in = w_in.at[tok].add(
        -lr * acc_in_pos / jnp.maximum(cnt_in, 1.0)[tok][:, None], mode="drop")
    w_out = w_out.at[tok].add(
        -lr * acc_out_pos / jnp.maximum(cnt_out, 1.0)[tok][:, None],
        mode="drop")
    w_out = w_out.at[negs].add(-lr * d_wn / cnt_n, mode="drop")
    return w_in, w_out


def _shift(x, d: int):
    """y[:, t] = x[:, t + d] along axis 1, zero-padded beyond the bounds."""
    if d == 0:
        return x
    pad = [(0, 0)] * x.ndim
    if d > 0:
        pad[1] = (0, d)
        return jnp.pad(x[:, d:], pad)
    pad[1] = (-d, 0)
    return jnp.pad(x[:, :d], pad)


def _sgns_apply_shared_conv(w_in, w_out, block, valid, negs, lr,
                            neg_weight: float, window: int, axis_name=None,
                            dim_axis=None, band: bool = False):
    """Shared-negative SGNS step in the DENSE shifted-window formulation.

    Update-identical to _sgns_apply_shared_pos (same pair set, same gradients,
    same scatter-mean normalization; only fp summation order differs), but the
    pair axis never materializes as gathers/scatters. The key structural facts
    (round-3 verdict item 3 — the measured 57 ms/epoch residual was
    "pair-granular VPU work + position scatters"):

      * a pair's CENTER position is constant across its 2w offsets, so the
        center row vi = ein[center] is a broadcast, not a gather, and the
        pair -> position gradient accumulation is a fixed-length reduction
        over the offset axis, not a scatter;
      * a pair's CONTEXT is the center shifted by a static offset, so context
        rows and context-side accumulations are zero-padded SHIFTS of the
        dense [B, T, D] block — 2w fused elementwise passes over an
        on-chip buffer, not B*T*2w row gathers + a scatter;
      * the negative logits depend on the pair only through its center
        position, so the [pairs, kB] matmul collapses to [positions, kB] —
        2w-times fewer matmul FLOPs — and the negative gradients weight by the
        center's VALID-PAIR COUNT instead of fanning out per pair.

    Embedding-table traffic (the measured binding resource) is unchanged from
    the _pos path: one gather + one scatter per block position per table.

    band=True computes the SAME quantities through banded [T, T] batched
    matmuls instead of 2w shifted elementwise passes (shared_impl="band"):
    logits[b, t, i] = S[b, t, t+offs[i]] for S = ein @ eout^T, and both
    gradient accumulations are G @ eout / G^T @ ein where G is g_pos
    scattered back into its band — 3 batched matmuls replace ~6w
    elementwise passes. Update-identical up to fp summation order. "conv"
    is the default and band is the ablation; which wins on the GPU has not
    been measured yet.
    """
    B, T = block.shape
    N = B * T
    D = w_in.shape[1]
    offs = [int(d) for d in range(-window, 0)] + \
           [int(d) for d in range(1, window + 1)]
    flat = block.reshape(-1)
    tok = jnp.maximum(flat, 0)
    vf = valid.astype(jnp.float32)                    # [B, T, 2w]
    ein = w_in[tok].reshape(B, T, D)                  # the only row gathers
    eout = w_out[tok].reshape(B, T, D)
    wn = w_out[negs]                                  # [kB, D]

    if band:
        pos = jnp.arange(T, dtype=jnp.int32)
        idx = pos[:, None] + jnp.asarray(offs, jnp.int32)[None, :]  # [T, 2w]
        idx_c = jnp.clip(idx, 0, T - 1)
        S = jnp.einsum("btd,bud->btu", ein, eout,
                       preferred_element_type=jnp.float32)      # [B, T, T]
        # out-of-bounds band cells read clamped garbage; vf (which includes
        # the in-bounds mask) zeroes their g_pos, exactly like _shift's pads
        logits = jnp.take_along_axis(
            S, jnp.broadcast_to(idx_c[None], (B, T, 2 * window)), axis=2)
    else:
        logits = jnp.stack(
            [jnp.sum(ein * _shift(eout, d), axis=-1) for d in offs], axis=-1)
    negl = jnp.dot(ein.reshape(N, D), wn.T,
                   preferred_element_type=jnp.float32)           # [N, kB]
    if dim_axis is not None:
        logits = jax.lax.psum(logits, dim_axis)
        negl = jax.lax.psum(negl, dim_axis)
    g_pos = (jax.nn.sigmoid(logits) - 1.0) * vf       # [B, T, 2w]
    sneg = jax.nn.sigmoid(negl)                       # [N, kB]
    vcnt = jnp.sum(vf, axis=-1)                       # [B, T] pairs per center

    if band:
        # g_pos scattered into its band (masked cells add exact 0.0 at the
        # clamped slot); the two accumulations become batched matmuls
        G = jnp.zeros((B, T, T), jnp.float32).at[
            :, pos[:, None], idx_c].add(g_pos)
        acc_in_pos = jnp.einsum("btu,bud->btd", G, eout,
                                preferred_element_type=jnp.float32)
        acc_out_pos = jnp.einsum("btu,btd->bud", G, ein,
                                 preferred_element_type=jnp.float32)
        acc_in_pos = acc_in_pos + jnp.dot(
            sneg, wn, preferred_element_type=jnp.float32).reshape(B, T, D) \
            * (neg_weight * vcnt)[..., None]
    else:
        # center-side: sum over offsets of g_pos * context-row + the
        # per-position negative term (each valid pair contributes the SAME
        # sigmoid(negl) @ wn)
        acc_in_pos = sum(g_pos[..., i, None] * _shift(eout, d)
                         for i, d in enumerate(offs))
        acc_in_pos = acc_in_pos + jnp.dot(
            sneg, wn, preferred_element_type=jnp.float32).reshape(B, T, D) \
            * (neg_weight * vcnt)[..., None]
        # context-side: back-shift each offset's g_pos * center-row into place
        acc_out_pos = sum(_shift(g_pos[..., i, None] * ein, -d)
                          for i, d in enumerate(offs))
    cnt_in_pos = vcnt.reshape(N)
    cnt_out_pos = sum(_shift(vf[..., i], -d)
                      for i, d in enumerate(offs)).reshape(N)
    d_wn = jnp.dot((sneg * (neg_weight * vcnt.reshape(N))[:, None]).T,
                   ein.reshape(N, D),
                   preferred_element_type=jnp.float32)           # [kB, D]

    cnt_in = jnp.zeros((w_in.shape[0],), jnp.float32).at[tok].add(
        cnt_in_pos, mode="drop")
    cnt_out = jnp.zeros((w_out.shape[0],), jnp.float32).at[tok].add(
        cnt_out_pos, mode="drop")
    cnt_n = jnp.maximum(jnp.sum(vf) * neg_weight, 1.0)
    ai = acc_in_pos.reshape(N, D)
    ao = acc_out_pos.reshape(N, D)
    if axis_name is not None:
        acc_in = jnp.zeros_like(w_in).at[tok].add(ai, mode="drop")
        acc_out = jnp.zeros_like(w_out).at[tok].add(ao, mode="drop")
        acc_out = acc_out.at[negs].add(
            d_wn * (jnp.sum(vf) * neg_weight / cnt_n), mode="drop")
        cnt_out = cnt_out.at[negs].add(cnt_n, mode="drop")
        acc_in = jax.lax.psum(acc_in, axis_name)
        cnt_in = jax.lax.psum(cnt_in, axis_name)
        acc_out = jax.lax.psum(acc_out, axis_name)
        cnt_out = jax.lax.psum(cnt_out, axis_name)
        w_in = w_in - lr * acc_in / jnp.maximum(cnt_in, 1.0)[:, None]
        w_out = w_out - lr * acc_out / jnp.maximum(cnt_out, 1.0)[:, None]
        return w_in, w_out
    w_in = w_in.at[tok].add(
        -lr * ai / jnp.maximum(cnt_in, 1.0)[tok][:, None], mode="drop")
    w_out = w_out.at[tok].add(
        -lr * ao / jnp.maximum(cnt_out, 1.0)[tok][:, None], mode="drop")
    w_out = w_out.at[negs].add(-lr * d_wn / cnt_n, mode="drop")
    return w_in, w_out


@partial(jax.jit,
         static_argnames=("window", "negatives", "axis_name", "dim_axis",
                          "shared_negatives", "shared_impl"),
         donate_argnums=(0, 1))
def _train_epoch(w_in, w_out, corpus, neg_keep, neg_alias, key,
                 lr_start, lr_end, window: int, negatives: int, axis_name=None,
                 dim_axis=None, shared_negatives: int = 0,
                 shared_impl: str = "conv"):
    """One epoch over the full corpus: scan over row blocks (corpus pre-padded to a
    multiple of the block size with -1 rows)."""
    n_blocks, B, T = corpus.shape

    def body(carry, xs):
        w_in, w_out = carry
        block, i = xs
        kb = jax.random.fold_in(key, i)
        frac = i.astype(jnp.float32) / n_blocks
        lr = lr_start * (1 - frac) + lr_end * frac
        if shared_negatives and shared_impl in ("conv", "band"):
            # dense shifted-window formulation: no pair gathers/scatters at
            # all (same pair set + negatives — identical key consumption);
            # "band" runs the offset reductions as banded matmuls
            valid, _ = _valid_for_block(block, kb, window)
            negs = _draw_negatives(jax.random.fold_in(kb, 2),
                                   (shared_negatives,), neg_keep, neg_alias)
            w_in, w_out = _sgns_apply_shared_conv(
                w_in, w_out, block, valid, negs, lr,
                neg_weight=negatives / shared_negatives, window=window,
                axis_name=axis_name, dim_axis=dim_axis,
                band=shared_impl == "band")
        elif shared_negatives:
            # position-granular path: table row traffic scales with B*T, not
            # B*T*2*window (same pair set + negatives as the pair-granular
            # form — identical key consumption)
            pos_c, pos_x, valid = _pairs_pos_for_block(block, kb, window)
            negs = _draw_negatives(jax.random.fold_in(kb, 2),
                                   (shared_negatives,), neg_keep, neg_alias)
            w_in, w_out = _sgns_apply_shared_pos(
                w_in, w_out, block, pos_c, pos_x, valid, negs, lr,
                neg_weight=negatives / shared_negatives, axis_name=axis_name,
                dim_axis=dim_axis)
        else:
            centers, contexts, valid = _pairs_for_block(block, kb, window)
            negs = _draw_negatives(jax.random.fold_in(kb, 2),
                                   (centers.shape[0], negatives), neg_keep, neg_alias)
            w_in, w_out = _sgns_apply(w_in, w_out, centers, contexts, valid, negs,
                                      lr, axis_name=axis_name, dim_axis=dim_axis)
        return (w_in, w_out), None

    (w_in, w_out), _ = jax.lax.scan(
        body, (w_in, w_out), (corpus, jnp.arange(n_blocks)))
    return w_in, w_out


def train_skipgram(
    corpus: np.ndarray,
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray | None = None,
    num_partitions: int = 1,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_epoch: int = 0,
    on_epoch=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Train SGNS on a dense [N, T] i32 corpus (-1 padding). Returns (w_in, w_out).

    num_partitions > 1 runs SYNCHRONOUS data-parallel training over that many
    devices: per-block gradients are psum-merged so every replica applies the same
    update. This is the synchronous upgrade of the reference's `w2vPartitions`
    (MLlib trains numPartitions shards and averages parameters per iteration,
    Main.scala:93 — which measurably degrades embedding quality; synchronous
    merging keeps quality at the single-partition level while scaling).

    cfg.model_shards > 1 additionally shards BOTH embedding tables over the
    embedding dimension across a second mesh axis (column parallelism): each
    device persistently stores [vocab, dim/mp], all gathers/scatter-updates are
    local to the slice, and only the tiny [pairs, 1+k] logit partial sums cross
    devices (one psum). Total devices used = num_partitions * model_shards.
    This is the sharded-embedding-table requirement of SURVEY.md §2.3-5 /
    BASELINE.json ("in-HBM embedding table sharding") — a ≥1B-edge vocabulary's
    tables no longer need to fit a single chip.
    """
    N, T = corpus.shape
    on_device = isinstance(corpus, jax.Array)
    if counts is None:
        if on_device:
            # token frequencies computed on device (only the [vocab] vector
            # crosses to host for the alias build)
            flat = corpus.reshape(-1).astype(jnp.int32)
            ok = (flat >= 0).astype(jnp.float32)
            counts = np.asarray(
                jnp.zeros(vocab_size, jnp.float32)
                .at[jnp.maximum(flat, 0)].add(ok)).astype(np.float64)
        else:
            flat = corpus[corpus >= 0]
            counts = np.bincount(flat, minlength=vocab_size).astype(np.float64)
    neg_keep, neg_alias = build_alias(np.maximum(counts, 1e-12) ** cfg.power)

    P = max(1, num_partitions)
    # per-device block shrinks with P so the GLOBAL rows-per-merged-update stays
    # cfg.row_block: P-way training then takes the same number of (equivalent)
    # update steps as single-device training, preserving quality
    B = max(1, min(-(-cfg.row_block // P), max(-(-N // P), 1)))
    n_blocks = -(-N // (B * P))
    pad_rows = P * n_blocks * B - N
    if on_device:
        padded = corpus.astype(jnp.int32)
        if pad_rows:
            padded = jnp.concatenate(
                [padded, jnp.full((pad_rows, T), -1, jnp.int32)])
    else:
        padded = np.full((P * n_blocks * B, T), -1, dtype=np.int32)
        padded[:N] = corpus
    nk = jnp.asarray(neg_keep)
    na = jnp.asarray(neg_alias)

    key = jax.random.PRNGKey(cfg.seed)
    if init is not None:
        # resume from a checkpoint (same counter-based keys -> epochs start_epoch..
        # iters replay exactly what an uninterrupted run would have done)
        w_in = jnp.asarray(init[0], jnp.float32)
        w_out = jnp.asarray(init[1], jnp.float32)
    else:
        w_in, w_out = _init_embeddings(vocab_size, cfg.dim,
                                       jax.random.fold_in(key, 0x1A17))
    lr_lo = cfg.lr * cfg.min_lr_frac
    MP = max(1, cfg.model_shards)
    if P == 1 and MP == 1:
        corpus_dev = jnp.asarray(padded.reshape(n_blocks, B, T))
        epoch = lambda w_in, w_out, k, ls, le: _train_epoch(
            w_in, w_out, corpus_dev, nk, na, k, ls, le, cfg.window, cfg.negatives,
            shared_negatives=cfg.shared_negatives,
            shared_impl=cfg.shared_impl)
    else:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

        need = P * MP
        assert len(jax.devices()) >= need, \
            f"w2vPartitions={P} x model_shards={MP} needs {need} devices, " \
            f"have {len(jax.devices())}"
        assert cfg.dim % MP == 0, f"dim={cfg.dim} not divisible by model_shards={MP}"
        mesh = Mesh(np.array(jax.devices()[:need]).reshape(P, MP), ("dp", "mp"))
        # corpus rows sharded over dp; embedding tables sharded over the dim
        # axis. With one dp row the corpus is replicated: a dp-sharded input
        # would mark the update as varying over dp while no psum over dp
        # follows, and the tables must come out replicated over dp.
        corpus_spec = PS("dp") if P > 1 else PS()
        corpus_dev = jax.device_put(
            jnp.asarray(padded.reshape(P, n_blocks, B, T)),
            NamedSharding(mesh, corpus_spec))
        table_sharding = NamedSharding(mesh, PS(None, "mp"))
        w_in = jax.device_put(w_in, table_sharding)
        w_out = jax.device_put(w_out, table_sharding)

        def dp_epoch(w_in, w_out, corpus_l, k, ls, le):
            # dp: per-block gradients psum-merged so every dp replica applies the
            # identical update; mp: tables are local [V, D/MP] slices, pair/negative
            # keys fold by the dp index ONLY so all mp shards of a dp row see the
            # same pairs and jointly compute each dot product (with one dp
            # row the index is the constant 0, for the same reason as above)
            my = jax.lax.axis_index("dp") if P > 1 else 0
            return _train_epoch(
                w_in, w_out, corpus_l[0], nk, na, jax.random.fold_in(k, my),
                ls, le, cfg.window, cfg.negatives,
                axis_name="dp" if P > 1 else None,
                dim_axis="mp" if MP > 1 else None,
                shared_negatives=cfg.shared_negatives,
                shared_impl=cfg.shared_impl)

        sm = jax.shard_map(
            dp_epoch, mesh=mesh,
            in_specs=(PS(None, "mp"), PS(None, "mp"), corpus_spec, PS(), PS(),
                      PS()),
            out_specs=(PS(None, "mp"), PS(None, "mp")))
        epoch = lambda w_in, w_out, k, ls, le: sm(
            w_in, w_out, corpus_dev, k, ls, le)

    # pre-fold epoch keys and use host scalars for lr: no eager device op runs
    # between the async epoch dispatches
    epoch_keys = {ep: jax.random.fold_in(key, ep)
                  for ep in range(start_epoch, cfg.iters)}
    if epoch_keys:
        jax.block_until_ready(list(epoch_keys.values()))
    for ep in range(start_epoch, cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        w_in, w_out = epoch(w_in, w_out, epoch_keys[ep],
                            np.float32(lr_s), np.float32(lr_e))
        if on_epoch is not None:
            on_epoch(ep, np.asarray(w_in), np.asarray(w_out))
    return np.asarray(w_in), np.asarray(w_out)


def _divisor_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    B = max(1, min(target, n))
    while n % B:
        B -= 1
    return B


def full_corpus_blocks(corpus: np.ndarray, num_devices: int | None = None
                       ) -> tuple[list[tuple[int, np.ndarray]], int]:
    """Wrap a fully-replicated host corpus as per-device (start, rows) blocks
    for THIS process's devices — the `--cmd embedding` multi-host path, where
    every host reads the same walks file (reference Main.scala:119-124) and
    the trainer scatters it. Returns (local blocks, padded global rows)."""
    import jax

    D = num_devices or jax.device_count()
    N, T = corpus.shape
    N_pad = -(-max(N, 1) // D) * D
    padded = corpus
    if N_pad != N:
        padded = np.concatenate(
            [corpus, np.full((N_pad - N, T), -1, dtype=corpus.dtype)])
    n = N_pad // D
    me = jax.process_index()
    blocks = [(d * n, padded[d * n:(d + 1) * n])
              for d, dev in enumerate(jax.devices()[:D])
              if dev.process_index == me]
    return blocks, N_pad


def _rows_from_blocks(blocks, lo: int, hi: int, T: int) -> np.ndarray:
    """Assemble global corpus rows [lo, hi) from this process's (start, rows)
    blocks; uncovered rows are -1 (never happens when blocks tile the range)."""
    out = np.full((hi - lo, T), -1, dtype=np.int32)
    for start, rows in blocks:
        s, e = max(lo, start), min(hi, start + len(rows))
        if e > s:
            out[s - lo:e - lo] = rows[s - start:e - start]
    return out


def train_skipgram_multiproc(
    blocks: list[tuple[int, np.ndarray]],
    num_rows: int,
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray | None = None,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_epoch: int = 0,
    on_epoch=None,
    num_devices: int | None = None,
    row_width: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Multi-process SGNS over a corpus that no process holds in full — the
    cluster-wide Word2Vec training of the reference (Main.scala:93,116), SPMD
    over jax.distributed (round-4 verdict missing item 2).

    Every process calls with identical (num_rows, cfg); `blocks` are this
    process's (global_row_start, rows [n, T]) — across all processes the
    blocks exactly tile the padded global corpus [num_rows, T] (all-(-1) rows
    are inert padding). The corpus becomes ONE global dp-sharded array via
    `jax.make_array_from_callback` (each process supplies only its addressable
    shards); dp = one slot per device, and the per-block psum-merged update
    keeps the tables replicated — quality is identical to single-process dp
    training, not the reference's quality-degrading per-iteration parameter
    averaging. Token counts for the negative table are computed on device from
    the global corpus (one psum'd bincount). model_shards > 1 (dim sharding)
    remains a single-process feature.

    Works unchanged with process_count == 1 (the parity baseline for the
    2-process test). Returns replicated (w_in, w_out) as host arrays."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    assert max(1, cfg.model_shards) == 1, \
        "model_shards > 1 is single-process only; use train_skipgram"
    D = num_devices or jax.device_count()
    assert num_rows % D == 0, (num_rows, D)
    n = num_rows // D
    # row_width must be GLOBALLY consistent: a process whose devices hold no
    # corpus blocks (possible with a sub-mesh) cannot derive it from its
    # (empty) block list — SPMD shape divergence would crash or deadlock
    T = row_width if row_width is not None else (
        blocks[0][1].shape[1] if blocks else 0)
    assert T > 0, "row_width is required on processes that hold no corpus blocks"
    # per-device block size must tile the device's rows exactly; stay close to
    # the single-process rule (global rows per merged update ~ cfg.row_block)
    B = _divisor_block(n, max(1, -(-cfg.row_block // D)))
    n_blocks = n // B
    mesh = Mesh(np.array(jax.devices()[:D]).reshape(D, 1), ("dp", "mp"))
    dp_sharding = NamedSharding(mesh, PS("dp"))

    def corpus_cb(idx):
        p = idx[0].start or 0
        rows = _rows_from_blocks(blocks, p * n, (p + 1) * n, T)
        return rows.reshape(1, n_blocks, B, T)

    corpus_dev = jax.make_array_from_callback(
        (D, n_blocks, B, T), dp_sharding, corpus_cb)

    if counts is None:
        @jax.jit
        def _count(c):
            flat = c.reshape(-1)
            ok = (flat >= 0).astype(jnp.float32)
            return jnp.zeros(vocab_size, jnp.float32).at[
                jnp.maximum(flat, 0)].add(ok)

        counts = np.asarray(_count(corpus_dev)).astype(np.float64)
    neg_keep, neg_alias = build_alias(np.maximum(counts, 1e-12) ** cfg.power)
    nk = np.asarray(neg_keep)
    na = np.asarray(neg_alias)

    key = jax.random.PRNGKey(cfg.seed)
    if init is not None:
        w_in = np.asarray(init[0], np.float32)
        w_out = np.asarray(init[1], np.float32)
    else:
        wi, wo = _init_embeddings(vocab_size, cfg.dim,
                                  jax.random.fold_in(key, 0x1A17))
        w_in, w_out = np.asarray(wi), np.asarray(wo)
    lr_lo = cfg.lr * cfg.min_lr_frac

    def dp_epoch(w_in, w_out, corpus_l, k, ls, le):
        my = jax.lax.axis_index("dp")
        return _train_epoch(
            w_in, w_out, corpus_l[0], nk, na, jax.random.fold_in(k, my),
            ls, le, cfg.window, cfg.negatives, axis_name="dp", dim_axis=None,
            shared_negatives=cfg.shared_negatives,
            shared_impl=cfg.shared_impl)

    sm = jax.jit(jax.shard_map(
        dp_epoch, mesh=mesh,
        in_specs=(PS(None, "mp"), PS(None, "mp"), PS("dp"), PS(), PS(), PS()),
        out_specs=(PS(None, "mp"), PS(None, "mp"))))
    epoch_keys = {ep: np.asarray(jax.random.key_data(
        jax.random.fold_in(key, ep))) for ep in range(start_epoch, cfg.iters)}

    def wrap_key(kd):
        return jax.random.wrap_key_data(jnp.asarray(kd))

    for ep in range(start_epoch, cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        w_in, w_out = sm(w_in, w_out, corpus_dev, wrap_key(epoch_keys[ep]),
                         np.float32(lr_s), np.float32(lr_e))
        if on_epoch is not None:
            on_epoch(ep, np.asarray(w_in), np.asarray(w_out))
    return np.asarray(w_in), np.asarray(w_out)


def train_skipgram_streaming(
    make_round,
    num_rounds: int,
    round_shape: tuple[int, int],
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray,
    on_round=None,
) -> tuple[np.ndarray, np.ndarray]:
    """SGNS over a corpus that never materializes fully: one walk ROUND at a time.

    The reference pipeline materializes the whole corpus before Word2Vec.fit
    (Main.scala:112-116); at LiveJournal defaults that is 10·|V| × 82 × 4B ≈ 13 GB
    — a large share of one card's memory next to the graph tables. Because walks are
    counter-based-deterministic, each round can be REGENERATED per epoch instead
    of stored: memory is one round's [W, L+2] buffer, and the realized corpus is
    bitwise identical to the stored-corpus path.

    make_round(r) -> jax.Array [W, T] (device-resident; -1 padded), called
    num_rounds times per epoch, identical output for the same r every epoch.
    counts: full-corpus token frequencies (host pre-pass; see node2vec).
    on_round(epoch, r, corpus_np) — optional tap (e.g. the CLI writes /path from
    the first epoch's rounds, so the walk files cost no extra generation).
    """
    W, T = round_shape
    neg_keep, neg_alias = build_alias(np.maximum(counts, 1e-12) ** cfg.power)
    nk = jnp.asarray(neg_keep)
    na = jnp.asarray(neg_alias)
    key = jax.random.PRNGKey(cfg.seed)
    w_in, w_out = _init_embeddings(vocab_size, cfg.dim,
                                   jax.random.fold_in(key, 0x1A17))
    B = max(1, min(cfg.row_block, W))
    n_blocks = -(-W // B)
    pad_rows = n_blocks * B - W
    lr_lo = cfg.lr * cfg.min_lr_frac
    total_slices = max(cfg.iters * num_rounds, 1)

    def lr_at(slice_idx: int) -> float:
        frac = slice_idx / total_slices
        return cfg.lr + (lr_lo - cfg.lr) * frac

    for ep in range(cfg.iters):
        kep = jax.random.fold_in(key, ep)
        for r in range(num_rounds):
            corpus_r = make_round(r)
            if on_round is not None:
                on_round(ep, r, corpus_r)
            if pad_rows:
                corpus_r = jnp.concatenate(
                    [corpus_r, jnp.full((pad_rows, T), -1, jnp.int32)])
            blocks = corpus_r.reshape(n_blocks, B, T)
            s = ep * num_rounds + r
            w_in, w_out = _train_epoch(
                w_in, w_out, blocks, nk, na, jax.random.fold_in(kep, r),
                np.float32(lr_at(s)), np.float32(lr_at(s + 1)),
                cfg.window, cfg.negatives,
                shared_negatives=cfg.shared_negatives,
                shared_impl=cfg.shared_impl)
    return np.asarray(w_in), np.asarray(w_out)


def sgns_loss(w_in, w_out, centers, contexts, negs) -> jax.Array:
    """Mean SGNS loss (monitoring / the jittable forward step exposed to the driver)."""
    vi = w_in[centers]
    targets = jnp.concatenate([contexts[:, None], negs], axis=1)
    vo = w_out[targets]
    logits = jnp.einsum("pd,pkd->pk", vi, vo)
    labels = jnp.concatenate(
        [jnp.ones_like(logits[:, :1]), jnp.zeros_like(logits[:, 1:])], axis=1)
    return jnp.mean(
        -labels * jax.nn.log_sigmoid(logits) - (1 - labels) * jax.nn.log_sigmoid(-logits))


def corpus_from_token_lists(token_lists) -> tuple[np.ndarray, list]:
    """Build (dense corpus, vocab tokens by desc frequency) from arbitrary token
    sequences — the `--cmd embedding` path that re-reads walks from disk
    (reference Main.scala:119-124); minCount=0, every token kept."""
    from collections import Counter
    cnt = Counter(t for row in token_lists for t in row)
    vocab = [t for t, _ in sorted(cnt.items(), key=lambda kv: (-kv[1], str(kv[0])))]
    index = {t: i for i, t in enumerate(vocab)}
    T = max((len(r) for r in token_lists), default=0)
    corpus = np.full((len(token_lists), T), -1, dtype=np.int32)
    for i, row in enumerate(token_lists):
        for j, t in enumerate(row):
            corpus[i, j] = index[t]
    return corpus, vocab


def corpus_from_ragged(values: np.ndarray,
                       offsets: np.ndarray) -> tuple[np.ndarray, list]:
    """Vectorized corpus_from_token_lists for integer tokens in ragged form
    (values i64[NT], offsets i64[NW+1] — graph/io.load_walks_ragged).

    Identical output contract: vocab ordered by descending frequency with
    str(token) tie-break, dense [N, T] i32 corpus (-1 padded). The per-token
    Python loops cost hours at the reference-default corpus (round-3 verdict
    weak item 6); this is np.unique + one masked assignment."""
    lengths = np.diff(offsets).astype(np.int64)
    N = len(lengths)
    T = int(lengths.max()) if N else 0
    uniq, inv, counts = np.unique(values, return_inverse=True,
                                  return_counts=True)
    order = sorted(range(len(uniq)),
                   key=lambda i: (-int(counts[i]), str(int(uniq[i]))))
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[np.asarray(order, dtype=np.int64)] = np.arange(len(uniq),
                                                        dtype=np.int32)
    corpus = np.full((N, T), -1, dtype=np.int32)
    if len(values):
        mask = np.arange(T, dtype=np.int64)[None, :] < lengths[:, None]
        corpus[mask] = rank[inv]
    vocab = [int(uniq[i]) for i in order]
    return corpus, vocab
