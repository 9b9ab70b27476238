"""Sparse neighborhood-aggregate primitives: SpMM, SDDMM, degree-normalized variants.

The reference has no GNN layer, but BASELINE.json's north star requires "generic sparse
gather/scatter and neighborhood-aggregate primitives (SpMM/SDDMM) so walk corpora feed
GNN-style layers". These are the XLA formulations (gather + segment-sum over the edge
axis — bandwidth-bound, fully fused by XLA; the random per-arc feature-row
gather is the expected bound). Their rate on the GPU is not measured yet.

Conventions: graphs are the CSR arrays of graph/csr.py (dense vertex ids). All ops are
jittable and differentiable (pure gathers/scatters).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class EdgeStructure(NamedTuple):
    """Edge-axis view of a CSR graph for segment ops (static shapes)."""

    row: jax.Array      # i32[E] source of each stored arc
    col: jax.Array      # i32[E] destination of each stored arc
    weight: jax.Array   # f32[E]
    num_vertices: int

    @classmethod
    def from_csr(cls, graph) -> "EdgeStructure":
        deg = np.asarray(graph.offsets[1:] - graph.offsets[:-1])
        row = np.repeat(np.arange(graph.num_vertices, dtype=np.int32), deg)
        return cls(row=jnp.asarray(row), col=jnp.asarray(graph.cols, dtype=jnp.int32),
                   weight=jnp.asarray(graph.weights, dtype=jnp.float32),
                   num_vertices=graph.num_vertices)


def spmm(es: EdgeStructure, x: jax.Array, weighted: bool = True) -> jax.Array:
    """Y = A @ X: for each vertex u, sum over neighbors v of w_uv * x_v.
    x: [V, D] -> [V, D]."""
    msgs = x[es.col]
    if weighted:
        msgs = msgs * es.weight[:, None]
    # CSR edge order makes es.row sorted — declaring it lets XLA lower the
    # scatter as a segmented reduction instead of a generic scatter-add
    return jax.ops.segment_sum(msgs, es.row, num_segments=es.num_vertices,
                               indices_are_sorted=True)


def spmm_mean(es: EdgeStructure, x: jax.Array) -> jax.Array:
    """Degree-normalized aggregate (mean over neighbors; zero rows for isolates)."""
    s = spmm(es, x, weighted=False)
    deg = jax.ops.segment_sum(jnp.ones_like(es.weight), es.row,
                              num_segments=es.num_vertices,
                              indices_are_sorted=True)
    return s / jnp.maximum(deg, 1.0)[:, None]


def sddmm(es: EdgeStructure, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sampled dense-dense matmul: per stored arc (u, v), s_e = <x_u, y_v>.
    x, y: [V, D] -> [E]."""
    return jnp.einsum("ed,ed->e", x[es.row], y[es.col])


def sddmm_softmax(es: EdgeStructure, scores: jax.Array) -> jax.Array:
    """Row-wise (per source vertex) softmax over edge scores — the attention
    normalization pattern (GAT-style) built from segment ops."""
    smax = jax.ops.segment_max(scores, es.row, num_segments=es.num_vertices,
                               indices_are_sorted=True)
    ex = jnp.exp(scores - smax[es.row])
    ssum = jax.ops.segment_sum(ex, es.row, num_segments=es.num_vertices,
                               indices_are_sorted=True)
    return ex / jnp.maximum(ssum[es.row], 1e-30)


def gather_rows(es: EdgeStructure, x: jax.Array, which: str = "col") -> jax.Array:
    """Generic sparse gather: features of each arc endpoint ([E, D])."""
    idx = es.col if which == "col" else es.row
    return x[idx]


def scatter_add_rows(es: EdgeStructure, msgs: jax.Array, which: str = "row") -> jax.Array:
    """Generic sparse scatter: accumulate per-arc messages onto vertices ([V, D])."""
    idx = es.row if which == "row" else es.col
    return jax.ops.segment_sum(msgs, idx, num_segments=es.num_vertices,
                               indices_are_sorted=(which == "row"))
