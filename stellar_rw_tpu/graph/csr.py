"""Host-side CSR graph representation.

The counterpart of the reference's per-executor `GraphMap` singleton
(reference algorithm/GraphMap.scala:11-120): instead of a mutable JVM hashmap CSR filled
by side effect, the graph is built once on the host as dense, static-shape arrays and
uploaded to device HBM. Vertex ids are densified (original id -> contiguous index) so all
device arrays are flat i32/f32; `ids` maps back to original ids for output.

Neighbor lists are sorted by (dense dst id) so that prev-membership tests — the
`prevNeighbors.exists(_._1 == dstId)` linear scan in the reference sampler
(reference algorithm/RandomSample.scala:38) — become O(log deg) vectorized binary
searches on device. Multi-edges are preserved (the reference concatenates adjacency with
`reduceByKey(_ ++ _)`, it never dedups edges — UniformRandomWalk.scala:41).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

HASH_MAX_PROBES = 4
HASH_MULT = np.uint32(2654435761)  # Knuth multiplicative hash


@dataclass
class CSRGraph:
    """Static-shape CSR adjacency over densified vertex ids.

    offsets: i64[V+1]; cols: i32[E] (dense ids, sorted within each row);
    weights: f32[E]; ids: original id per dense index.
    """

    offsets: np.ndarray
    cols: np.ndarray
    weights: np.ndarray
    ids: np.ndarray
    # Alias tables for O(1) first-order (weight-proportional) draws, aligned with cols:
    # keep-probability and in-row alias position. Built lazily by build_alias_tables().
    alias_prob: np.ndarray | None = field(default=None, repr=False)
    alias_pos: np.ndarray | None = field(default=None, repr=False)
    # Per-vertex open-addressing membership tables (built by build_hash_tables):
    # the device-side prev-membership test probes <= HASH_MAX_PROBES slots instead of
    # a log2(max_degree)-deep binary search.
    hash_offsets: np.ndarray | None = field(default=None, repr=False)
    hash_mask: np.ndarray | None = field(default=None, repr=False)
    hash_table: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_vertices(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_edges(self) -> int:
        """Total stored arcs — matches the reference's nEdges accumulator semantics
        (sum of adjacency lengths; undirected graphs count each edge twice,
        UniformRandomWalk.scala:60-66)."""
        return len(self.cols)

    @property
    def degrees(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """(cols, weights) of dense vertex v. Empty arrays for dead-ends — the engine
        has no 'vertex unknown here' null case (GraphMap.scala:109-120); locality is a
        routing-table question, not a storage sentinel."""
        s, e = self.offsets[v], self.offsets[v + 1]
        return self.cols[s:e], self.weights[s:e]

    def build_alias_tables(self) -> None:
        """Vose alias tables per row over weight-normalized probabilities.

        Vectorized across all rows at once (O(E) passes, no per-row Python loop):
        classic two-stack Vose, but the stacks hold edge indices globally and rows are
        processed independently via per-row running pointers.
        """
        if self.alias_prob is not None:
            return
        E = self.num_edges
        try:  # native fast path (bit-identical output, tests/test_native.py)
            from .. import native
            if native.available():
                self.alias_prob, self.alias_pos = native.build_alias_rows(
                    self.offsets, self.weights)
                return
        except Exception:
            pass
        prob = np.ones(E, dtype=np.float32)
        alias = np.arange(E, dtype=np.int64)
        deg = self.offsets[1:] - self.offsets[:-1]
        # scaled[i] = w_i / row_sum * deg  (mean 1.0 per row)
        row_of = np.repeat(np.arange(self.num_vertices), deg)
        row_sum = np.zeros(self.num_vertices, dtype=np.float64)
        np.add.at(row_sum, row_of, self.weights.astype(np.float64))
        with np.errstate(invalid="ignore", divide="ignore"):
            scaled = (self.weights.astype(np.float64) /
                      np.where(row_sum[row_of] > 0, row_sum[row_of], 1.0)) * deg[row_of]

        # Uniform-weight rows (the common case: unweighted graphs) need no Vose at
        # all — scaled == 1 everywhere, so keep-prob 1 / identity alias. Detect them
        # vectorized and only run the per-row worklist on genuinely weighted rows.
        nonuniform = np.zeros(self.num_vertices, dtype=bool)
        if E:
            same_as_prev = np.ones(E, dtype=bool)
            same_as_prev[1:] = self.weights[1:] == self.weights[:-1]
            same_as_prev[np.clip(self.offsets[:-1], 0, max(E - 1, 0))] = True
            np.logical_or.at(nonuniform, row_of, ~same_as_prev)
        # (alias is already the identity and prob already 1.0 for untouched rows)

        # Per-row Vose. Rows are independent; iterate rows grouped to keep it numpy-light.
        for v in np.flatnonzero(nonuniform):
            s, e = int(self.offsets[v]), int(self.offsets[v + 1])
            if e - s <= 1:
                continue
            sc = scaled[s:e].copy()
            small = [i for i in range(e - s) if sc[i] < 1.0]
            large = [i for i in range(e - s) if sc[i] >= 1.0]
            while small and large:
                sm = small.pop()
                lg = large[-1]
                prob[s + sm] = sc[sm]
                alias[s + sm] = s + lg  # global index; converted to in-row below
                sc[lg] -= 1.0 - sc[sm]
                if sc[lg] < 1.0:
                    large.pop()
                    small.append(lg)
            for i in small + large:
                prob[s + i] = 1.0
        # store alias as in-row positions
        self.alias_prob = prob
        self.alias_pos = (alias - np.repeat(self.offsets[:-1], deg)).astype(np.int32) \
            if E else alias.astype(np.int32)

    def build_hash_tables(self, max_probes: int = HASH_MAX_PROBES) -> None:
        """Per-vertex open-addressing neighbor-set tables, concatenated flat.

        Replaces the reference's O(deg) linear `exists` membership scan
        (RandomSample.scala:38) with <= max_probes random accesses on device —
        cheaper than binary search, where each probe is a full-width gather.

        Built fully vectorized (no per-vertex Python loop — required at
        LiveJournal scale, millions of rows): all keys attempt probe slot i in a
        global round; first-writer-wins per slot; rows with any key still unplaced
        after max_probes rounds double their table and the layout is rebuilt (rare:
        load factor <= 0.5). Any layout where every key sits within max_probes of
        its hash is equally valid — device membership results are layout-independent.
        """
        if self.hash_table is not None:
            return
        V = self.num_vertices
        E = self.num_edges
        if V > 0 and max_probes == HASH_MAX_PROBES:
            try:  # native fast path (bit-identical layouts, tests/test_native.py)
                from .. import native
                if native.available():
                    self.hash_offsets, self.hash_mask, self.hash_table = \
                        native.build_hash_rows(self.offsets, self.cols)
                    return
            except Exception:
                pass
        if V == 0:
            self.hash_offsets = np.zeros(1, dtype=np.int64)
            self.hash_mask = np.zeros(0, dtype=np.int32)
            self.hash_table = np.full(8, -1, dtype=np.int32)
            return
        deg = (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)
        # unique neighbors per row: rows are sorted, so duplicates are adjacent
        if E:
            first = np.ones(E, dtype=bool)
            first[1:] = self.cols[1:] != self.cols[:-1]
            first[np.clip(self.offsets[:-1], 0, E - 1)] = True
            row_of = np.repeat(np.arange(V), deg)
            keys = self.cols[first].astype(np.int64)
            krow = row_of[first]
            udeg = np.zeros(V, dtype=np.int64)
            np.add.at(udeg, krow, 1)
        else:
            keys = np.zeros(0, dtype=np.int64)
            krow = np.zeros(0, dtype=np.int64)
            udeg = np.zeros(V, dtype=np.int64)
        # size = 8, doubled while size < 2*need (need = max(unique_deg, 1))
        need = np.maximum(udeg, 1)
        sizes = 2 ** np.maximum(np.ceil(np.log2(2 * need)).astype(np.int64), 3)
        h0 = ((keys.astype(np.uint64) * np.uint64(HASH_MULT))
              & np.uint64(0xFFFFFFFF)).astype(np.int64)
        while True:
            hoff = np.zeros(V + 1, dtype=np.int64)
            np.cumsum(sizes, out=hoff[1:])
            mask_k = (sizes - 1)[krow]
            base_k = hoff[:-1][krow]
            table = np.full(int(hoff[-1]), -1, dtype=np.int32)
            placed = np.zeros(len(keys), dtype=bool)
            for i in range(max_probes):
                cand = np.flatnonzero(~placed)
                if len(cand) == 0:
                    break
                slot = base_k[cand] + ((h0[cand] + i) & mask_k[cand])
                free = table[slot] == -1
                cand, slot = cand[free], slot[free]
                order = np.argsort(slot, kind="stable")
                slot_s, cand_s = slot[order], cand[order]
                win = np.ones(len(slot_s), dtype=bool)
                win[1:] = slot_s[1:] != slot_s[:-1]
                table[slot_s[win]] = keys[cand_s[win]].astype(np.int32)
                placed[cand_s[win]] = True
            if placed.all():
                break
            bad_rows = np.unique(krow[~placed])
            sizes[bad_rows] *= 2  # grow and rebuild (rare)
        self.hash_offsets = hoff
        self.hash_mask = (sizes - 1).astype(np.int32)
        self.hash_table = table


def from_adjacency(adj: dict[int, list[tuple[int, float]]]) -> CSRGraph:
    """Build a CSR from {orig_src: [(orig_dst, w), ...]}.

    Dense index order = insertion order of keys (mirrors the reference GraphMap's
    first-insert-wins indexing, GraphMap.scala:58-64). Every orig id appearing as a dst
    must already be a key (the loaders guarantee this, like the reference registers
    isolated dst vertices with empty adjacency — UniformRandomWalk.scala:37).
    Rows are sorted by dense dst id; multi-edges preserved.
    """
    ids = np.fromiter(adj.keys(), dtype=np.int64, count=len(adj))
    id_map = {int(orig): i for i, orig in enumerate(ids)}
    V = len(ids)
    deg = np.fromiter((len(adj[int(orig)]) for orig in ids), dtype=np.int64, count=V)
    offsets = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    E = int(offsets[-1])
    cols = np.empty(E, dtype=np.int32)
    weights = np.empty(E, dtype=np.float32)
    for i, orig in enumerate(ids):
        row = adj[int(orig)]
        s = offsets[i]
        if not row:
            continue
        dcols = np.fromiter((id_map[d] for d, _ in row), dtype=np.int32, count=len(row))
        dw = np.fromiter((w for _, w in row), dtype=np.float32, count=len(row))
        order = np.argsort(dcols, kind="stable")
        cols[s:s + len(row)] = dcols[order]
        weights[s:s + len(row)] = dw[order]
    return CSRGraph(offsets=offsets, cols=cols, weights=weights, ids=ids)


def from_edge_arrays(src: np.ndarray, dst: np.ndarray,
                     weights: np.ndarray | None = None,
                     num_vertices: int | None = None,
                     symmetrize: bool = False) -> CSRGraph:
    """Vectorized CSR construction from dense-id arc arrays (no Python loops).

    For large graphs (LiveJournal scale and beyond) where `from_adjacency`'s
    per-row dict walk is prohibitive. Vertex ids must already be dense
    [0, num_vertices); `ids` is the identity. `symmetrize=True` adds the reverse
    arc for every input arc (undirected load semantics — the reference's
    bidirectional insertion, UniformRandomWalk.scala:29-36). Multi-edges are
    preserved; rows come out sorted by dst id as the samplers require.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if weights is None:
        weights = np.ones(len(src), dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        weights = np.concatenate([weights, weights])
    V = int(num_vertices if num_vertices is not None
            else (max(src.max(initial=-1), dst.max(initial=-1)) + 1))
    if V and V < (1 << 31):  # packed single-key sort: ~2x faster than lexsort
        order = np.argsort(src * V + dst, kind="stable")
    else:
        order = np.lexsort((dst, src))
    src, dst, weights = src[order], dst[order], weights[order]
    deg = np.bincount(src, minlength=V).astype(np.int64)
    offsets = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    return CSRGraph(offsets=offsets, cols=dst.astype(np.int32),
                    weights=weights, ids=np.arange(V, dtype=np.int64))
