"""Host-side symbolic layer: orderings, elimination tree, sparsity patterns.

The port's own copy of ``aprilsam_tpu/solver/symbolic.py`` (pure numpy).

The reference interleaves symbolic and numeric work in C (heap min-degree
ordering, aprilsam.c:989-1249; CSparse cs_schol etree/counts, csparse.c:1693;
search-tree maintenance, aprilsam.c:599-987).  In both packages the split is strict:
this module owns all *structure* (pure host, numpy int arrays) while the
device owns all *numerics*.  A batch epoch fixes an ordering + block-sparse
pattern of R; incremental steps mutate only the rows of the ancestor-closed
"affected" set, whose patterns this module updates by a restricted symbolic
re-elimination.

Everything here works at NODE granularity (3x3 blocks).  Within a block the
reference's scalar elimination gives the theta row the union of the block's
scalar patterns, so block-level parents equal the reference's search-tree
parents (parent = block owning the first off-diagonal nonzero of the node's
last scalar row, search_tree_create_from_smat, aprilsam.c:635-652).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np


# ------------------------------------------------------------------ adjacency

def build_adjacency(nnodes: int, ftypes, fnodes) -> List[Set[int]]:
    """Node-level symbolic adjacency from the factor table (the reference
    builds the same structure as an smatd of ones, aprilsam.c:104-114)."""
    adj: List[Set[int]] = [set() for _ in range(nnodes)]
    for t, (a, b) in zip(ftypes, fnodes):
        if b >= 0:
            adj[a].add(b)
            adj[b].add(a)
        # single-node factors touch only the diagonal
    return adj


# ------------------------------------------------------------------ ordering

def min_degree_ordering(nnodes: int, adj: Sequence[Set[int]]) -> np.ndarray:
    """Fill-reducing ordering with the reference's "newest node last"
    constraint (heap_minimum_degree_ordering biases the most recent node to
    be eliminated last, aprilsam.c:1020-1035).

    Exact minimum degree with lazy re-evaluation (the same relaxation the
    reference uses: re-queue a node whose recorded degree is stale,
    aprilsam.c:1128-1235).  Pure python with a heap; replaced by the native C
    implementation (see aprilsam_tpu_torch/native).
    """
    import heapq

    if nnodes == 0:
        return np.zeros(0, dtype=np.int32)
    if nnodes == 1:
        return np.zeros(1, dtype=np.int32)

    last = nnodes - 1
    nbrs: List[Set[int]] = [set(s) for s in adj]
    for s in nbrs:
        s.discard(last)  # eliminate the newest node at the very end
    heap = [(len(nbrs[i]), i) for i in range(nnodes - 1)]
    heapq.heapify(heap)
    eliminated = np.zeros(nnodes, dtype=bool)
    order = np.empty(nnodes, dtype=np.int32)
    k = 0
    while heap:
        d, i = heapq.heappop(heap)
        if eliminated[i]:
            continue
        cur = len(nbrs[i])
        if cur > d:
            heapq.heappush(heap, (cur, i))  # stale degree; re-queue
            continue
        order[k] = i
        k += 1
        eliminated[i] = True
        ni = nbrs[i]
        for a in ni:
            na = nbrs[a]
            na.discard(i)
            for b in ni:
                if b != a and not eliminated[b]:
                    na.add(b)
        for a in ni:
            if not eliminated[a]:
                heapq.heappush(heap, (len(nbrs[a]), a))
        nbrs[i] = set()
    order[k] = last
    assert k == nnodes - 1
    return order


# ------------------------------------------------- symbolic factorization

@dataclass
class SymbolicState:
    """Structure of the current epoch: ordering + R block pattern + etree.

    positions (p) index elimination order; `order[p]` is the node id.
    patterns[p] is an ascending int32 array of column POSITIONS with
    patterns[p][0] == p (the diagonal block).
    """

    order: np.ndarray                  # [n] position -> node id
    pos: np.ndarray                    # [n] node id -> position
    patterns: List[np.ndarray]         # per-position column positions
    parents: np.ndarray                # [n] parent position or -1
    children: List[List[int]] = field(default_factory=list)

    @property
    def nnodes(self) -> int:
        return len(self.order)

    @property
    def max_row(self) -> int:
        return max((len(p) for p in self.patterns), default=0)

    def rebuild_children(self) -> None:
        self.children = [[] for _ in range(self.nnodes)]
        for p, par in enumerate(self.parents):
            if par >= 0:
                self.children[par].append(p)


def build_symbolic(nnodes: int, adj: Sequence[Set[int]], order: np.ndarray) -> SymbolicState:
    """Symbolic block Cholesky: R row patterns + etree for the given ordering.

    Standard row-merge elimination (what cs_schol's etree/column counts
    compute, csparse.c:906-935, but at block granularity): each row's
    off-diagonal pattern merges into its parent's row.
    """
    pos = np.empty(nnodes, dtype=np.int32)
    pos[order] = np.arange(nnodes, dtype=np.int32)

    rows: List[Set[int]] = [set() for _ in range(nnodes)]
    for i in range(nnodes):
        pi = int(pos[i])
        rows[pi].add(pi)
        for j in adj[i]:
            pj = int(pos[j])
            if pj > pi:
                rows[pi].add(pj)

    parents = np.full(nnodes, -1, dtype=np.int32)
    patterns: List[np.ndarray] = [None] * nnodes  # type: ignore
    for p in range(nnodes):
        s = sorted(rows[p])
        patterns[p] = np.asarray(s, dtype=np.int32)
        if len(s) > 1:
            parent = s[1]
            parents[p] = parent
            rows[parent].update(s[1:])
        rows[p] = None  # free

    sym = SymbolicState(order=order.astype(np.int32), pos=pos, patterns=patterns,
                        parents=parents)
    sym.rebuild_children()
    return sym


# ------------------------------------------------------------- incremental

def append_nodes(sym: SymbolicState, new_node_ids: Sequence[int]) -> None:
    """Extend the ordering with newly added nodes at the end (identity
    positions), reference: aprilsam.c:392-397.

    Amortized O(new): order/pos/parents live in geometrically-grown capacity
    buffers exposed as views (the naive per-step reallocation was O(n) and
    dominated host planning time at M3500 scale)."""
    n0 = sym.nnodes
    k = len(new_node_ids)
    cap = getattr(sym, "_cap", 0)
    if n0 + k > cap:
        newcap = max(1024, 2 * (n0 + k))
        obuf = np.empty(newcap, dtype=np.int32)
        pbuf = np.empty(newcap, dtype=np.int32)
        parbuf = np.empty(newcap, dtype=np.int32)
        obuf[:n0] = sym.order
        pbuf[:n0] = sym.pos
        parbuf[:n0] = sym.parents
        sym._obuf, sym._pbuf, sym._parbuf = obuf, pbuf, parbuf
        sym._cap = newcap
    for i, node in enumerate(new_node_ids):
        p = n0 + i
        sym._obuf[p] = node
        # new nodes are appended in id order, so pos[node] == p holds for
        # node == p (the replay always extends ids contiguously)
        sym._pbuf[node] = p
        sym._parbuf[p] = -1
        sym.patterns.append(np.asarray([p], dtype=np.int32))
        sym.children.append([])
    n1 = n0 + k
    sym.order = sym._obuf[:n1]
    sym.pos = sym._pbuf[:n1]
    sym.parents = sym._parbuf[:n1]


def mark_affected(sym: SymbolicState, touched_nodes: Sequence[int]) -> np.ndarray:
    """Affected set = union of paths from each touched node to the etree root
    (reference: aprilsam.c:482-498).  Ancestor-closed by construction; this is
    the property that makes the dense frontal update self-contained.

    Returns ascending position array F.
    """
    marked: Set[int] = set()
    for node in touched_nodes:
        p = int(sym.pos[node])
        while p not in marked:
            marked.add(p)
            par = int(sym.parents[p])
            if par < 0:
                break
            p = par
    return np.asarray(sorted(marked), dtype=np.int32)


def update_patterns_incremental(
    sym: SymbolicState,
    F: np.ndarray,
    new_block_edges: Sequence[Tuple[int, int]],
) -> List[int]:
    """Re-run symbolic elimination restricted to the affected positions F,
    after adding the new factor block entries.  Mirrors what the reference's
    reconstruct -> scatter-add -> refactor cycle does to R's sparsity
    (aprilsam.c:502-551): patterns only grow, and all growth stays inside F
    (columns of a row are its etree ancestors, which are affected).

    Mutates sym.patterns/parents/children for rows in F; returns the list of
    positions whose pattern changed.
    """
    fset = set(int(p) for p in F)
    rows: Dict[int, Set[int]] = {p: set(sym.patterns[p].tolist()) for p in fset}
    before = {p: len(rows[p]) for p in fset}

    for a, b in new_block_edges:
        pa = int(sym.pos[a])
        if b < 0:
            continue  # prior factors touch only the diagonal
        pb = int(sym.pos[b])
        lo, hi = (pa, pb) if pa < pb else (pb, pa)
        assert lo in fset and hi in fset, "factor endpoints must be affected"
        rows[lo].add(hi)

    changed: List[int] = []
    for p in sorted(fset):
        s = rows[p]
        others = sorted(c for c in s if c > p)
        parent = others[0] if others else -1
        old_parent = int(sym.parents[p])
        if parent != old_parent:
            if old_parent >= 0 and p in sym.children[old_parent]:
                sym.children[old_parent].remove(p)
            if parent >= 0:
                sym.children[parent].append(p)
            sym.parents[p] = parent
        if parent >= 0:
            assert parent in fset
            rows[parent].update(others)
        if len(s) != before[p]:
            changed.append(p)
            sym.patterns[p] = np.asarray(sorted(s), dtype=np.int32)

    return changed


def fringe_of(sym: SymbolicState, F: np.ndarray) -> np.ndarray:
    """Children of affected nodes that are not themselves affected — the
    nodes the reference's pruned back-substitution still visits (computes x,
    relinearization bookkeeping, delta_X) before pruning their subtrees
    (solve_node, aprilsam.c:741-772)."""
    fset = set(int(p) for p in F)
    fringe = []
    for p in fset:
        for c in sym.children[p]:
            if c not in fset:
                fringe.append(c)
    return np.asarray(sorted(fringe), dtype=np.int32)


def padded_pattern_arrays(sym: SymbolicState, cap_rows: int, cap_cols: int,
                          sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack patterns into a padded [cap_rows, cap_cols] int32 matrix (padding
    = sentinel) + per-row counts, the device mirror used by gather kernels."""
    idx = np.full((cap_rows, cap_cols), sentinel, dtype=np.int32)
    nnz = np.zeros(cap_rows, dtype=np.int32)
    for p, pat in enumerate(sym.patterns):
        k = len(pat)
        if k > cap_cols:
            raise OverflowError(
                f"row {p} has {k} blocks > capacity {cap_cols}; "
                "raise row_block_capacity"
            )
        idx[p, :k] = pat
        nnz[p] = k
    return idx, nnz
