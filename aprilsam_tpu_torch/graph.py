"""Factor-graph model, host side (the port's own copy of
``aprilsam_tpu/graph.py``; the port imports nothing of the JAX package).

Re-design of the reference's pointer-based graph
(reference: aprilsam/aprilsam.h:63-179, aprilsam/april_graph.c): instead of
per-node/per-factor heap objects with vtables, the graph is a struct-of-arrays
builder.  Node states live in one [N,3] array; factors live in one parallel
table (type, endpoints, z, W) in insertion order, so "factors added since the
last solve" is a contiguous tail slice — exactly what the incremental solver
consumes — and batched factor evaluation is a single vmapped kernel.

Node kinds supported: xyt (SE(2) pose, 3 DOF) — the only node type in the
reference.  Factor kinds: FACTOR_XYT (relative pose, 2 nodes,
reference: april_graph_xyt.c:276-298) and FACTOR_XYTPOS (absolute prior,
1 node, reference: april_graph_xytpos.c:191-211).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .geometry import np_mod2pi

FACTOR_XYT = 1      # reference: aprilsam.h:91 APRIL_GRAPH_FACTOR_XYT_TYPE
FACTOR_XYTPOS = 2   # reference: aprilsam.h:92 APRIL_GRAPH_FACTOR_XYTPOS_TYPE

_GROW = 1024


@dataclass
class Attributes:
    """String-keyed attribute bag (reference: april_graph_attr_t,
    aprilsam.h:46-61).  Values are (stype_name, python value) pairs so the
    serializer can round-trip them; unknown types round-trip as raw bytes."""

    data: Dict[str, Any] = field(default_factory=dict)

    def put(self, stype_name: str, key: str, value: Any) -> None:
        self.data[key] = (stype_name, value)

    def get(self, key: str, default=None):
        item = self.data.get(key)
        return default if item is None else item[1]

    def __len__(self):
        return len(self.data)


class FactorGraph:
    """Growable SoA factor graph.  All numeric storage is float64 numpy on the
    host; the solver copies (and down-casts, if configured) to device arrays.
    """

    def __init__(self):
        self._nodes_cap = _GROW
        self.state = np.zeros((self._nodes_cap, 3), dtype=np.float64)
        self.init = np.zeros((self._nodes_cap, 3), dtype=np.float64)
        self.truth = np.zeros((self._nodes_cap, 3), dtype=np.float64)
        self.l_point = np.zeros((self._nodes_cap, 3), dtype=np.float64)
        self.delta_X = np.zeros((self._nodes_cap, 3), dtype=np.float64)
        self.has_init = np.zeros(self._nodes_cap, dtype=bool)
        self.has_truth = np.zeros(self._nodes_cap, dtype=bool)
        self.nnodes = 0

        self._factors_cap = _GROW
        self.ftype = np.zeros(self._factors_cap, dtype=np.int32)
        # endpoints; fnodes[f,1] == -1 for single-node factors
        self.fnodes = np.full((self._factors_cap, 2), -1, dtype=np.int32)
        self.fz = np.zeros((self._factors_cap, 3), dtype=np.float64)
        self.fztruth = np.zeros((self._factors_cap, 3), dtype=np.float64)
        self.has_ztruth = np.zeros(self._factors_cap, dtype=bool)
        self.fW = np.zeros((self._factors_cap, 3, 3), dtype=np.float64)
        self.nfactors = 0
        self.nf_xyt = 0     # running FACTOR_XYT count (all additions go
                            # through add_factor_* / add_factors_xyt_bulk;
                            # saves an O(nfactors) scan per solver step)

        self.attr = Attributes()
        self.node_attrs: Dict[int, Attributes] = {}
        self.factor_attrs: Dict[int, Attributes] = {}

    # ------------------------------------------------------------- nodes

    def _grow_nodes(self):
        if self.nnodes < self._nodes_cap:
            return
        self._nodes_cap *= 2
        for name in ("state", "init", "truth", "l_point", "delta_X"):
            arr = getattr(self, name)
            new = np.zeros((self._nodes_cap, 3), dtype=np.float64)
            new[: arr.shape[0]] = arr
            setattr(self, name, new)
        for name in ("has_init", "has_truth"):
            arr = getattr(self, name)
            new = np.zeros(self._nodes_cap, dtype=bool)
            new[: arr.shape[0]] = arr
            setattr(self, name, new)

    def add_node(self, state, init=None, truth=None) -> int:
        """Add an xyt node.  l_point is initialized to state
        (reference: april_graph_node_xyt_create, april_graph_xyt.c:420-438)."""
        self._grow_nodes()
        i = self.nnodes
        self.state[i] = state
        self.l_point[i] = state
        if init is not None:
            self.init[i] = init
            self.has_init[i] = True
        if truth is not None:
            self.truth[i] = truth
            self.has_truth[i] = True
        self.nnodes += 1
        return i

    # ----------------------------------------------------------- factors

    def _grow_factors(self, need: int = 1):
        if self.nfactors + need <= self._factors_cap:
            return
        while self.nfactors + need > self._factors_cap:
            self._factors_cap *= 2

        def grow(arr, shape):
            new = np.zeros(shape, dtype=arr.dtype)
            if arr.dtype == np.int32 and arr.ndim == 2:
                new[:] = -1
            new[: arr.shape[0]] = arr
            return new

        self.ftype = grow(self.ftype, (self._factors_cap,))
        self.fnodes = grow(self.fnodes, (self._factors_cap, 2))
        self.fz = grow(self.fz, (self._factors_cap, 3))
        self.fztruth = grow(self.fztruth, (self._factors_cap, 3))
        self.has_ztruth = grow(self.has_ztruth, (self._factors_cap,))
        self.fW = grow(self.fW, (self._factors_cap, 3, 3))

    def add_factor_xyt(self, a: int, b: int, z, W, ztruth=None) -> int:
        """Relative-pose factor between nodes a and b
        (reference: april_graph_factor_xyt_create, april_graph_xyt.c:276)."""
        self._grow_factors()
        f = self.nfactors
        self.ftype[f] = FACTOR_XYT
        self.fnodes[f] = (a, b)
        self.fz[f] = z
        self.fW[f] = W
        if ztruth is not None:
            self.fztruth[f] = ztruth
            self.has_ztruth[f] = True
        self.nfactors += 1
        self.nf_xyt += 1
        return f

    def add_factors_xyt_bulk(self, ab, z, W) -> int:
        """Append m xyt factors in one shot: ab [m, 2] int endpoints,
        z [m, 3], W [m, 3, 3].  Returns the first new factor index.
        Equivalent to m add_factor_xyt calls (the replay driver batches a
        pose's factors to keep the per-step host cost flat)."""
        m = len(ab)
        if m == 0:
            return self.nfactors
        self._grow_factors(m)
        f = self.nfactors
        self.ftype[f:f + m] = FACTOR_XYT
        self.fnodes[f:f + m] = ab
        self.fz[f:f + m] = z
        self.fW[f:f + m] = W
        self.nfactors += m
        self.nf_xyt += m
        return f

    def add_factor_xytpos(self, node: int, z, W, ztruth=None) -> int:
        """Absolute pose prior ("geopin") on a single node
        (reference: april_graph_factor_xytpos_create, april_graph_xytpos.c:191)."""
        self._grow_factors()
        f = self.nfactors
        self.ftype[f] = FACTOR_XYTPOS
        self.fnodes[f] = (node, -1)
        self.fz[f] = z
        self.fW[f] = W
        if ztruth is not None:
            self.fztruth[f] = ztruth
            self.has_ztruth[f] = True
        self.nfactors += 1
        return f

    # ------------------------------------------------------------- views

    @property
    def states(self) -> np.ndarray:
        return self.state[: self.nnodes]

    @property
    def l_points(self) -> np.ndarray:
        return self.l_point[: self.nnodes]

    def factor_slices(self, lo: int = 0, hi: Optional[int] = None):
        """Return (types, nodes, z, W) for factors in [lo, hi)."""
        hi = self.nfactors if hi is None else hi
        return (
            self.ftype[lo:hi],
            self.fnodes[lo:hi],
            self.fz[lo:hi],
            self.fW[lo:hi],
        )

    # -------------------------------------------------------------- dof

    def dof(self) -> int:
        """Degrees of freedom: sum(factor len) - sum(node len)
        (reference: april_graph_dof, april_graph.c:58-77)."""
        return 3 * self.nfactors - 3 * self.nnodes

    # ------------------------------------------------------------- chi2

    def chi2(self) -> float:
        """Total graph error, evaluated at the current states, replicating the
        reference convention exactly: xyt factors contribute 0.5 * r'Wr while
        xytpos factors contribute 1.0 * r'Wr
        (reference: april_graph_chi2, april_graph.c:79-98).

        Host (numpy, float64) implementation; the solver has a fused on-device
        twin (factors.graph_chi2) used during replay.
        """
        total = 0.0
        n = self.nfactors
        if n == 0:
            return total
        types = self.ftype[:n]
        nodes = self.fnodes[:n]
        z = self.fz[:n]
        W = self.fW[:n]
        st = self.state

        m_xyt = types == FACTOR_XYT
        if np.any(m_xyt):
            a = nodes[m_xyt, 0]
            b = nodes[m_xyt, 1]
            sa = st[a]
            sb = st[b]
            ca, si = np.cos(sa[:, 2]), np.sin(sa[:, 2])
            dx = sb[:, 0] - sa[:, 0]
            dy = sb[:, 1] - sa[:, 1]
            zhat = np.stack(
                [ca * dx + si * dy, -si * dx + ca * dy, sb[:, 2] - sa[:, 2]],
                axis=-1,
            )
            r = z[m_xyt] - zhat
            r[:, 2] = np_mod2pi(r[:, 2])
            Wr = np.einsum("fij,fj->fi", W[m_xyt], r)
            total += 0.5 * float(np.sum(r * Wr))

        m_pos = types == FACTOR_XYTPOS
        if np.any(m_pos):
            a = nodes[m_pos, 0]
            r = z[m_pos] - st[a]
            r[:, 2] = np_mod2pi(r[:, 2])
            Wr = np.einsum("fij,fj->fi", W[m_pos], r)
            total += float(np.sum(r * Wr))

        return total
