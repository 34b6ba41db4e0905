"""TORO/g2o-style text dataset loader (VERTEX2 / EDGE2 lines); the port's
own copy of ``aprilsam_tpu/io/g2o.py``.

Replicates the reference demo loader exactly
(reference: convert_datafile_to_graph, examples/aprilsam_demo.c:52-99):

  VERTEX2 id x y theta
  EDGE2 a b dx dy dtheta I11 I12 I22 I33 I13 I23

Quirks preserved on purpose:
  * the information matrix is filled upper-triangle only - entries
    (0,0) (0,1) (1,1) (2,2) (0,2) (1,2); the lower triangle stays zero
    (the C code reuses one zeroed matd and never writes data[3,6,7],
    aprilsam_demo.c:60,73-75).  chi2 and assembly use W as stored.
  * node state == init == truth == the VERTEX2 value (aprilsam_demo.c:65-69).
  * factors with |a - b| == 1 are tagged "odom", others "scan"
    (aprilsam_demo.c:83-87); the replay driver uses the tag to seed new
    node states by odometry composition.
"""

from __future__ import annotations

import numpy as np

from ..graph import Attributes, FactorGraph


def load_g2o_text(path: str) -> FactorGraph:
    g = FactorGraph()
    with open(path, "r") as f:
        tokens = f.read().split()
    i = 0
    n = len(tokens)
    while i < n:
        kind = tokens[i]
        if kind == "VERTEX2":
            x, y, t = (float(v) for v in tokens[i + 2 : i + 5])
            g.add_node((x, y, t), init=(x, y, t), truth=(x, y, t))
            i += 5
        elif kind == "EDGE2":
            a = int(tokens[i + 1])
            b = int(tokens[i + 2])
            vals = [float(v) for v in tokens[i + 3 : i + 12]]
            z = vals[0:3]
            i11, i12, i22, i33, i13, i23 = vals[3:9]
            W = np.zeros((3, 3), dtype=np.float64)
            W[0, 0] = i11
            W[0, 1] = i12
            W[1, 1] = i22
            W[2, 2] = i33
            W[0, 2] = i13
            W[1, 2] = i23
            fidx = g.add_factor_xyt(a, b, z, W)
            attrs = Attributes()
            attrs.put("string", "type", "odom" if abs(b - a) == 1 else "scan")
            g.factor_attrs[fidx] = attrs
            i += 12
        else:
            raise ValueError(f"unrecognized record {kind!r} at token {i} of {path}")
    return g
