"""Save/load round trip with attributes, the counterpart of the reference's
aprilsam_graph_save_simple.c and aprilsam_graph_save_with_attributes.c and
of the JAX package's examples/graph_save_load.py.

Writes a small graph (with graph/node/factor attributes) to the binary
`.graph` stype format, reads it back, prints the contents, and solves the
loaded problem with a batch step on --device.  The format is
byte-compatible with the C implementation and with the JAX package.

Run:  python -m aprilsam_tpu_torch.examples.graph_save_load \
          [--device cpu] [path.graph]
"""

import argparse
import os
import tempfile

import numpy as np

from aprilsam_tpu_torch import BatchSolver, FactorGraph, SolverConfig
from aprilsam_tpu_torch.graph import Attributes
from aprilsam_tpu_torch.io import load_graph_file, save_graph_file


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "example.graph"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path = args.path

    g = FactorGraph()
    g.add_node([5.0, 6.0, 0.4], init=[5.0, 6.0, 0.4], truth=[5.1, 6.1, 0.39])
    g.add_node([6.0, 6.1, 0.4])
    g.add_factor_xyt(0, 1, [1.0, 0.1, 0.0], np.diag([100.0, 100.0, 300.0]))
    g.add_factor_xytpos(0, [5.0, 6.0, 0.4], np.diag([1e4, 1e4, 1e3]))

    # attributes (reference: april_graph_attr_put with uint64/string stypes)
    g.attr.put("string", "robot", "wanderer-1")
    g.attr.put("uint64", "session", 42)
    fa = Attributes()
    fa.put("string", "type", "odom")
    g.factor_attrs[0] = fa

    save_graph_file(g, path)
    print(f"saved {g.nnodes} nodes, {g.nfactors} factors -> {path}")

    g2 = load_graph_file(path)
    print(f"loaded {g2.nnodes} nodes, {g2.nfactors} factors")
    print("node 0 state:", g2.states[0], "truth:", g2.truth[0])
    print("graph attrs:", {k: v[1] for k, v in g2.attr.data.items()})
    print("factor 0 tag:", g2.factor_attrs[0].get("type"))
    print("chi2:", g2.chi2())

    solver = BatchSolver(SolverConfig(node_capacity=256, factor_capacity=1024,
                                      row_block_capacity=48, panel_nodes=32),
                         device=args.device)
    info = solver.solve(g2)
    print(f"solved on {solver.device}: chi2 {info.chi2:f}")


if __name__ == "__main__":
    main()
