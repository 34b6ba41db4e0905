"""Make the golden of the JAX package's 100 000-pose distributed solve that
the port's card runs of it are held to (``chip_smoke.py`` phases 12, 16 and
17, the bench's ``manhattan100k-schur-4card-f64`` cell through
``multicard.check``, and ``tests/test_torch_multicard.py``).

The JAX package runs ``schur_solve(make_mesh(1), g, partition_graph(g, 64),
gn_iters=2, dtype=d)`` on the CPU with float64 enabled, at its defaults
otherwise (the separator mode it selects is recorded), in float64 and in
float32, on each of the two 100 000-pose graphs the card solves:

  * ``manhattan``: ``manhattan_world(100000, seed=0, closure_prob=0.02)``
    (phase 12, phase 17 and the 4-card cell);
  * ``scaling``: the same with ``block=25, max_closures_per_pose=1``
    (``schur_stages.py``'s graph: phase 16's stage profile and phase 17).

    JAX_PLATFORMS=cpu python tests/make_schur100k_golden.py \
        --out aprilsam_tpu_torch/golden/schur100k_jax.npz

It took 2329 s on an 8-core CPU that also ran a JAX replay (the float64
solves 218 and 1024 s, the float32 ones 546 and 517 s; the meta records
each) and held 20 GB resident at its peak, most of it the float64
interior factors.  Keep it out of the tier-1 tests.

The file holds, per graph ``{name}``: ``{name}_chi2_float64`` and
``{name}_chi2_float32``, the final chi2 of each solve (float64 scalars), and
``{name}_states_float64``, the float64 states of every ``SAMPLE_EVERY``-th
pose ([1000, 3]); ``meta_json`` holds the command, the graphs' arguments,
the blocks, ``gn_iters``, the separator mode of each solve, the JAX version
and the seconds each solve took.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

GRAPHS = {
    "manhattan": dict(n_poses=100000, seed=0, closure_prob=0.02),
    "scaling": dict(n_poses=100000, seed=0, closure_prob=0.02, block=25,
                    max_closures_per_pose=1),
}
BLOCKS, GN_ITERS, SAMPLE_EVERY = 64, 2, 100
COMMAND = ("JAX_PLATFORMS=cpu python tests/make_schur100k_golden.py "
           "--out aprilsam_tpu_torch/golden/schur100k_jax.npz")


def jax_solve(g, part, dtype) -> tuple:
    """JAX's schur_solve of g on one device; (states, separator mode)."""
    from aprilsam_tpu.parallel.dist import make_mesh
    from aprilsam_tpu.parallel.schur import schur_solve

    mesh = make_mesh(1)
    # schur_solve's own choice at sep_dist=None, sep_block=128
    dist = part.ns > 0 and 3 * part.ns >= 4 * 128 * 1
    states = schur_solve(mesh, g, part, gn_iters=GN_ITERS, dtype=dtype)
    return states, "distributed" if dist else "replicated"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--graphs", nargs="+", default=list(GRAPHS),
                    choices=list(GRAPHS))
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from aprilsam_tpu.datasets import manhattan_world
    from aprilsam_tpu.parallel.schur import partition_graph

    arrays, seconds, modes = {}, {}, {}
    for name in args.graphs:
        g = manhattan_world(**GRAPHS[name])
        part = partition_graph(g, BLOCKS)
        s0 = g.state.copy()
        for dtype in (np.float64, np.float32):
            dt = np.dtype(dtype).name
            t = time.perf_counter()
            states, modes[f"{name}_{dt}"] = jax_solve(g, part, dtype)
            seconds[f"{name}_{dt}"] = time.perf_counter() - t
            g.state[: g.nnodes] = states
            arrays[f"{name}_chi2_{dt}"] = np.float64(g.chi2())
            if dtype is np.float64:
                arrays[f"{name}_states_float64"] = np.asarray(
                    states[::SAMPLE_EVERY], np.float64)
            g.state[:] = s0
            print(f"{name} {dt}: chi2 {float(arrays[f'{name}_chi2_{dt}'])!r}"
                  f" ({modes[f'{name}_{dt}']} separator, "
                  f"{seconds[f'{name}_{dt}']:.1f} s)", flush=True)
        del g, part
    meta = {"command": COMMAND, "jax": jax.__version__,
            "graphs": {k: GRAPHS[k] for k in args.graphs},
            "blocks": BLOCKS, "gn_iters": GN_ITERS,
            "sample_every": SAMPLE_EVERY, "separator": modes,
            "seconds": seconds}
    np.savez_compressed(args.out, meta_json=np.asarray(json.dumps(meta)),
                        **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
