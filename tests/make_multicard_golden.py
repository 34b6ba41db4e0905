"""Make the golden of the JAX package's multi-device figures that the port's
multi-card runs are held to (``chip_smoke.py`` phase 17,
``tests/test_torch_multicard.py``, ``tests/test_torch_multicard_gpu.py``).

The JAX package runs on its virtual CPU mesh (8 host devices, float64
enabled, as ``tests/conftest.py`` sets them up):

    JAX_PLATFORMS=cpu python tests/make_multicard_golden.py \
        --out aprilsam_tpu_torch/golden/multicard_jax.npz

The file holds, for D = 2 and D = 4 devices:
  * the dry run (``__graft_entry__.py:dryrun_multichip``'s problems):
    ``dryrun{D}_dp_dx_norm``, the norm of ``dp_batch_solve``'s dx on
    ``_small_problem(16, seed=1)`` in float32, and ``dryrun{D}_replicated``
    and ``dryrun{D}_distributed``, the float32 ``schur_solve`` states
    (gn_iters=1) of ``manhattan_world(512 * D, seed=3, closure_prob=0.2,
    block=25)`` in D blocks with the replicated separator and the
    block-cyclic one at 128-scalar blocks, stored as float32;
and ``bench_chi2_float64`` / ``bench_chi2_float32``, the final chi2 of
``bench_scaling.py`` at its defaults (20 000 poses, 64 blocks, closure
0.04, two Gauss-Newton iterations) on meshes of ``bench_ndev`` = 1, 2, 4
devices.  ``meta_json`` holds the command, the configuration and the
seconds each part took.  The JAX package's 100 000-pose solve is not in
it: its float64 interior factors alone are 11 GB, too large for a CPU
run beside other work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_DEVICES = (2, 4)
BENCH_NDEV = (1, 2, 4)
BENCH = dict(poses=20000, blocks=64, closure_prob=0.04, gn_iters=2)
COMMAND = ("JAX_PLATFORMS=cpu python tests/make_multicard_golden.py "
           "--out aprilsam_tpu_torch/golden/multicard_jax.npz")


def jax_dryrun(D: int) -> dict:
    """The JAX package's dry run pieces on a mesh of D devices: the dp
    solve's dx norm and the 512*D-pose float32 states in both separator
    modes."""
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from __graft_entry__ import _small_problem
    from aprilsam_tpu.datasets import manhattan_world
    from aprilsam_tpu.parallel.dist import (dp_batch_solve, make_mesh,
                                            shard_factor_tables)
    from aprilsam_tpu.parallel.schur import partition_graph, schur_solve
    from aprilsam_tpu.utils import setup_precision

    setup_precision()
    mesh = make_mesh(D)
    n, dt = 16, jnp.float32
    states, a, b, z, W = _small_problem(n, seed=1)
    a, b, z, W, valid = shard_factor_tables(
        D, a, b, z, W, np.ones(a.shape[0], dtype=bool))
    x, _y, _L = dp_batch_solve(
        mesh, jnp.asarray(states, dt), jnp.asarray(states, dt),
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(z, dt), jnp.asarray(W, dt), jnp.asarray(valid),
        jnp.zeros((D,), jnp.int32), jnp.zeros((D, 3), dt),
        jnp.zeros((D, 3, 3), dt), jnp.zeros((D,), dtype=bool),
        MB=n, tikhonov=1e-2)
    g = manhattan_world(512 * D, seed=3, closure_prob=0.2, block=25)
    part = partition_graph(g, D)
    return {
        "dp_dx_norm": float(np.linalg.norm(np.asarray(x, np.float64))),
        "replicated": schur_solve(mesh, g, part, gn_iters=1,
                                  dtype=np.float32),
        "distributed": schur_solve(mesh, g, part, gn_iters=1,
                                   dtype=np.float32, sep_dist=True,
                                   sep_block=128),
    }


def jax_bench_chi2(dtype, ndevs=BENCH_NDEV) -> list:
    """bench_scaling.py's final chi2 at its defaults on each mesh size."""
    from aprilsam_tpu.datasets import manhattan_world
    from aprilsam_tpu.parallel.dist import make_mesh
    from aprilsam_tpu.parallel.schur import partition_graph, schur_solve

    g = manhattan_world(BENCH["poses"], seed=0,
                        closure_prob=BENCH["closure_prob"], block=25,
                        max_closures_per_pose=1)
    part = partition_graph(g, BENCH["blocks"])
    s0 = g.state.copy()
    out = []
    for k in ndevs:
        g.state[: g.nnodes] = schur_solve(make_mesh(k), g, part,
                                          gn_iters=BENCH["gn_iters"],
                                          dtype=dtype)
        out.append(float(g.chi2()))
        g.state[:] = s0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    arrays, seconds = {}, {}
    for D in DRYRUN_DEVICES:
        t = time.perf_counter()
        res = jax_dryrun(D)
        seconds[f"dryrun{D}"] = time.perf_counter() - t
        arrays[f"dryrun{D}_dp_dx_norm"] = np.float64(res["dp_dx_norm"])
        for mode in ("replicated", "distributed"):
            arrays[f"dryrun{D}_{mode}"] = res[mode].astype(np.float32)
        print(f"dry run at D={D}: dx norm {res['dp_dx_norm']!r} "
              f"({seconds[f'dryrun{D}']:.1f} s)", flush=True)
    arrays["bench_ndev"] = np.asarray(BENCH_NDEV, dtype=np.int64)
    for dtype in (np.float64, np.float32):
        name = np.dtype(dtype).name
        t = time.perf_counter()
        chi2 = jax_bench_chi2(dtype)
        seconds[f"bench_{name}"] = time.perf_counter() - t
        arrays[f"bench_chi2_{name}"] = np.asarray(chi2, dtype=np.float64)
        print(f"bench {name}: chi2 {chi2!r} at ndev {BENCH_NDEV} "
              f"({seconds[f'bench_{name}']:.1f} s)", flush=True)
    meta = {"command": COMMAND, "jax": jax.__version__,
            "devices": len(jax.devices()), "dryrun_devices": DRYRUN_DEVICES,
            "dryrun": {"dp": "_small_problem(16, seed=1), float32, "
                             "tikhonov 1e-2",
                       "schur": "manhattan_world(512 * D, seed=3, "
                                "closure_prob=0.2, block=25), D blocks, "
                                "gn_iters=1, float32, sep_block=128"},
            "bench": {**BENCH, "graph": "block=25, max_closures_per_pose=1",
                      "ndev": BENCH_NDEV},
            "seconds": seconds}
    np.savez_compressed(args.out, meta_json=np.asarray(json.dumps(meta)),
                        **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
