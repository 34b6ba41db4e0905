"""The multi-card run of the distributed solves (aprilsam_tpu_torch/multicard.py)
on gloo ranks of the CPU, against the JAX package's multi-device golden
(aprilsam_tpu_torch/golden/multicard_jax.npz, made by
tests/make_multicard_golden.py), to the bounds chip_smoke.py phase 17 holds
the cards to; the golden against the JAX package recomputed; the stage
profile on two ranks; and the process group's timeout.  multicard.check
against the JAX package's 100 000-pose golden
(aprilsam_tpu_torch/golden/schur100k_jax.npz, made by
tests/make_schur100k_golden.py) on synthetic results, and that golden's
graphs against the constants of chip_smoke.py and bench.py; marked slow
(not in tier 1), the port's 100 000-pose solves on the CPU against it.

One spawned world of four gloo ranks serves the file.  The spawned ranks
import this module, so JAX and the JAX package are imported inside the
tests only:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_multicard.py -q
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from aprilsam_tpu_torch import scaling_model
from aprilsam_tpu_torch.multicard import (BENCH_TOL, DRYRUN_TOL, JAX_TOL,
                                          SAMPLE_EVERY, SOLVE_TOL, Spec,
                                          check, hold_to_jax, jax_entry,
                                          multicard_rank, read_golden,
                                          read_schur_golden, state_diff)
from aprilsam_tpu_torch.parallel.dryrun import run_ranks
from aprilsam_tpu_torch.parallel.schur import (default_sep_dist,
                                               partition_graph)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# the golden's 20 000-pose bench in float64; small graphs for the solves
# against one rank and the batch solver
SPEC = Spec(sizes=(1, 2, 4),
            graphs=(("small", dict(n_poses=2000, seed=0,
                                   closure_prob=0.02)),),
            blocks=8, bench_dtypes=("float64",), stages=False)
STAGES = ["--device", "cpu", "--ranks", "2", "--poses", "2000",
          "--blocks", "8"]


@pytest.fixture(scope="module")
def world():
    """multicard_rank's results on each rank of a spawned gloo world, and
    check's summary and failures against the golden."""
    results = run_ranks(multicard_rank, WORLD, SPEC, device="cpu",
                        timeout=900)
    summary, bad = check(results, read_golden())
    return results, summary, bad


def test_world_passes_every_check(world):
    """Nothing that phase 17 holds the cards to fails on gloo ranks."""
    _results, _summary, bad = world
    assert bad == []


@pytest.mark.parametrize("k", [2, 4])
def test_dryrun_matches_the_golden(world, k):
    """The dry run on k gloo ranks against the JAX package's on k devices:
    each separator mode within DRYRUN_TOL, the dx norm within relative
    1e-3, the states the same bytes on every rank."""
    row = world[1]["dryrun"][k]
    assert row["dx_rel"] <= DRYRUN_TOL["dx_rel"]
    for mode in ("replicated", "distributed"):
        assert row[mode]["xy"] <= DRYRUN_TOL["xy"], row[mode]
        assert row[mode]["theta"] <= DRYRUN_TOL["theta"], row[mode]
        assert row[f"{mode}_ranks_identical"]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["replicated", "distributed"])
def test_solve_matches_one_rank(world, k, dt, mode):
    """schur_solve on k ranks against one rank (SOLVE_TOL), float64 also
    against the host BatchSolver; every rank's states the same bytes."""
    row = world[1]["solves"][f"small-{dt}-{mode}-{k}"]
    assert row["vs_one_rank"]["norm"] <= SOLVE_TOL[dt]["states"]
    assert row["chi2_rel_vs_one_rank"] <= SOLVE_TOL[dt]["chi2_rel"]
    assert row["ranks_identical"]
    if dt == "float64":
        assert row["chi2_rel_vs_batch"] <= 1e-5


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bench_matches_the_golden(world, k):
    """The scaling bench at its defaults (20 000 poses, 64 blocks) in
    float64 at each mesh size against the JAX package's chi2 there."""
    row = world[1]["bench"]["float64"][k]
    assert row["chi2_rel"] <= BENCH_TOL["float64"], row
    assert row["ranks_identical"]


def test_results_are_host_values(world):
    """Only host values come back from the ranks; rank 0 alone carries
    the dry run's states; no rank launched K1."""
    results = world[0]
    assert [r["rank"] for r in results] == list(range(WORLD))
    for r in results:
        assert r["tri_inv_launches"] == {}
        for k, dry in r["dryrun"].items():
            assert ("states" in dry) == (r["rank"] == 0)

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert not isinstance(x, torch.Tensor)

    walk(results)


@pytest.fixture(scope="module")
def jax_dryrun2():
    from make_multicard_golden import jax_dryrun

    return jax_dryrun(2)


def test_golden_dryrun_is_jax_recomputed(jax_dryrun2):
    """The golden's D = 2 dry run is the JAX package's, recomputed here
    (the states stored as float32)."""
    golden = read_golden()
    assert golden["meta"]["dryrun_devices"] == [2, 4]
    assert float(golden["dryrun2_dp_dx_norm"]) == pytest.approx(
        jax_dryrun2["dp_dx_norm"], rel=1e-12)
    for mode in ("replicated", "distributed"):
        want = golden[f"dryrun2_{mode}"]
        assert want.dtype == np.float32 and want.shape == (1024, 3)
        np.testing.assert_array_equal(jax_dryrun2[mode].astype(np.float32),
                                      want)


def test_schur_stages_on_two_ranks():
    """schur_stages --ranks 2 on gloo: every rank's table has the
    separator reduction and the interiors' gather; the collectives each
    rank counted equal scaling_model's trace of the same partition, and
    its JSON row but for the interiors' gather, which the row lists
    apart."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m",
                          "aprilsam_tpu_torch.schur_stages", *STAGES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    detail, last = json.loads(lines[-2]), json.loads(lines[-1])
    assert last["ranks"] == 2 and np.isfinite(last["final_chi2"])
    assert [m["ndev"] for m in detail["measured"]] == [1, 2]
    for k, ranks in detail["by_size"].items():
        assert len(ranks) == int(k)
        for res in ranks:
            for stage in ("separator reduction", "interiors gather"):
                assert res["profile"]["stages"][stage]["launches"] > 0
    g = scaling_model.scaling_graph(2000)
    part = partition_graph(g, 8)
    for k, c in detail["collectives"].items():
        k = int(k)
        sep = default_sep_dist(part, k)
        hits = scaling_model.trace_collectives(g, part, k, sep)
        assert c["equal"]
        for counted in c["counted"]:
            assert {kind: list(v) for kind, v in counted.items()} == \
                {kind: list(v) for kind, v in hits.items()}
        row = scaling_model.row(2000, k, sep, part, hits)
        kinds = {kind: v for kind, v in c["counted"][0].items()
                 if kind != "interiors"}
        assert row["collectives"] == {
            kind: {"count": n, "MB": round(b / 1e6, 2)}
            for kind, (n, b) in sorted(kinds.items())}
        assert row["interiors"]["count"] == c["counted"][0]["interiors"][0]


def _raise_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(1), group=mesh.group)


def _stall_rank_1(mesh):
    """Rank 1 sleeps past the collective timeout while rank 0 waits in a
    collective."""
    if mesh.rank == 1:
        time.sleep(120)
    dist.all_reduce(torch.ones(1), group=mesh.group)


def test_a_rank_that_raises_fails_the_world():
    """The world fails at once with the raising rank's traceback; the
    rank that waits in its collective is ended."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        run_ranks(_raise_on_rank_1, 2, device="cpu", timeout=120,
                  collective_timeout=60)
    assert "rank 1 gives up" in str(err.value)
    assert time.monotonic() - t < 40


def test_collective_timeout_fails_a_stuck_world():
    """init_group's timeout: a collective that waits longer than it raises
    on its rank, and the world fails well before the stalled rank wakes."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        run_ranks(_stall_rank_1, 2, device="cpu", timeout=120,
                  collective_timeout=3)
    assert time.monotonic() - t < 60


def _synthetic_world(entry: dict, dt: str, chi2: float, sampled) -> list:
    """multicard_rank's result of one rank that solved the golden's graph
    in `dt` to `chi2`, its states of every SAMPLE_EVERY-th pose `sampled`
    (the rest of the states are not looked at)."""
    key = ("manhattan", dt, "distributed", 1)
    return [{"rank": 0, "world": 1, "device": "cpu", "dryrun": {},
             "batch": {}, "seconds": {}, "graphs": {"manhattan":
                                                    entry["graph"]},
             "blocks": entry["blocks"],
             "solves": {key: {"ms_per_iter": 1.0, "runs_s": [],
                              "peak_bytes": None, "digest": "",
                              "finite": True, "chi2": chi2,
                              "sampled": sampled}}}]


@pytest.mark.parametrize("dt,off,passes", [
    ("float64", None, True), ("float64", "chi2", False),
    ("float64", "state", False), ("float32", None, True),
    ("float32", "chi2", False)])
def test_check_holds_the_100k_solve_to_jax(dt, off, passes):
    """multicard.check on a result at the golden's chi2 and sampled states
    passes; one twice the bound off in chi2, or one pose of the sample
    off by twice the states bound, fails (the 4-card cell's gate and
    phases 12, 16 and 17 read the same hold)."""
    golden = read_schur_golden()
    entry = golden["schur"]["manhattan"]
    chi2 = entry["chi2"][dt]
    sampled = entry["states"].copy()
    if off == "chi2":
        chi2 *= 1 + 2 * JAX_TOL[dt]["chi2_rel"]
    elif off == "state":
        sampled[500, 0] += 2 * JAX_TOL[dt]["states"] * (
            1 + np.max(np.abs(entry["states"])))
    summary, bad = check(_synthetic_world(entry, dt, chi2, sampled), golden)
    row = summary["solves"][f"manhattan-{dt}-distributed-1"]["vs_jax"]
    assert row["chi2_jax"] == entry["chi2"][dt]
    assert (bad == []) == passes, bad
    if off == "state":
        assert row["states"]["norm"] > JAX_TOL[dt]["states"]
    # a graph the golden does not hold is not held to it
    other = _synthetic_world(dict(entry, graph=dict(entry["graph"],
                                                    n_poses=2000)),
                             dt, 2 * chi2, sampled)
    summary, bad = check(other, golden)
    assert bad == [] and "vs_jax" not in summary["solves"][
        f"manhattan-{dt}-distributed-1"]


def test_schur_golden_matches_the_card_constants():
    """The golden's graphs, blocks and Gauss-Newton iterations are those
    phase 12 (SCHUR_*), phase 16 (STAGES_*), phase 17 (multicard.Spec)
    and the 4-card cell (bench.SCHUR_BLOCKS, CELLS) solve, so that the two
    cannot drift apart; it holds each graph's float64 and float32 chi2 and
    its float64 states of every SAMPLE_EVERY-th pose."""
    import importlib.util

    from aprilsam_tpu_torch import bench

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    golden = read_schur_golden()
    meta = golden["schur_meta"]
    assert meta["blocks"] == smoke.SCHUR_BLOCKS == smoke.STAGES_BLOCKS \
        == bench.SCHUR_BLOCKS == Spec.blocks == 64
    assert meta["gn_iters"] == smoke.SCHUR_GN == smoke.STAGES_GN == 2
    assert meta["sample_every"] == SAMPLE_EVERY
    assert meta["graphs"] == {"manhattan": smoke.SCHUR_GRAPH,
                              "scaling": smoke.STAGES_GRAPH}
    assert dict(Spec.graphs) == meta["graphs"]
    cell = bench.CELLS[bench.SCHUR]
    assert meta["graphs"]["manhattan"] == dict(
        n_poses=cell.poses, seed=0, closure_prob=0.02)
    assert set(meta["separator"].values()) == {"distributed"}
    for name in meta["graphs"]:
        entry = jax_entry(golden, meta["graphs"][name], 64)
        assert entry is golden["schur"][name]
        assert entry["states"].shape == (100000 // SAMPLE_EVERY, 3)
        assert np.all(np.isfinite(entry["states"]))
        assert min(entry["chi2"].values()) > 0


@pytest.fixture(scope="module")
def solves100k():
    """The port's one-rank 100 000-pose solves of the golden's graphs on
    the CPU: float64 in both separator modes and float32; on the first
    graph also float64 at gn_iters=1.  {graph: {solve: (chi2, states of
    every SAMPLE_EVERY-th pose)}}."""
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.parallel import one_rank_group
    from aprilsam_tpu_torch.parallel.schur import schur_solve
    from aprilsam_tpu_torch.scaling import graph_chi2

    golden = read_schur_golden()["schur"]
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    solves = (("float64-replicated", np.float64, False, 2),
              ("float64-distributed", np.float64, True, 2),
              ("float32-distributed", np.float32, True, 2))
    out = {}
    with one_rank_group("cpu") as mesh:
        for name, entry in golden.items():
            g = manhattan_world(**entry["graph"])
            part = partition_graph(g, entry["blocks"])
            extra = (("float64-gn1", np.float64, True, 1),) \
                if name == "manhattan" else ()
            out[name] = {}
            for solve, dt, sep, gn in solves + extra:
                st = schur_solve(mesh, g, part, gn_iters=gn, dtype=dt,
                                 sep_dist=sep)
                out[name][solve] = (graph_chi2(g, st), st[::SAMPLE_EVERY])
                print(name, solve, out[name][solve][0], flush=True)
            del g, part
    torch.set_num_threads(threads)
    return golden, out


@pytest.mark.slow
@pytest.mark.parametrize("graph", ["manhattan", "scaling"])
@pytest.mark.parametrize("solve", ["float64-replicated",
                                   "float64-distributed",
                                   "float32-distributed"])
def test_port_100k_solve_matches_jax(solves100k, graph, solve):
    """The port's 100 000-pose solve on the CPU against the JAX package's
    golden, to the bounds the card is held to (JAX_TOL)."""
    golden, out = solves100k
    row, bad = hold_to_jax(golden[graph], solve.split("-")[0],
                           *out[graph][solve])
    print(graph, solve, row)
    assert bad == []


@pytest.mark.slow
def test_jax_bounds_catch_the_controls(solves100k):
    """The controls fail the bounds: one Gauss-Newton iteration against
    the golden's two, and the float32 states against the float64
    golden."""
    golden, out = solves100k
    entry = golden["manhattan"]
    row, bad = hold_to_jax(entry, "float64", *out["manhattan"]["float64-gn1"])
    print("gn_iters=1", row)
    assert row["chi2_rel"] > JAX_TOL["float64"]["chi2_rel"]
    assert row["states"]["norm"] > JAX_TOL["float64"]["states"]
    for graph, e in golden.items():
        d = state_diff(out[graph]["float32-distributed"][1], e["states"])
        print(graph, "float32 states", d)
        assert d["norm"] > JAX_TOL["float64"]["states"]
