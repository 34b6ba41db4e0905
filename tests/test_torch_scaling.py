"""The port's scaling tools (aprilsam_tpu_torch.scaling_model, .scaling and
.schur_stages) against the JAX package's root scripts (scaling_model.py,
bench_scaling.py) on the CPU, in float64 unless named.

The scaling bench runs in one spawned gloo world of eight CPU processes
for the whole file; the JAX package solves on conftest.py's 8-device
virtual mesh.  JAX is imported inside the tests only, so the `gpu` test
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_scaling.py
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch import scaling, scaling_model
from aprilsam_tpu_torch.parallel import one_rank_group
from aprilsam_tpu_torch.parallel.dryrun import run_ranks
from aprilsam_tpu_torch.schur_stages import classify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_CASES = [(2048, 4), (4096, 8)]
BENCH = ["--device", "cpu", "--poses", "4000", "--blocks", "16"]
WORLD = 8
SIZES = (1, 2, 8)
# The bench's float64 solve against the JAX package's, at each mesh size
# (measured on the CPU: chi2 4113.4479 in both, 7.2e-10 apart relative;
# states 1.68e-7 apart in xy and 1.7e-9 in theta, the same at every size).
# The xy gap is the float64 rounding of the keyframe-block solve itself,
# which the two packages' arithmetic meets differently: against a float64
# Cholesky of the whole first-step system refined to a residual of 5e-14,
# the JAX package's first step is 2.1e-7 off in xy, the port's 1.8e-7
# (3.9e-7 apart), while one dense Cholesky of the whole system is 1.9e-9
# off; a stronger damping (tikhonov 1e-2) closes the gap to 1.3e-10
# (tests/schur_rounding.py prints these).  So xy is held to twice the JAX
# package's own first-step error; theta and chi2 to about six and seven
# times their measured gaps.
TOL = {"xy": 4e-7, "theta": 1e-8, "chi2_rel": 5e-9}
# SCALING.md section 2: MB per Gauss-Newton iteration at 100 000 poses by
# (ndev, separator mode), from the JAX script on 8 virtual devices
SCALING_MD_MB = {(2, "replicated"): 0.41, (2, "pchol"): 2.36,
                 (4, "replicated"): 1.97, (4, "pchol"): 6.82,
                 (8, "replicated"): 4.12, (8, "pchol"): 5.77}
# the card's float64 bench against the CPU port's, relative in chi2
GPU_CHI2_REL = 1e-8


def _jax_script(name: str):
    """A root script of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xy_theta(a, b):
    """Largest xy and theta (mod 2pi) differences of two state tables."""
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return float(np.max(np.abs(a[:, :2] - b[:, :2]))), float(np.max(dth))


def _run(module, *argv, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("sep_dist", [False, True])
@pytest.mark.parametrize("poses,ndev", MODEL_CASES)
def test_comm_volume_matches_jax(poses, ndev, sep_dist):
    """Counts and bytes of every collective kind equal the JAX script's,
    but for the interiors' all-gather (B/D * ni_max * 3 float32) and the
    sentinel slot (4 B) of each all-reduced flat vector: S_flat and c_flat
    replicated, c_flat in pchol mode."""
    J = _jax_script("scaling_model")
    jpart, jhits = J.comm_volume(poses, ndev, sep_dist)
    part, hits = scaling_model.comm_volume(poses, ndev, sep_dist)
    assert (part.ns, part.ni_max, part.B) == (jpart.ns, jpart.ni_max, ndev)
    want = {k: list(v) for k, v in jhits.items()}
    want["all-reduce"][1] += 4 * (1 if sep_dist else 2)
    want["interiors"] = [1, part.B // ndev * part.ni_max * 3 * 4]
    assert hits == want


def test_model_rows_at_100k_match_scaling_md():
    """The port's rows at SCALING.md's 100 000 poses: the totals without
    the interiors' gather are SCALING.md's; the partition sizes are the
    JAX script's (ns 107, 234, 338)."""
    g = scaling_model.scaling_graph(100000)
    rows = scaling_model.model_rows(g)
    assert [(r["ndev"], r["sep"]) for r in rows] == list(SCALING_MD_MB)
    for r in rows:
        assert r["total_MB_per_gn"] == SCALING_MD_MB[r["ndev"], r["sep"]]
        assert r["ns"] == {2: 107, 4: 234, 8: 338}[r["ndev"]]
        assert r["interiors"]["count"] == 1


def test_mesh_sizes_are_the_jax_scripts():
    """{1, max(2, N // 4), N}, each dividing the block count, none above
    the world (the JAX script would solve make_mesh(2) on one device)."""
    assert scaling.mesh_sizes(8, 16) == [1, 2, 8]
    assert scaling.mesh_sizes(4, 8) == [1, 2, 4]
    assert scaling.mesh_sizes(1, 64) == [1]
    assert scaling.mesh_sizes(8, 12) == [1, 2]
    assert scaling.mesh_sizes(16, 64) == [1, 4, 16]


@pytest.fixture(scope="module")
def port_bench():
    """Each rank's bench_rank result on a spawned world of WORLD gloo
    ranks."""
    args = scaling.build_parser().parse_args(BENCH)
    return run_ranks(scaling.bench_rank, WORLD, args, timeout=900)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX script's solves of the same graph at SIZES, float64."""
    from aprilsam_tpu.datasets import manhattan_world
    from aprilsam_tpu.parallel.dist import make_mesh
    from aprilsam_tpu.parallel.schur import partition_graph, schur_solve

    g = manhattan_world(4000, seed=0, closure_prob=0.04, block=25,
                        max_closures_per_pose=1)
    part = partition_graph(g, 16)
    out = {"chi2_initial": g.chi2()}
    for k in SIZES:
        st = schur_solve(make_mesh(k), g, part, gn_iters=2, dtype=np.float64)
        out[k] = {"states": st, "chi2": scaling.graph_chi2(g, st)}
    return out


@pytest.mark.parametrize("ndev", SIZES)
def test_scaling_bench_matches_jax(port_bench, jax_bench, ndev):
    """At each mesh size the port's states and final chi2 are the JAX
    package's (TOL); every rank of the size's group returns the same
    arrays and the ranks outside it none."""
    head = port_bench[0]
    assert head["world"] == WORLD and head["dtype"] == "float64"
    assert sorted(head["sizes"]) == list(SIZES)
    assert head["chi2_initial"] == pytest.approx(jax_bench["chi2_initial"],
                                                 rel=1e-12)
    got, want = head["sizes"][ndev], jax_bench[ndev]
    xy, th = _xy_theta(got["states"], want["states"])
    assert xy <= TOL["xy"] and th <= TOL["theta"], (xy, th)
    rel = abs(got["chi2"] - want["chi2"]) / want["chi2"]
    assert rel <= TOL["chi2_rel"], (got["chi2"], want["chi2"])
    for r, res in enumerate(port_bench):
        if r < ndev:
            np.testing.assert_array_equal(res["sizes"][ndev]["states"],
                                          got["states"])
            assert res["sizes"][ndev]["chi2"] == got["chi2"]
        else:
            assert ndev not in res["sizes"]


def test_scaling_cli_on_four_ranks():
    """The entry point spawns its ranks and ends with the JAX script's
    JSON line."""
    lines = _run("aprilsam_tpu_torch.scaling", "--device", "cpu", "--ranks",
                 "4", "--poses", "2000", "--blocks", "8", "--json")
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "schur_scaling_efficiency"
    assert last["unit"] == "(poses=2000, devices=4)"
    assert np.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == pytest.approx(last["value"] / 0.7,
                                                abs=2e-3)
    sizes = [ln.split(":")[0] for ln in lines if ln.startswith("ndev=")]
    assert sizes == ["ndev=1", "ndev=2", "ndev=4"]
    assert any(ln.startswith("scaling efficiency at 4 devices") and "NOTE"
               in ln for ln in lines)


def test_scaling_model_cli_prints_six_rows():
    lines = _run("aprilsam_tpu_torch.scaling_model", "--poses", "2048")
    rows = [json.loads(ln) for ln in lines]
    assert [(r["ndev"], r["sep"]) for r in rows] == [
        (d, s) for d in (2, 4, 8) for s in ("replicated", "pchol")]
    for r in rows:
        assert r["poses"] == 2048 and r["collectives"]["all-reduce"]["count"]
        assert r["interiors"]["kind"] == "all-gather"


def test_schur_stages_cli_on_the_cpu():
    """The stage profile at a small size: exits 0, ends with the JAX
    script's JSON, and its stages sum to the profiled iteration within
    10 % (the rest is host time between operations)."""
    lines = _run("aprilsam_tpu_torch.schur_stages", "--device", "cpu",
                 "--poses", "2000", "--blocks", "8")
    last, detail = json.loads(lines[-1]), json.loads(lines[-2])
    assert {"poses", "blocks", "ns", "ni_max", "platform", "t_total_s",
            "t_per_gn_s", "final_chi2"} <= set(last)
    assert last["platform"] == "cpu" and np.isfinite(last["final_chi2"])
    prof = detail["profile"]
    total = sum(s["ms"] for s in prof["stages"].values())
    assert total == pytest.approx(prof["busy_ms"])
    assert abs(total - prof["iteration_ms"]) <= 0.1 * prof["iteration_ms"]
    for stage in ("assembly", "interior Cholesky", "triangular solves",
                  "Schur update", "separator solve", "back-substitution"):
        assert prof["stages"][stage]["launches"] > 0, stage
    assert [r["ndev"] for r in detail["projection"]] == [1, 2, 4, 8]
    assert detail["bound"].keys() == {"operations", "bytes"}


@pytest.mark.parametrize("rng,op,name,stage", [
    ("schur.assemble", "aten::index_add_", "indexFuncLargeIndex",
     "assembly"),
    ("schur.eliminate", "aten::linalg_cholesky_ex", "potrf_kernel",
     "interior Cholesky"),
    # cuSOLVER's own GEMMs inside the factorization stay with it
    ("schur.eliminate", "aten::linalg_cholesky_ex", "sm90_xmma_gemm_f64",
     "interior Cholesky"),
    ("schur.eliminate", "aten::linalg_solve_triangular", "trsm_kernel",
     "triangular solves"),
    ("schur.eliminate", "aten::matmul", "sm90_xmma_gemm_f64",
     "Schur update"),
    ("schur.eliminate", "aten::mul_", "elementwise_kernel", "other"),
    ("schur.separator", "c10d::allreduce_",
     "ncclDevKernel_AllReduce_Sum_f64_RING_LL", "separator reduction"),
    ("schur.separator", "aten::linalg_cholesky_ex", "potrf_kernel",
     "separator solve"),
    ("schur.backsub", "aten::linalg_solve_triangular", "trsv_kernel",
     "back-substitution"),
    ("schur.backsub", "c10d::_allgather_base_",
     "ncclDevKernel_AllGather_RING_LL", "interiors gather"),
    ("schur.gn_step", "aten::copy_", "Memcpy DtoH", "other"),
])
def test_stage_classification(rng, op, name, stage):
    """Kernels are placed by their range and the operation that launched
    them, so a library's internal kernels stay with their call."""
    assert classify(rng, op, name) == stage


@pytest.mark.gpu
def test_scaling_on_the_card_matches_the_cpu():
    """The bench at 4000 poses and 16 blocks on one NCCL rank, float64,
    against the CPU port's chi2 (GPU_CHI2_REL); more ranks than cards
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bench runs NCCL on cards")
    parser = scaling.build_parser()
    cpu_args = parser.parse_args(BENCH + ["--dtype", "float64"])
    card_args = parser.parse_args(BENCH[2:] + ["--dtype", "float64"])
    with one_rank_group("cuda") as mesh:
        card = scaling.bench_rank(mesh, card_args)
    with one_rank_group("cpu") as mesh:
        cpu = scaling.bench_rank(mesh, cpu_args)
    assert list(card["sizes"]) == [1]
    rel = abs(card["sizes"][1]["chi2"] - cpu["sizes"][1]["chi2"]) \
        / cpu["sizes"][1]["chi2"]
    assert rel <= GPU_CHI2_REL, rel
    too_many = parser.parse_args(
        BENCH[2:] + ["--ranks", str(torch.cuda.device_count() + 1)])
    with pytest.raises(ValueError, match="cards"):
        scaling.run(too_many)
