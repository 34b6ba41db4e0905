"""The distributed solves across several cards, one NCCL rank per card,
against the JAX package's multi-device golden (golden/multicard_jax.npz).

Every test here carries the `gpu` marker, counts the cards inside the test
and skips below two.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them (the tests directory's conftest imports
JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_multicard_gpu.py
"""

import json

import pytest
import torch

from aprilsam_tpu_torch import scaling
from aprilsam_tpu_torch.multicard import (BENCH_TOL, Spec, check,
                                          multicard_rank, read_golden)
from aprilsam_tpu_torch.parallel.dryrun import run_ranks


def _cards(n: int) -> None:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} cards, one NCCL rank each; this machine "
                    f"has {have}")


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_on_cards_matches_jax(ranks):
    """The dry run at D = ranks on as many NCCL ranks: each separator
    mode's states and the dp dx norm within the golden's bounds, and the
    same bytes on every rank."""
    _cards(ranks)
    spec = Spec(sizes=(ranks,), graphs=(), bench_dtypes=(), stages=False)
    results = run_ranks(multicard_rank, ranks, spec, timeout=600.0,
                        device="cuda")
    summary, bad = check(results, read_golden())
    assert not bad, bad
    row = summary["dryrun"][ranks]
    assert row["replicated_ranks_identical"]
    assert row["distributed_ranks_identical"]


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [2, 4])
def test_scaling_bench_on_cards(ranks, capsys):
    """scaling.main(["--ranks", N, "--json"]) spawns one NCCL rank per card
    and ends with the JAX script's JSON line, its unit naming the card and
    the link; the bench's final chi2 in float32 and float64 at every mesh
    size within BENCH_TOL of the golden."""
    _cards(ranks)
    assert scaling.main(["--ranks", str(ranks), "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["value"] > 0
    assert f"devices={ranks}" in last["unit"] and "link=" in last["unit"]
    golden = read_golden()
    ndev = [int(k) for k in golden["bench_ndev"]]
    for dt in ("float32", "float64"):
        args = scaling.build_parser().parse_args(
            ["--ranks", str(ranks), "--dtype", dt])
        res = scaling.run(args)[0]
        assert sorted(res["sizes"]) == scaling.mesh_sizes(ranks, 64)
        for k, v in res["sizes"].items():
            want = float(golden[f"bench_chi2_{dt}"][ndev.index(k)])
            assert abs(v["chi2"] - want) / want <= BENCH_TOL[dt], (dt, k)
