"""The port stands alone: no module of aprilsam_tpu_torch, and none of the
chip scripts (chip_smoke.py, profile_torch_replay.py,
profile_panel_epochs.py), imports JAX or the JAX package;
its entry points run on the card unless asked for the CPU; the throughput
settings, bundles and device batch epochs run on the CPU."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch import bench, cli, large_inc, scaling, schur_stages
from aprilsam_tpu_torch.datasets import manhattan_world
from aprilsam_tpu_torch.io import save_graph_file
from aprilsam_tpu_torch.replay import Replay
from aprilsam_tpu_torch.solver import (BatchSolver, IncrementalSolver,
                                       SolverConfig)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "aprilsam_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return sorted(mods)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("geometry", "graph", "io.g2o", "io.stype", "datasets",
              "solver.config",
              "utils.timeprofile", "utils.cache", "utils.build", "native",
              "solver.symbolic", "factors",
              "kernels.linalg3", "solver.state", "solver.ingest",
              "solver.batch", "solver.host_batch", "kernels.tri_inv",
              "kernels.frontal_qr",
              "kernels.assembly", "solver.panel_epoch",
              "kernels.sweep", "solver.incremental", "replay", "cli",
              "checkpoint", "parallel", "parallel.dist", "parallel.pchol",
              "parallel.schur", "parallel.dryrun", "examples.tutorial",
              "examples.graph_save_load", "examples.distributed_solve",
              "large_inc", "scaling", "scaling_model", "schur_stages",
              "utils.card", "multicard", "bench", "utils.trace"):
        assert f"aprilsam_tpu_torch.{m}" in mods, m
    for src in ("tri_inv.cu", "frontal_qr.cu"):
        assert os.path.exists(os.path.join(PKG, "csrc", src))


def test_no_jax_at_runtime():
    """Import every port module and the chip scripts in a fresh
    interpreter: neither jax nor any module of aprilsam_tpu may be loaded
    (the prefix aprilsam_tpu also matches aprilsam_tpu_torch, so names are
    compared exactly)."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, os, sys
        for m in {_port_modules()!r}:
            importlib.import_module(m)
        for script in ("chip_smoke", "profile_torch_replay",
                       "profile_panel_epochs"):
            spec = importlib.util.spec_from_file_location(
                script, os.path.join({REPO!r}, script + ".py"))
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith(("jax.", "jaxlib"))
                     or n == "aprilsam_tpu" or n.startswith("aprilsam_tpu."))
        print("BAD", bad)
        print("PORT", sum(n.startswith("aprilsam_tpu_torch")
                          for n in sys.modules))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("PORT")[1]) >= len(_port_modules())


def test_port_sources_do_not_name_jax_imports():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                for bad in ("import jax", "from jax", "from aprilsam_tpu ",
                            "from aprilsam_tpu.", "import aprilsam_tpu\n"):
                    assert bad not in src, (f, bad)


def _tiny_graph():
    return manhattan_world(5, seed=0)


@pytest.mark.parametrize("entry", ["IncrementalSolver", "BatchSolver",
                                   "Replay", "cli", "large_inc", "scaling",
                                   "schur_stages", "bench"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """With no device argument the entry points take the card; where there
    is none they raise instead of running on the CPU."""
    def make():
        if entry == "IncrementalSolver":
            return IncrementalSolver()
        if entry == "BatchSolver":
            return BatchSolver()
        if entry == "Replay":
            return Replay(_tiny_graph())
        if entry == "large_inc":
            return large_inc.main(["--poses", "50", "--start_capacity",
                                   "64", "--panel_nodes", "16"])
        if entry == "scaling":
            return scaling.main(["--poses", "200", "--blocks", "4"])
        if entry == "schur_stages":
            return schur_stages.main(["--poses", "200", "--blocks", "4"])
        if entry == "bench":
            return bench.main(["--config", "manhattan3500-super96-f64",
                               "--runs", "1", "--no_trace"])
        path = tmp_path / "one.g2o"
        path.write_text("VERTEX2 0 0 0 0\nVERTEX2 1 1 0 0\n"
                        "EDGE2 0 1 1 0 0 100 0 100 1000 0 0\n")
        return cli.main(["--datapath", str(path), "--quiet"])

    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_cli_on_cpu_prints_json(tmp_path, capsys):
    g = manhattan_world(12, seed=0)
    path = tmp_path / "m12.g2o"
    lines = [f"VERTEX2 {i} " + " ".join(repr(float(v)) for v in g.init[i])
             for i in range(g.nnodes)]
    for f in range(g.nfactors):
        a, b = (int(v) for v in g.fnodes[f])
        z, W = g.fz[f], g.fW[f]
        vals = [*z, W[0, 0], W[0, 1], W[1, 1], W[2, 2], W[0, 2], W[1, 2]]
        lines.append(f"EDGE2 {a} {b} " + " ".join(repr(float(v))
                                                   for v in vals))
    path.write_text("\n".join(lines) + "\n")
    assert cli.main(["--datapath", str(path), "--device", "cpu", "--quiet",
                     "--json", "--no_wallclock_gate",
                     "--node_capacity", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 12
    assert np.isfinite(out["final_chi2"])


UNPORTED = [
    {"bundle_size": 4},
    {"coalesce_full_solves": True},
    {"batch_backend": "device"},
    {"batch_backend": "panel"},
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_unported_settings_raise(kw):
    """The settings that raised NotImplementedError until the port had
    bundled dispatch and the device batch epochs now construct and run in
    both solvers."""
    g = manhattan_world(30, seed=0)
    cfg = SolverConfig(node_capacity=64, panel_nodes=8, wallclock_gate=False,
                       policy_lag=2, **kw)
    info = BatchSolver(cfg, device="cpu").solve(g)
    assert info.spd and np.isfinite(info.chi2)
    rep = Replay(g, cfg, deferred=True, device="cpu")
    rep.run()
    s = rep.solver
    assert np.isfinite(s.chi2())
    if kw.get("batch_backend") in ("device", "panel"):
        ran = "epoch_panel" if kw["batch_backend"] == "panel" else \
            "epoch_dense"
        assert s.counters[ran] == s.counters["batch"] >= 1
    assert not s._queue and not s._pending


THROUGHPUT = {
    "policy_lag=2": {"policy_lag": 2},
    "superstep_size=8": {"superstep_size": 8},
    "sweep_window_panels=4": {"superstep_size": 8, "sweep_window_panels": 4,
                              "sweep_full_every": 3},
    "sweep_every_supersteps=2": {"superstep_size": 8,
                                 "sweep_every_supersteps": 2},
}


@pytest.mark.parametrize("case", [*THROUGHPUT, "replay-deferred",
                                  "cli-graphpath", "cli-superstep"])
def test_throughput_settings_run_on_cpu(case, tmp_path, capsys):
    """The settings, Replay option and CLI flags of the throughput modes,
    which raised until the port had them, construct and run."""
    g = manhattan_world(30, seed=0)
    small = dict(node_capacity=64, panel_nodes=8, wallclock_gate=False)
    if case in THROUGHPUT:
        cfg = SolverConfig(**small, **THROUGHPUT[case])
        assert BatchSolver(cfg, device="cpu").solve(g).spd
        rep = Replay(g, cfg, deferred=True, device="cpu")
        rep.run()
        assert np.isfinite(rep.solver.chi2())
        if cfg.superstep_size > 1:
            assert rep.solver.counters["superstep"] > 0
        return
    if case == "replay-deferred":
        rep = Replay(g, SolverConfig(**small), deferred=True, device="cpu")
        res = rep.run()
        assert len(res) == 30 and np.isfinite(res[-1].chi2)
        return
    if case == "cli-graphpath":
        path = tmp_path / "m30.graph"
        save_graph_file(g, str(path))
        args = ["--graphpath", str(path)]
    else:
        path = tmp_path / "one.g2o"
        path.write_text("VERTEX2 0 0 0 0\nVERTEX2 1 1 0 0\n"
                        "EDGE2 0 1 1 0 0 100 0 100 1000 0 0\n")
        args = ["--datapath", str(path), "--superstep", "4"]
    assert cli.main(args + ["--device", "cpu", "--quiet", "--json",
                            "--node_capacity", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_chi2"])


def test_auto_backend_is_the_native_host_epoch():
    s = IncrementalSolver(SolverConfig(batch_backend="auto",
                                       node_capacity=64, panel_nodes=8,
                                       wallclock_gate=False), device="cpu")
    info = s.solve(_tiny_graph())
    assert info.spd and s.last_path == "batch"
