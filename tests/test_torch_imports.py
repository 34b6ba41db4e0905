"""The port stands alone: no module of aprilsam_tpu_torch, and neither
chip_smoke.py nor profile_torch_replay.py, imports JAX or the JAX package;
its entry points run on the card unless asked for the CPU; settings of
later slices raise."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch import cli
from aprilsam_tpu_torch.datasets import manhattan_world
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
    for m in ("geometry", "graph", "io.g2o", "datasets", "solver.config",
              "utils.timeprofile", "native", "solver.symbolic", "factors",
              "kernels.linalg3", "solver.state", "solver.ingest",
              "solver.batch", "solver.host_batch", "kernels.tri_inv",
              "kernels.sweep", "solver.incremental", "replay", "cli"):
        assert f"aprilsam_tpu_torch.{m}" in mods, m
    assert os.path.exists(os.path.join(PKG, "csrc", "tri_inv.cu"))


def test_no_jax_at_runtime():
    """Import every port module and the two chip scripts in a fresh
    interpreter: neither jax nor any module of aprilsam_tpu may be loaded
    (the prefix aprilsam_tpu also matches aprilsam_tpu_torch, so names are
    compared exactly)."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, os, sys
        for m in {_port_modules()!r}:
            importlib.import_module(m)
        for script in ("chip_smoke", "profile_torch_replay"):
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
                                   "Replay", "cli"])
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
    {"policy_lag": 2},
    {"bundle_size": 4},
    {"superstep_size": 8},
    {"sweep_window_panels": 4},
    {"coalesce_full_solves": True},
    {"batch_backend": "device"},
    {"batch_backend": "panel"},
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_unported_settings_raise(kw):
    cfg = SolverConfig(**kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        IncrementalSolver(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        BatchSolver(cfg, device="cpu")


def test_unported_replay_and_cli_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="later slice"):
        Replay(_tiny_graph(), deferred=True, device="cpu")
    with pytest.raises(NotImplementedError, match="io/stype.py"):
        cli.main(["--device", "cpu", "--quiet"])
    path = tmp_path / "one.g2o"
    path.write_text("VERTEX2 0 0 0 0\n")
    with pytest.raises(NotImplementedError, match="later slice"):
        cli.main(["--datapath", str(path), "--device", "cpu", "--superstep",
                  "4"])


def test_auto_backend_is_the_native_host_epoch():
    s = IncrementalSolver(SolverConfig(batch_backend="auto",
                                       node_capacity=64, panel_nodes=8,
                                       wallclock_gate=False), device="cpu")
    info = s.solve(_tiny_graph())
    assert info.spd and s.last_path == "batch"
