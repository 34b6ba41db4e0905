"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port either."""

from __future__ import annotations

import ast
import os
import sys

import benchmark.run as R

BENCH = R.BENCH


def imported(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(sub: str = ""):
    for d, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: imported(p) & set(R.FORBIDDEN) for p in modules()}
    assert not {p: n for p, n in bad.items() if n}


def test_reference_imports_nothing_of_the_program():
    for p in modules("reference"):
        assert not imported(p) & {"aprilsam_tpu", "aprilsam_tpu_torch"}, p
    assert imported(os.path.join(BENCH, "check.py")).isdisjoint(
        {"aprilsam_tpu_torch"})


def test_run_time_check_compares_whole_names(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in R.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "aprilsam_tpu_torch_like", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aprilsam_tpu.solver", object())
    assert R.forbidden_modules() == ["aprilsam_tpu"]
