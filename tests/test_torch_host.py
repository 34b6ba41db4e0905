"""The port's host layer against the JAX package: dataset generator, g2o
loader, the native C runtime (the port's byte-for-byte copy of
sam_native.c behind its own ctypes loader), the python symbolic planner and
the float64 host batch epoch."""

import os

import numpy as np
import pytest
import torch

from aprilsam_tpu import native as jnative
from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.io import load_g2o_text as j_load_g2o
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver import symbolic as j_sym
from aprilsam_tpu.solver.batch import BatchSolver as JBatchSolver
from aprilsam_tpu.solver.host_batch import _adjacency_csr as j_adj
from aprilsam_tpu.solver.host_batch import host_batch_epoch as j_epoch
from aprilsam_tpu.solver.ingest import ingest_graph as j_ingest
from aprilsam_tpu.solver.state import init_device_state as j_init_state

from aprilsam_tpu_torch import native as tnative
from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.io import load_g2o_text as t_load_g2o
from aprilsam_tpu_torch.solver import BatchSolver as TBatchSolver
from aprilsam_tpu_torch.solver import SolverConfig as TConfig
from aprilsam_tpu_torch.solver import symbolic as t_sym
from aprilsam_tpu_torch.solver.host_batch import _adjacency_csr as t_adj
from aprilsam_tpu_torch.solver.host_batch import host_batch_epoch as t_epoch
from aprilsam_tpu_torch.solver.ingest import ingest_graph as t_ingest
from aprilsam_tpu_torch.solver.state import (init_device_state as t_init_state,
                                             state_to_numpy)
from aprilsam_tpu_torch.utils import GraphCache

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPH_ARRAYS = ("state", "init", "truth", "l_point", "delta_X", "has_init",
                "has_truth", "ftype", "fnodes", "fz", "fztruth", "has_ztruth",
                "fW")


def _assert_graphs_equal(gt, gj):
    assert (gt.nnodes, gt.nfactors, gt.nf_xyt) == \
        (gj.nnodes, gj.nfactors, gj.nf_xyt)
    n, f = gj.nnodes, gj.nfactors
    for name in GRAPH_ARRAYS:
        a, b = getattr(gt, name), getattr(gj, name)
        rows = n if a.shape[0] == gt._nodes_cap else f
        np.testing.assert_array_equal(a[:rows], b[:rows], err_msg=name)
    assert sorted(gt.factor_attrs) == sorted(gj.factor_attrs)
    for k, attrs in gj.factor_attrs.items():
        assert gt.factor_attrs[k].get("type") == attrs.get("type")


def _small_cfg(cfg_cls, **kw):
    kw.setdefault("node_capacity", 512)
    kw.setdefault("factor_capacity", 2048)
    kw.setdefault("row_block_capacity", 64)
    kw.setdefault("panel_nodes", 32)
    kw.setdefault("wallclock_gate", False)
    return cfg_cls(**kw)


def test_native_source_is_a_byte_copy():
    with open(os.path.join(REPO, "aprilsam_tpu", "native", "sam_native.c"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "aprilsam_tpu_torch", "native",
                           "sam_native.c"), "rb") as f:
        port = f.read()
    assert port == ref


@pytest.mark.parametrize("n,seed,kw", [
    (300, 0, {}),
    (120, 7, {"closure_prob": 0.5, "geopin_every": 10}),
])
def test_manhattan_world_field_for_field(n, seed, kw):
    _assert_graphs_equal(t_manhattan(n, seed=seed, **kw),
                         j_manhattan(n, seed=seed, **kw))


def test_g2o_loader_field_for_field(tmp_path):
    g = j_manhattan(80, seed=3)
    path = tmp_path / "tiny.g2o"
    lines = []
    for i in range(g.nnodes):
        x, y, t = (float(v) for v in g.init[i])
        lines.append(f"VERTEX2 {i} {x!r} {y!r} {t!r}")
    for f in range(g.nfactors):
        a, b = (int(v) for v in g.fnodes[f])
        if b < 0:
            continue
        z, W = g.fz[f], g.fW[f]
        vals = [z[0], z[1], z[2], W[0, 0], W[0, 1], W[1, 1], W[2, 2],
                W[0, 2], W[1, 2]]
        lines.append(f"EDGE2 {a} {b} " + " ".join(repr(float(v))
                                                   for v in vals))
    path.write_text("\n".join(lines) + "\n")
    gt, gj = t_load_g2o(str(path)), j_load_g2o(str(path))
    _assert_graphs_equal(gt, gj)
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.g2o"
        bad.write_text("VERTEX3 0 0 0 0\n")
        t_load_g2o(str(bad))


@pytest.mark.parametrize("style", ["md", "heapmd"])
def test_native_ordering_and_symbolic_identical(style):
    g = j_manhattan(250, seed=4, closure_prob=0.35)
    n, nf = g.nnodes, g.nfactors
    ptr, idx = j_adj(n, g.ftype[:nf], g.fnodes[:nf])
    ptr_t, idx_t = t_adj(n, g.ftype[:nf], g.fnodes[:nf])
    np.testing.assert_array_equal(ptr_t, ptr)
    np.testing.assert_array_equal(idx_t, idx)
    order_j = jnative.order_md(n, ptr, idx, style=style)
    order_t = tnative.order_md(n, ptr, idx, style=style)
    np.testing.assert_array_equal(order_t, order_j)
    for a, b in zip(tnative.symbolic(n, ptr, idx, order_t, 64),
                    jnative.symbolic(n, ptr, idx, order_j, 64)):
        np.testing.assert_array_equal(a, b)


def test_python_symbolic_identical():
    g = j_manhattan(150, seed=5)
    n, nf = g.nnodes, g.nfactors
    adj_j = j_sym.build_adjacency(n, g.ftype[:nf], g.fnodes[:nf])
    adj_t = t_sym.build_adjacency(n, g.ftype[:nf], g.fnodes[:nf])
    assert adj_t == adj_j
    order = t_sym.min_degree_ordering(n, adj_t)
    np.testing.assert_array_equal(order, j_sym.min_degree_ordering(n, adj_j))
    st, sj = t_sym.build_symbolic(n, adj_t, order), \
        j_sym.build_symbolic(n, adj_j, order)
    np.testing.assert_array_equal(st.parents, sj.parents)
    for a, b in zip(st.patterns, sj.patterns):
        np.testing.assert_array_equal(a, b)


def _jax_fields(ds):
    return {k: np.asarray(v) for k, v in ds._asdict().items()}


def test_host_batch_epoch_matches_jax():
    """R, y, states and the metric ring after a sequence of host epochs
    with log modes 0 (append), 1 (overwrite the newest) and 2 (leave)."""
    g = j_manhattan(200, seed=2, geopin_every=25)
    cfg_j, cfg_t = _small_cfg(JConfig), _small_cfg(TConfig)
    ds_j = j_ingest(j_init_state(cfg_j), g, cfg_j, 0, 0)
    ds_t = t_ingest(t_init_state(cfg_t, "cpu"), g, cfg_t, 0, 0)
    nf = g.nfactors
    args = (g.nnodes, g.ftype[:nf], g.fnodes[:nf], g.fz[:nf], g.fW[:nf])
    for log_mode in (0, 0, 1, 2):
        ds_j, sym_j, info_j = j_epoch(ds_j, cfg_j, *args, log_mode=log_mode)
        ds_t, sym_t, info_t = t_epoch(ds_t, cfg_t, *args, log_mode=log_mode,
                                      graphs=GraphCache(ds_t.device))
        assert info_t.spd == info_j.spd
        np.testing.assert_allclose(info_t.chi2, info_j.chi2, rtol=1e-12)
        hj, ht = _jax_fields(ds_j), state_to_numpy(ds_t)
        for name in ("R_blocks", "y", "state", "l_point", "delta_X",
                     "chi2_log"):
            np.testing.assert_allclose(ht[name], hj[name], rtol=1e-12,
                                       atol=1e-12, err_msg=name)
        for name in ("R_idx", "R_nnz", "pos", "order", "relinearized",
                     "start_over", "spd_ok", "log_ptr", "nnodes"):
            np.testing.assert_array_equal(ht[name], hj[name], err_msg=name)
        np.testing.assert_array_equal(sym_t.order, sym_j.order)
        np.testing.assert_array_equal(sym_t.parents, sym_j.parents)
    assert ds_t.log_ptr == 2


def test_batch_solver_matches_jax():
    g = j_manhattan(150, seed=6)
    bj = JBatchSolver(_small_cfg(JConfig, batch_backend="host"))
    bt = TBatchSolver(_small_cfg(TConfig), device="cpu")
    for _ in range(3):            # three GN epochs from the solver states
        ij, it = bj.solve(g), bt.solve(g)
        np.testing.assert_allclose(it.chi2, ij.chi2, rtol=1e-10)
    np.testing.assert_allclose(bt.chi2(), bj.chi2(), rtol=1e-9)
    gt = t_manhattan(150, seed=6)
    bt.sync_states(gt)
    np.testing.assert_allclose(gt.state[:150], np.asarray(bj.ds.state[:150]),
                               rtol=1e-10, atol=1e-12)
