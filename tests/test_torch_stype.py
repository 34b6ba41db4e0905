"""The port's binary `.graph` (stype) IO against the JAX package's: the
writers give identical bytes, each package reads the other's bytes field
for field and exactly, and the CLI replays a graph file (--graphpath)."""

import json

import numpy as np
import pytest
import torch

import aprilsam_tpu.graph as jg
from aprilsam_tpu.datasets import manhattan_world as j_manhattan
from aprilsam_tpu.io import stype as j_stype

import aprilsam_tpu_torch.graph as tg
from aprilsam_tpu_torch import cli
from aprilsam_tpu_torch.datasets import manhattan_world as t_manhattan
from aprilsam_tpu_torch.io import (load_graph_bytes, load_graph_file,
                                   save_graph_bytes, save_graph_file)

torch.set_num_threads(1)

W_GEOPIN = np.diag([1e4, 1e4, 1e3])
W_ODOM = np.diag([1 / 0.1 ** 2, 1 / 0.1 ** 2, 1 / np.radians(1.0) ** 2])


def tutorial(G):
    """The tutorial dogleg (examples/tutorial.py) in package G."""
    g = G.FactorGraph()
    g.add_node([0, 0, 0], init=[0, 0, 0])
    g.add_factor_xytpos(0, [0, 0, 0], W_GEOPIN)
    for i in range(1, 6):
        g.add_node([i, 0, 0], init=[i, 0, 0])
        g.add_factor_xyt(i - 1, i, [1.0, 0.0, 0.0], W_ODOM)
    g.add_factor_xyt(0, 5, [5.0, 1.0, 0.0], W_ODOM)
    return g


def with_attributes(G):
    """Attributes of every kind the format carries (string and uint64
    values on nodes, factors and the graph), truths on some nodes and
    measurements, an xytpos prior with a ztruth, and an upper-triangle-only
    information matrix."""
    rng = np.random.default_rng(3)
    g = G.FactorGraph()
    for i in range(6):
        st = rng.standard_normal(3)
        g.add_node(st, init=st + 0.01 if i % 2 else None,
                   truth=st - 0.02 if i % 3 else None)
    a = G.Attributes()
    a.put("string", "name", "pose-0")
    a.put("uint64", "stamp", 1234567890123)
    g.node_attrs[0] = a
    Wu = np.triu(np.arange(1.0, 10.0).reshape(3, 3))
    g.add_factor_xytpos(0, [0.1, -0.2, 0.3], W_GEOPIN,
                        ztruth=[0.0, 0.0, 0.25])
    for i in range(1, 6):
        f = g.add_factor_xyt(i - 1, i, rng.standard_normal(3), Wu,
                             ztruth=rng.standard_normal(3) if i % 2 else None)
        fa = G.Attributes()
        fa.put("string", "type", "odom")
        g.factor_attrs[f] = fa
    g.add_factor_xytpos(4, [1.0, 2.0, 3.0], W_ODOM)
    g.attr.put("string", "dataset", "synthetic")
    g.attr.put("uint64", "version", 7)
    return g


GRAPHS = {
    "tutorial": tutorial,
    "manhattan300": lambda G: (j_manhattan if G is jg else t_manhattan)(
        300, seed=0),
    "attributes": with_attributes,
}

NODE_FIELDS = ("state", "init", "truth", "has_init", "has_truth")
FACTOR_FIELDS = ("ftype", "fnodes", "fz", "fW", "fztruth", "has_ztruth")


def assert_same_graph(a, b):
    assert a.nnodes == b.nnodes and a.nfactors == b.nfactors
    for name in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(a, name)[:a.nnodes],
                                      getattr(b, name)[:b.nnodes], name)
    for name in FACTOR_FIELDS:
        np.testing.assert_array_equal(getattr(a, name)[:a.nfactors],
                                      getattr(b, name)[:b.nfactors], name)
    assert a.attr.data == b.attr.data
    for name in ("node_attrs", "factor_attrs"):
        da, db = getattr(a, name), getattr(b, name)
        assert sorted(da) == sorted(db), name
        for k in da:
            assert da[k].data == db[k].data, (name, k)


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_writer_bytes_equal_the_jax_writer(kind):
    data = save_graph_bytes(GRAPHS[kind](tg))
    assert data == j_stype.save_graph_bytes(GRAPHS[kind](jg))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_each_package_reads_the_other(kind):
    g_t, g_j = GRAPHS[kind](tg), GRAPHS[kind](jg)
    from_jax = load_graph_bytes(j_stype.save_graph_bytes(g_j))
    from_port = j_stype.load_graph_bytes(save_graph_bytes(g_t))
    assert isinstance(from_jax, tg.FactorGraph)
    assert_same_graph(from_jax, g_t)
    assert_same_graph(from_port, g_j)
    assert_same_graph(from_jax, from_port)


def test_file_round_trip(tmp_path):
    g = with_attributes(tg)
    path = str(tmp_path / "g.graph")
    save_graph_file(g, path)
    assert_same_graph(load_graph_file(path), g)
    assert_same_graph(j_stype.load_graph_file(path), with_attributes(jg))


def test_cli_graphpath_on_cpu(tmp_path, capsys):
    """--graphpath replays a binary graph, per step and in superstep mode;
    the per-step final chi2 equals a replay of the same graph in memory."""
    from aprilsam_tpu_torch.replay import Replay
    from aprilsam_tpu_torch.solver import SolverConfig

    g = t_manhattan(40, seed=1)
    path = str(tmp_path / "m40.graph")
    save_graph_file(g, path)
    common = ["--graphpath", path, "--device", "cpu", "--quiet", "--json",
              "--no_wallclock_gate", "--node_capacity", "64"]
    finals = {}
    for S in (1, 8):
        assert cli.main(common + ["--superstep", str(S)]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["steps"] == 40
        assert np.isfinite(out["final_chi2"])
        finals[S] = out["final_chi2"]
    rep = Replay(t_manhattan(40, seed=1),
                 SolverConfig(node_capacity=64, factor_capacity=8192,
                              wallclock_gate=False), device="cpu")
    res = rep.run()
    assert finals[1] == res[-1].chi2
    assert abs(finals[8] - finals[1]) < 0.05 * (1.0 + finals[1])
