"""The generator: deterministic by seed, the world fixed by the
configuration, and every seed gives the configuration's edge count."""

from __future__ import annotations

import numpy as np
import pytest

import benchmark.run as R
from benchmark.gen.manhattan import generate


def params(config: str) -> dict:
    g = R.load_json(R.ROOT, "benchmark/configs", config + ".json")["graph"]
    return {k: v for k, v in g.items() if k != "generator"}


def test_same_seed_same_graph():
    p = dict(params("m3500-f64"), poses=400, closures=150)
    a, b = generate(seed=2 ** 31 + 7, **p), generate(seed=2 ** 31 + 7, **p)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = generate(seed=3, **p)
    # another seed: the same world, other measurements
    np.testing.assert_array_equal(a["truth"], c["truth"])
    np.testing.assert_array_equal(a["a"], c["a"])
    assert not np.array_equal(a["z"], c["z"])


@pytest.mark.parametrize("config,edges", [("m3500-f64", 5453),
                                          ("city10k-f64", 20687)])
@pytest.mark.parametrize("seed", [0, 4_000_000_017])
def test_published_edge_count(config, edges, seed):
    g = generate(seed=seed, **params(config))
    assert len(g["a"]) == edges
    assert len(g["truth"]) == params(config)["poses"]
    # every edge joins an earlier pose to a later one, in the order a
    # replay adds them; each pose's odometry edge comes first
    assert np.all(g["a"] < g["b"]) and np.all(np.diff(g["b"]) >= 0)
    first = np.r_[True, g["b"][1:] != g["b"][:-1]]
    assert np.all(g["b"][first] - g["a"][first] == 1)


def test_too_few_candidates_refused():
    with pytest.raises(ValueError):
        generate(poses=50, closures=10_000, world=0, seed=1)


def test_noise_pool_same_draws_in_another_order():
    """A cell with a noise pool replays the pool's draws whatever the
    seed, in an order the seed draws; without one each pass has its own."""
    g = dict(params("m3500-f64"), generator="manhattan", poses=200,
             closures=60)
    config, pool = {"graph": g}, {"seed": 0, "draws": 3}

    def zs(seed, pool):
        return [R.pass_graph(config, seed, j, pool)["z"].tobytes()
                for j in range(3)]

    a, b = zs(2 ** 31 + 5, pool), zs(11, pool)
    assert sorted(a) == sorted(b) and len(set(a)) == 3
    orders = {tuple(zs(s, pool)) for s in range(6)}
    assert len(orders) > 1
    # pass j mod 3 again after the pool
    assert R.pass_graph(config, 11, 4, pool)["z"].tobytes() == b[1]
    assert not set(zs(11, None)) & set(b)
