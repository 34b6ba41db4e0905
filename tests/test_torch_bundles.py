"""Bundled dispatch in the port against per-step dispatch and against the
JAX package's bundles, on the CPU in float64.

The analogues of tests/test_incremental.py:221-560: the same graphs and
configs go through the port and, where the outcome is deterministic,
through the JAX package.  With nthreshold = 10**9 no batch epoch fires
after the first, so states and every chi2_history() entry are held to
1e-10 against the JAX package (the port's frontal QR runs on the step's m
rows where the JAX package pads to a bucket, so the two agree to
rounding), and to 1e-12 between the port's own bundled and per-step runs,
as the JAX package holds its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aprilsam_tpu.graph import FactorGraph as JGraph
from aprilsam_tpu.solver import IncrementalSolver as JSolver
from aprilsam_tpu.solver import SolverConfig as JConfig
from aprilsam_tpu.solver.incremental import SeedSpec as JSeed

from aprilsam_tpu_torch.geometry import np_xyt_inv_mul
from aprilsam_tpu_torch.graph import FactorGraph
from aprilsam_tpu_torch.solver import IncrementalSolver, SolverConfig
from aprilsam_tpu_torch.solver import incremental as inc
from aprilsam_tpu_torch.solver.incremental import SeedSpec

torch.set_num_threads(1)

SMALL = dict(node_capacity=512, factor_capacity=2048, row_block_capacity=64,
             panel_nodes=32, wallclock_gate=False)
W_ODO = np.diag([100.0, 100.0, (180.0 / np.pi) ** 2])
N = 40


def chain_graph(n, y_noise, seed, closures, offset):
    rng = np.random.default_rng(seed)
    g = FactorGraph()
    for i in range(n):
        p = [float(i), y_noise * rng.standard_normal(), 0.0]
        g.add_node(p, init=p)
    g.add_factor_xytpos(0, [0, 0, 0], np.diag([1e4, 1e4, 1e3]))
    for i in range(n - 1):
        g.add_factor_xyt(i, i + 1, np_xyt_inv_mul(g.init[i], g.init[i + 1]),
                         W_ODO)
    for a, b in closures:
        g.add_factor_xyt(a, b, np_xyt_inv_mul(g.init[a], g.init[b]) + offset,
                         W_ODO)
    return g


CLOSURES = chain_graph(N, 0.05, 3, [(2, 20), (5, 30), (10, 38)],
                       np.array([0.1, -0.05, 0.02]))


def replay(g, package, hook=None, **cfg_kw):
    """Replay g pose by pose (odometry seeds as the JAX package's tests
    make them) through the port ("torch") or the JAX package ("jax");
    returns the solver after flush()."""
    if package == "torch":
        s = IncrementalSolver(SolverConfig(**{**SMALL, **cfg_kw}),
                              device="cpu")
        live, Seed = FactorGraph(), SeedSpec
    else:
        s = JSolver(JConfig(**{**SMALL, **cfg_kw}))
        live, Seed = JGraph(), JSeed
    if hook is not None:
        hook(s)
    n = g.nnodes
    by_max = [[] for _ in range(n)]
    for f in range(g.nfactors):
        by_max[int(max(g.fnodes[f]))].append(f)
    for k in range(n):
        live.add_node(g.init[k], init=g.init[k])
        seeds = []
        for f in by_max[k]:
            a, b = (int(v) for v in g.fnodes[f])
            if b >= 0:
                if abs(a - b) == 1:
                    seeds.append(Seed(a, b, g.fz[f], False) if a < b
                                 else Seed(b, a, g.fz[f], True))
                live.add_factor_xyt(a, b, g.fz[f], g.fW[f])
            else:
                live.add_factor_xytpos(a, g.fz[f], g.fW[f])
        if k == 0:
            s.solve(live)
        else:
            s.update(live, seeds=seeds)
    s.flush(live)
    s.live = live
    return s


def states(s):
    st = s.ds.state[:N]
    return st.numpy() if isinstance(st, torch.Tensor) else np.asarray(st)


@pytest.fixture(scope="module")
def jax_bundled4():
    return replay(CLOSURES, "jax", nthreshold=10**9, bundle_size=4,
                  policy_lag=4)


def test_bundled_matches_unbundled(jax_bundled4):
    """bundle_size 4 gives the per-step trajectory (policy lags by at
    most a bundle) and the JAX package's bundled one."""
    one = replay(CLOSURES, "torch", nthreshold=10**9, bundle_size=1,
                 policy_lag=4)
    four = replay(CLOSURES, "torch", nthreshold=10**9, bundle_size=4,
                  policy_lag=4)
    np.testing.assert_allclose(states(four), states(one), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(four.chi2_history(), one.chi2_history(),
                               rtol=0, atol=1e-12)
    assert four.counters["full"] > 0 and four.counters["fast"] > 0
    np.testing.assert_allclose(states(four), states(jax_bundled4), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(four.chi2_history(),
                               jax_bundled4.chi2_history(), rtol=1e-10,
                               atol=1e-20)


def _count_mixed(counter):
    def hook(s):
        orig = s._mixed_chunks

        def counting(entries):
            counter.append(len(entries))
            return orig(entries)
        s._mixed_chunks = counting
    return hook


def test_mixed_bundles_match_legacy_and_narrow_rcap(jax_bundled4):
    """Mixed bundles (fast and full slots in one bundle) give the
    per-signature bundles' trajectory, also when a ridx_pack_capacity too
    narrow for any row sends every step to the per-signature bundles."""
    runs = {}
    for name, kw in (("mixed", {}), ("legacy", {"mixed_bundles": False}),
                     ("narrow", {"ridx_pack_capacity": 1})):
        slots = []
        s = replay(CLOSURES, "torch", hook=_count_mixed(slots),
                   nthreshold=10**9, bundle_size=4, policy_lag=4, **kw)
        runs[name] = (s, sum(slots))
    assert runs["mixed"][1] > 0, "mixed path never exercised"
    assert runs["legacy"][1] == 0 and runs["narrow"][1] == 0
    ref = runs["legacy"][0]
    for name in ("mixed", "narrow"):
        s = runs[name][0]
        np.testing.assert_allclose(states(s), states(ref), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(s.chi2_history(), ref.chi2_history(),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(states(runs["mixed"][0]),
                               states(jax_bundled4), rtol=0, atol=1e-10)


def test_mixed_bundle_chunks_at_the_jax_word_budget(monkeypatch):
    """A mixed bundle whose packed slots would exceed the JAX package's
    largest flat bucket dispatches in chunks, each with its own coalesced
    sweep: here a budget of a few slots splits bundles of eight."""
    sizes = []
    monkeypatch.setattr(inc, "MIXED_FLAT_BUCKETS", (1, 12000))

    def hook(s):
        orig = s._mixed_chunks

        def record(entries):
            chunks = orig(entries)
            sizes.append([len(c) for c in chunks])
            return chunks
        s._mixed_chunks = record

    s = replay(CLOSURES, "torch", hook=hook, nthreshold=10**9,
               bundle_size=8, policy_lag=8, coalesce_full_solves=True)
    assert any(len(c) > 1 for c in sizes), sizes
    assert all(sum(c) <= 8 for c in sizes)
    assert np.isfinite(s.chi2())


def test_coalesced_full_solves_close_to_per_step():
    """coalesce_full_solves moves the whole-graph sweep to the end of each
    bundle; the final optimum stays within 1e-6 of the per-step one, and
    the trajectory equals the JAX package's coalesced one."""
    kw = dict(nthreshold=10**9, bundle_size=4, policy_lag=4)
    co = replay(CLOSURES, "torch", coalesce_full_solves=True, **kw)
    per = replay(CLOSURES, "torch", coalesce_full_solves=False, **kw)
    assert np.isfinite(co.chi2())
    np.testing.assert_allclose(states(co), states(per), rtol=0, atol=1e-6)
    assert abs(co.chi2() - per.chi2()) < 1e-6
    j_co = replay(CLOSURES, "jax", coalesce_full_solves=True, **kw)
    np.testing.assert_allclose(states(co), states(j_co), rtol=0, atol=1e-10)
    np.testing.assert_allclose(co.chi2_history(), j_co.chi2_history(),
                               rtol=1e-10, atol=1e-20)


FALLBACK = chain_graph(N, 0.3, 5, [(2, 20), (5, 30), (1, 25), (12, 38),
                                   (3, 35)], np.array([0.3, -0.2, 0.05]))


def _jax_stats_ready(s):
    """Make the JAX package's policy deterministic: it reads the newest due
    stats that are ready, else the oldest due, and on its asynchronous CPU
    backend readiness is a race.  Waiting for each dispatch makes every
    due entry ready, as the port's CPU stats always are."""
    import jax

    dispatch = s._dispatch_queue

    def waited():
        dispatch()
        jax.block_until_ready(s.ds)
    s._dispatch_queue = waited


def test_bundled_batch_fallback_consistency():
    """Batch fallbacks fired from inside bundles (the lagged log_mode 2
    path) leave the state consistent with the host graph, converge like
    the synchronous run, and land where the JAX package's land when its
    policy reads the same stats rows."""
    def run(package, bundle, lag):
        s = replay(FALLBACK, package, nthreshold=2, bundle_size=bundle,
                   policy_lag=lag)
        s.sync_states(s.live)
        return s

    sync, bund = run("torch", 1, 0), run("torch", 4, 4)
    assert bund._batch_serial > 1
    for s in (sync, bund):
        assert abs(s.chi2() - s.live.chi2()) < 1e-9 * (1 + s.live.chi2())
    assert abs(bund.chi2() - sync.chi2()) < 0.5 * (1 + sync.chi2())
    j_bund = replay(FALLBACK, "jax", hook=_jax_stats_ready, nthreshold=2,
                    bundle_size=4, policy_lag=4)
    assert bund._batch_serial == j_bund._batch_serial
    np.testing.assert_allclose(states(bund), states(j_bund), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(bund.chi2_history(), j_bund.chi2_history(),
                               rtol=1e-10, atol=1e-20)


@pytest.mark.parametrize("gate", [True, False])
def test_deferred_wallclock_gate_fires(gate):
    """In bundled lagged mode the batch_time/3 gate reads the dispatch-to-
    dispatch interval per step: with an instantaneous recorded batch every
    bundle trips it, and without the gate no epoch fires."""
    g = chain_graph(N, 0.05, 7, [], np.zeros(3))
    s = IncrementalSolver(SolverConfig(**{
        **SMALL, "nthreshold": 10**9, "bundle_size": 4, "policy_lag": 4,
        "wallclock_gate": gate}), device="cpu")
    live = FactorGraph()
    for k in range(N):
        live.add_node(g.init[k], init=g.init[k])
        if k == 0:
            live.add_factor_xytpos(0, g.fz[0], g.fW[0])
            s.solve(live)
            s.batch_time_ms = 1e-6
            continue
        live.add_factor_xyt(k - 1, k, g.fz[k], g.fW[k])
        s.update(live, seeds=[SeedSpec(k - 1, k, g.fz[k], False)])
    s.flush(live)
    assert (s._batch_serial > 1) == gate


@pytest.mark.parametrize("backend", ["device", "panel"])
def test_bundles_with_device_epochs(backend):
    """Bundles and lazy device epochs together: fallbacks fired inside
    bundles run on the device backend and the trajectory equals the host
    backend's to 1e-9."""
    def run(b):
        s = replay(FALLBACK, "torch", nthreshold=2, bundle_size=4,
                   policy_lag=4, batch_backend=b,
                   coalesce_full_solves=True)
        return s
    dev, host = run(backend), run("host")
    ran = "epoch_panel" if backend == "panel" else "epoch_dense"
    assert dev.counters[ran] == dev.counters["batch"] > 1
    assert dev._batch_serial == host._batch_serial
    np.testing.assert_allclose(states(dev), states(host), rtol=0, atol=1e-9)
    # ring entries at rounding level of zero (~1e-13) are held absolutely
    np.testing.assert_allclose(dev.chi2_history(), host.chi2_history(),
                               rtol=1e-9, atol=1e-12)


def test_bundle_stats_rows_reach_the_policy():
    """Each slot of a bundle queues its own row of the bundle's [k, 3]
    stats; the policy reads the newest due row."""
    s = replay(CLOSURES, "torch", nthreshold=10**9, bundle_size=4,
               policy_lag=100)
    assert not s._pending
    rows = []
    orig = s._apply_policy

    def spy(stats, serial, step_ms, g):
        rows.append(np.array(stats))
        return orig(stats, serial, step_ms, g)
    s._apply_policy = spy
    g = s.live
    g.add_node(g.init[N - 1], init=g.init[N - 1])
    g.add_factor_xyt(N - 1, N, np.array([1.0, 0.0, 0.0]), W_ODO)
    s.update(g)
    assert len(s._queue) == 1 and not s._pending
    s.flush(g)
    assert len(rows) == 1 and rows[0].shape == (3,)
    assert s._queue == [] and not s._pending


def test_queue_lands_before_capacity_growth():
    """Queued bundle slots are dispatched before the state grows (their
    plans carry the old capacity's pattern padding)."""
    g = chain_graph(70, 0.05, 11, [(3, 40), (10, 60)],
                    np.array([0.05, -0.03, 0.01]))
    kw = dict(nthreshold=10**9, bundle_size=4, policy_lag=4)
    small = replay(g, "torch", **{**kw, "node_capacity": 64,
                                  "panel_nodes": 16})
    big = replay(g, "torch", **{**kw, "node_capacity": 128,
                                "panel_nodes": 16})
    assert small.cfg.node_capacity == 128
    np.testing.assert_allclose(small.ds.state[:70].numpy(),
                               big.ds.state[:70].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(small.chi2_history(), big.chi2_history(),
                               rtol=1e-9)


def test_bundle_configs_construct_and_run():
    """Every bundle setting of the JAX package's config constructs and
    runs (dataclasses.replace keeps them)."""
    cfg = dataclasses.replace(SolverConfig(**SMALL), bundle_size=3,
                              bundle_size_full=2, mixed_bundles=False,
                              coalesce_full_solves=True,
                              ridx_pack_capacity=8)
    s = IncrementalSolver(cfg, device="cpu")
    assert s.cfg.effective_ridx_pack == 8
    s2 = replay(CLOSURES, "torch", **{k: getattr(cfg, k) for k in (
        "bundle_size", "bundle_size_full", "mixed_bundles",
        "coalesce_full_solves", "ridx_pack_capacity")}, policy_lag=3)
    assert np.isfinite(s2.chi2())
