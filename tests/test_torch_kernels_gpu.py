"""The port's CUDA kernels against their plain versions, and the device
batch epochs (which run K1) against the host epoch, on the card.

Needs an NVIDIA card and nvcc; every test here carries the `gpu` marker and
skips without a card.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them (the tests directory's conftest imports
JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from aprilsam_tpu_torch.kernels import tri_inv as K
from aprilsam_tpu_torch.kernels.sweep import panel_backsub


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def upper_triangles(rng, B, N, dtype):
    T = rng.standard_normal((B, N, N)) * (0.5 / np.sqrt(N))
    T = np.triu(T, 1) + np.tril(rng.standard_normal((B, N, N)), -1) * 7.0
    T[:, np.arange(N), np.arange(N)] = 1.0 + rng.random((B, N))
    return torch.from_numpy(T.astype(dtype)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-4)])
@pytest.mark.parametrize("B,N", [(32, 384), (8, 96), (1, 48), (3, 50),
                                 (2, 1), (1, 700), (1, 384), (2, 384),
                                 (4, 384), (8, 384), (16, 384), (1, 2000),
                                 (1, 4500)])
def test_tri_inv_kernel_matches_plain_version(B, N, dtype, tol):
    """Every B the main path launches at N = 384, ragged last tiles, and
    N = 2000 and 4500, where the strip's rows of all tiles no longer fit in
    shared memory and stream (float64 at both, float32 at 4500)."""
    _need_card()
    rng = np.random.default_rng(B * 1000 + N)
    T = upper_triangles(rng, B, N, dtype)
    before = K.launches
    key = (B, N, np.dtype(dtype).name)
    before_shape = K.launches_by_shape.get(key, 0)
    X = K.tri_inv(T)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert K.launches_by_shape[key] == before_shape + 1
    ref = K.tri_inv_plain(T)
    err = ((X - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol
    assert torch.tril(X, -1).abs().max().item() == 0.0


# (B, N) at which the kernel picks each strip width on an H100 (132 SMs):
# 48 (float64 only) when the B (nt - 1) strips fill the SMs, 16 when three
# times as many give two blocks per SM, else 8; on a full and a ragged last
# tile.
WIDTH_SHAPES = {48: [(32, 384), (44, 150)], 16: [(16, 384), (30, 150)],
                8: [(4, 384), (3, 150)]}


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,width,dtype,tol", [
    (B, N, width, dtype, tol)
    for width, shapes in WIDTH_SHAPES.items() for B, N in shapes
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-4))
    if not (width == 48 and dtype == np.float32)])
def test_tri_inv_every_strip_width(B, N, width, dtype, tol):
    """Each strip width the kernel is built for, at a shape that makes it
    pick that width."""
    _need_card()
    rng = np.random.default_rng(N + width)
    T = upper_triangles(rng, B, N, dtype)
    X = K.tri_inv(T)
    torch.cuda.synchronize()
    ref = K.tri_inv_plain(T)
    err = ((X - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol
    assert torch.tril(X, -1).abs().max().item() == 0.0


@pytest.mark.gpu
def test_tri_inv_rejects_non_contiguous_and_other_types():
    _need_card()
    T = torch.eye(8, device="cuda").expand(2, 8, 8)
    with pytest.raises(ValueError):
        K.tri_inv(T)
    with pytest.raises(TypeError):
        K.tri_inv(torch.eye(8, device="cuda", dtype=torch.float16)[None])
    with pytest.raises(ValueError):
        K.tri_inv(torch.eye(8, device="cuda")[None, :, :4].contiguous())


@pytest.mark.gpu
def test_panel_backsub_on_the_card_matches_the_cpu():
    """The sweep with the kernel on the card against the sweep with the
    plain version on the CPU, on a random block-upper-triangular R."""
    _need_card()
    rng = np.random.default_rng(7)
    NCAP, BCAP, PANEL, n = 256, 6, 32, 200
    idx = np.full((NCAP, BCAP), NCAP, dtype=np.int64)
    blocks = np.zeros((NCAP, BCAP, 3, 3))
    for p in range(n):
        cols = np.unique(np.concatenate([[p], rng.integers(p + 1, n + 1,
                                                           BCAP - 1)]))
        cols = cols[cols < n][:BCAP]
        idx[p, :len(cols)] = cols
        blocks[p, :len(cols)] = rng.standard_normal((len(cols), 3, 3)) * 0.1
        blocks[p, 0] = np.triu(blocks[p, 0]) + 2.0 * np.eye(3)
    y = rng.standard_normal((NCAP, 3))
    y[n:] = 0.0
    args = [torch.from_numpy(a) for a in (blocks, idx, y)]
    ref = panel_backsub(*args, n, PANEL, 8)
    before = K.launches
    got = panel_backsub(*[a.cuda() for a in args], n, PANEL, 8)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,k1", [("device", 0), ("panel", 1)])
def test_device_epochs_on_the_card_match_the_host_epoch(backend, k1):
    """The dense and the panel batch epoch on the card against the native
    host epoch on manhattan_world(700): the same ordering, R and y within
    1e-7, states within 1e-8 (the JAX package's tolerances,
    tests/test_batch.py:135-143) and chi2 within 1e-9 relative; the panel
    epoch's back-substitution launches K1 once."""
    _need_card()
    from aprilsam_tpu_torch.datasets import manhattan_world
    from aprilsam_tpu_torch.solver.batch import run_batch_epoch
    from aprilsam_tpu_torch.solver.config import SolverConfig
    from aprilsam_tpu_torch.solver.host_batch import host_batch_epoch
    from aprilsam_tpu_torch.solver.ingest import ingest_graph
    from aprilsam_tpu_torch.solver.state import init_device_state
    from aprilsam_tpu_torch.utils import GraphCache

    g = manhattan_world(700, seed=0)
    nf = g.nfactors
    tables = (g.ftype[:nf], g.fnodes[:nf])
    cfg = SolverConfig(node_capacity=1024, factor_capacity=2048,
                       row_block_capacity=96, panel_nodes=128,
                       batch_backend=backend)

    def state(device):
        return ingest_graph(init_device_state(cfg, device), g, cfg, 0, 0)

    before = K.launches
    ds, sym, info, ran = run_batch_epoch(
        state("cuda"), cfg, g.nnodes, *tables,
        graphs=GraphCache(torch.device("cuda"), enabled=False))
    torch.cuda.synchronize()
    assert ran == ("panel" if backend == "panel" else "dense")
    assert K.launches == before + k1
    ds_h, sym_h, info_h = host_batch_epoch(
        state("cpu"), cfg, g.nnodes, *tables, g.fz[:nf], g.fW[:nf],
        graphs=GraphCache(torch.device("cpu")))
    np.testing.assert_array_equal(sym.order, sym_h.order)
    assert info.spd and info_h.spd
    assert abs(info.chi2 - info_h.chi2) < 1e-9 * abs(info_h.chi2)
    for name, tol in (("R_blocks", 1e-7), ("y", 1e-7)):
        np.testing.assert_allclose(getattr(ds, name).cpu().numpy(),
                                   getattr(ds_h, name).numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(ds.state[:700].cpu().numpy(),
                               ds_h.state[:700].numpy(), rtol=0, atol=1e-8)
