"""Kernel K1, the batched upper-triangular inverse, and the panel sweep that
calls it.  On the CPU the wrapper takes its plain version; these tests hold
that version against the JAX package (the Pallas kernel in interpret mode
and the default solve-against-identity), and the panel back-substitution
against the JAX sweep on the R that a host batch epoch produced.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilsam_tpu.datasets import manhattan_world
from aprilsam_tpu.kernels.pallas_tri import tri_inv as j_tri_inv
from aprilsam_tpu.kernels.pallas_tri import tri_inv_pallas
from aprilsam_tpu.kernels.sweep import panel_backsub as j_panel_backsub
from aprilsam_tpu.solver import IncrementalSolver as JSolver
from aprilsam_tpu.solver import SolverConfig as JConfig

from aprilsam_tpu_torch.kernels import tri_inv as K
from aprilsam_tpu_torch.kernels.sweep import panel_backsub

torch.set_num_threads(1)


def well_conditioned(rng, B, N, dtype=np.float64):
    """Seeded upper triangles with a dominant diagonal (the shape of a
    Cholesky factor's panel diagonal block), junk below the diagonal that
    the inverse must ignore."""
    T = rng.standard_normal((B, N, N)) * (0.5 / np.sqrt(N))
    T = np.triu(T, 1) + np.tril(rng.standard_normal((B, N, N)), -1) * 7.0
    d = 1.0 + rng.random((B, N))
    T[:, np.arange(N), np.arange(N)] = d
    return T.astype(dtype)


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_plain_matches_pallas_interpret():
    """[3, 96, 96] float32 against the Pallas kernel in interpret mode, with
    the inputs of the JAX package's own Pallas test."""
    rng = np.random.default_rng(3)
    B, N = 3, 96
    T = (np.triu(rng.standard_normal((B, N, N))).astype(np.float32)
         + 6 * np.eye(N, dtype=np.float32))
    ref = np.asarray(tri_inv_pallas(jnp.asarray(T), interpret=True))
    got = K.tri_inv(torch.from_numpy(T)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < 1e-5


def test_plain_matches_jax_tri_inv_f64():
    rng = np.random.default_rng(11)
    T = well_conditioned(rng, 4, 384)
    ref = np.asarray(j_tri_inv(jnp.asarray(T)))
    got = K.tri_inv(torch.from_numpy(T)).numpy()
    assert _rel(got, ref) < 1e-12
    # zeros below the diagonal, and an inverse of the upper triangle
    assert np.all(np.tril(got, -1) == 0.0)
    eye = np.einsum("bij,bjk->bik", np.triu(T), got)
    assert np.max(np.abs(eye - np.eye(384))) < 1e-12


@pytest.mark.parametrize("B,N", [(1, 1), (2, 5), (3, 50)])
def test_plain_any_width(B, N):
    """Any N >= 1, not only multiples of 48."""
    rng = np.random.default_rng(N)
    T = well_conditioned(rng, B, N)
    got = K.tri_inv(torch.from_numpy(T)).numpy()
    ref = np.stack([np.linalg.inv(np.triu(t)) for t in T])
    assert _rel(got, ref) < 1e-12


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    K.reset_launches()
    rng = np.random.default_rng(0)
    T = torch.from_numpy(well_conditioned(rng, 2, 48))
    X = K.tri_inv(T)
    assert K.launches == 0
    torch.testing.assert_close(X, K.tri_inv_plain(T), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    T = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError):
        K.tri_inv(T)
    assert K.launches == 0


def _host_epoch_R(n=300, seed=0):
    """R, y of the JAX package's host batch epoch on manhattan_world."""
    cfg = JConfig(node_capacity=512, factor_capacity=2048,
                  row_block_capacity=64, panel_nodes=32,
                  wallclock_gate=False)
    s = JSolver(cfg)
    s.solve(manhattan_world(n, seed=seed))
    ds = s.ds
    return (np.array(ds.R_blocks), np.array(ds.R_idx), np.array(ds.y),
            int(ds.nnodes))


@pytest.mark.parametrize("NPANB", [16, 10])
def test_panel_backsub_matches_jax(NPANB):
    """x = R^-1 y over the active panels, position space; NPANB = 10 also
    checks identity padding of inactive rows (300 nodes in 10 panels of
    32)."""
    Rb, Ri, y, n = _host_epoch_R()
    PANEL = 32
    ref = np.asarray(j_panel_backsub(jnp.asarray(Rb), jnp.asarray(Ri),
                                     jnp.asarray(y), n, PANEL, NPANB))
    K.reset_launches()
    got = panel_backsub(torch.from_numpy(Rb), torch.from_numpy(Ri),
                        torch.from_numpy(y), n, PANEL, NPANB).numpy()
    assert K.launches == 0
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(ref)))

