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
    assert K.launches_by_shape == {}
    torch.testing.assert_close(X, K.tri_inv_plain(T), rtol=0, atol=0)


# The kernel's schedule (tri_inv.schedule) and its algorithm run block by
# block with torch tile products (tri_inv.run_schedule), against JAX.

@pytest.mark.parametrize("B,N", [(1, 1), (2, 5), (1, 48), (3, 50), (2, 96),
                                 (1, 384), (4, 384), (8, 384), (16, 384),
                                 (32, 384), (1, 700)])
def test_schedule_covers_every_tile_once(B, N):
    nt = -(-N // 48)
    for width in (48, 16, 8):
        s = K.schedule(B, N, width)
        assert s.tiles == nt and s.width == width
        assert sorted(s.diag_blocks) == [(b, i) for b in range(B)
                                         for i in range(nt)]
        assert (len(set(s.zero_blocks)) == len(s.zero_blocks)
                == B * nt * (nt - 1) // 2)
        assert all(k < i < nt for _, i, k in s.zero_blocks)
        if nt == 1:
            assert s.strip_blocks == []
            continue
        # longest strips first; every column right of the first tile in
        # exactly one strip that does work
        Js = [J for _, J, _ in s.strip_blocks]
        assert Js == sorted(Js, reverse=True) and min(Js) == 1
        cols = [(b, c) for b, J, c0 in s.strip_blocks if c0 < N
                for c in range(c0, min(c0 + width, N))]
        assert sorted(cols) == [(b, c) for b in range(B)
                                for c in range(48, N)]
        assert all(c0 // 48 == J for _, J, c0 in s.strip_blocks)


def test_schedule_widths_at_the_main_path_shapes():
    """N = 384: each width the kernel picks there (48 at B = 32, 16 at
    B = 16, 8 below, in float64 on an H100) gives B * 7 * 48 / W strip
    blocks; the longest strip streams each of its 28 tiles of T once and
    the 7 inverted diagonal tiles, one per step."""
    for B, width in ((32, 48), (16, 16), (8, 8), (1, 8)):
        s = K.schedule(B, 384, width)
        assert len(s.strip_blocks) == B * 7 * 48 // width
    stream = K.chunk_stream(7)
    assert len(stream) == 35
    assert sorted(c for c in stream if c[1] > c[0]) == [
        (i, k) for i in range(7) for k in range(i + 1, 8)]
    assert [c for c in stream if c[0] == c[1]] == [(i, i) for i in
                                                   range(6, -1, -1)]
    with pytest.raises(ValueError):
        K.schedule(1, 384, 24)


@pytest.mark.parametrize("B,N", [(1, 1), (2, 5), (2, 48), (3, 50), (2, 96),
                                 (2, 384), (1, 700)])
def test_schedule_matches_jax(B, N):
    """The kernel's blocked algorithm, in its block and chunk order, against
    the JAX package's tri_inv, and against its Pallas kernel in interpret
    mode where N is a multiple of 48."""
    rng = np.random.default_rng(N + 17)
    T = well_conditioned(rng, B, N)
    ref = np.asarray(j_tri_inv(jnp.asarray(T)))
    if N % 48 == 0:
        pal = np.asarray(tri_inv_pallas(jnp.asarray(np.triu(T)),
                                        interpret=True))
    for width in (48, 16, 8):
        got = K.run_schedule(torch.from_numpy(T),
                             K.schedule(B, N, width)).numpy()
        assert np.all(np.isfinite(got))
        assert _rel(got, ref) < 1e-12
        assert np.all(np.tril(got, -1) == 0.0)
        if N % 48 == 0:
            assert _rel(got, pal) < 1e-12


@pytest.mark.parametrize("width", [48, 16, 8])
def test_schedule_every_width_on_a_ragged_tile(width):
    rng = np.random.default_rng(width)
    T = well_conditioned(rng, 2, 150)
    s = K.schedule(2, 150, width=width)
    assert s.width == width
    got = K.run_schedule(torch.from_numpy(T), s).numpy()
    ref = np.stack([np.linalg.inv(np.triu(t)) for t in T])
    assert _rel(got, ref) < 1e-12


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

