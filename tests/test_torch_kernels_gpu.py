"""The port's CUDA kernels against their plain versions, on the card.

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
                                 (2, 1), (1, 700)])
def test_tri_inv_kernel_matches_plain_version(B, N, dtype, tol):
    _need_card()
    rng = np.random.default_rng(B * 1000 + N)
    T = upper_triangles(rng, B, N, dtype)
    before = K.launches
    X = K.tri_inv(T)
    torch.cuda.synchronize()
    assert K.launches == before + 1
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
