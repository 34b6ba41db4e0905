"""The port's dense normal-equation assembly against the JAX package's, on
the CPU in float64.

Both packages sum the same 3x3 Gauss-Newton blocks; the JAX package
scatters into padded factor tables with a validity mask, the port takes
the live rows.  The order of the additions differs, so A and B are held to
1e-12 of their largest entry, not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilsam_tpu.kernels.assembly import assemble_block_dense as j_assemble

from aprilsam_tpu_torch.kernels.assembly import assemble_block_dense

torch.set_num_threads(1)


def random_graph(rng, n, nx, npri, pad, upper_only):
    """States, a random permutation as positions, and xyt/xytpos tables of
    nx/npri live factors followed by `pad` padded rows (garbage values,
    invalid).  W is SPD; with upper_only its lower triangle is zeroed, as
    the M3500 loader leaves it."""
    NCAP = n + 8
    states = np.zeros((NCAP, 3))
    states[:n] = rng.standard_normal((n, 3)) * [5.0, 5.0, 1.0]
    pos = np.arange(NCAP)
    pos[:n] = rng.permutation(n)

    def weights(k):
        L = rng.standard_normal((k, 3, 3))
        W = L @ L.transpose(0, 2, 1) + 3.0 * np.eye(3)
        W *= rng.uniform(1.0, 1e3, size=(k, 1, 1))
        return np.triu(W) if upper_only else W

    a = rng.integers(0, n, size=nx + pad)
    b = (a + rng.integers(1, n, size=nx + pad)) % n
    z = rng.standard_normal((nx + pad, 3))
    Wx = weights(nx + pad)
    pn = rng.integers(0, n, size=npri + pad)
    pz = rng.standard_normal((npri + pad, 3))
    Wp = weights(npri + pad)
    return states, pos, (a, b, z, Wx), (pn, pz, Wp)


@pytest.mark.parametrize("upper_only", [True, False])
@pytest.mark.parametrize("n,MB", [(40, 64), (200, 256)])
def test_assembly_matches_jax(n, MB, upper_only):
    rng = np.random.default_rng(n + 7 * upper_only)
    nx, npri, pad = 3 * n, 5, 11
    states, pos, (a, b, z, Wx), (pn, pz, Wp) = random_graph(
        rng, n, nx, npri, pad, upper_only)
    lp = states + 0.01 * rng.standard_normal(states.shape)

    xv = np.arange(nx + pad) < nx
    pv = np.arange(npri + pad) < npri
    A_j, B_j = j_assemble(
        jnp.asarray(lp), jnp.asarray(states), jnp.asarray(pos),
        jnp.asarray(np.where(xv, a, 0)), jnp.asarray(np.where(xv, b, 0)),
        jnp.asarray(z), jnp.asarray(Wx), jnp.asarray(xv),
        jnp.asarray(np.where(pv, pn, 0)), jnp.asarray(pz), jnp.asarray(Wp),
        jnp.asarray(pv), MB=MB, tikhonov=1e-4, dtype=jnp.float64)

    t = torch.from_numpy
    A_t, B_t = assemble_block_dense(
        t(lp), t(states), t(pos), t(a[:nx]), t(b[:nx]), t(z[:nx]),
        t(Wx[:nx]), t(pn[:npri]), t(pz[:npri]), t(Wp[:npri]), MB, 1e-4)

    assert A_t.shape == (3 * MB, 3 * MB) and B_t.shape == (3 * MB,)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(A_j).max()))
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(B_j).max()))
    A = A_t.numpy()
    np.testing.assert_array_equal(A, A.T)          # the upper mirror
    # padding rows carry tikhonov alone and stay SPD
    assert np.all(np.diag(A)[3 * n:] == 1e-4)
