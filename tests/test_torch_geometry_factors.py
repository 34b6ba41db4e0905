"""The port's SE(2) geometry, factor evaluation and 3x3 closed forms against
the JAX package, float64, on seeded numpy inputs (rtol 1e-12: the same
formulas in the same order, so only libm rounding may differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aprilsam_tpu import factors as jf
from aprilsam_tpu import geometry as jg
from aprilsam_tpu.kernels import linalg3 as jl
from aprilsam_tpu_torch import factors as tf
from aprilsam_tpu_torch import geometry as tg
from aprilsam_tpu_torch.kernels import linalg3 as tl

torch.set_num_threads(1)

RTOL = 1e-12


def _close(port, ref, rtol=RTOL, atol=1e-13):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _poses(rng, n):
    p = rng.standard_normal((n, 3)) * np.array([10.0, 10.0, 3.0])
    return p


def _info(rng, f):
    """Random SPD information matrices, upper triangle filled only (the g2o
    loader's layout) for half of them."""
    A = rng.standard_normal((f, 3, 3))
    W = np.einsum("fki,fkj->fij", A, A) + 0.5 * np.eye(3)
    W[: f // 2] = np.triu(W[: f // 2])
    return W


def test_mod2pi_and_xyt_ops():
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    a[:8, 2] = np.array([np.pi, -np.pi, 3 * np.pi, -7.0, 7.0, 0.0, 1e-17, 50.0])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(tg.mod2pi(ta[:, 2]), jg.mod2pi(jnp.asarray(a[:, 2])))
    _close(tg.xyt_mul(ta, tb), jg.xyt_mul(jnp.asarray(a), jnp.asarray(b)))
    _close(tg.xyt_inv(ta), jg.xyt_inv(jnp.asarray(a)))
    _close(tg.xyt_inv_mul(ta, tb),
           jg.xyt_inv_mul(jnp.asarray(a), jnp.asarray(b)))
    # the numpy twins are the JAX package's numpy code
    for i in range(4):
        np.testing.assert_array_equal(tg.np_xyt_mul(a[i], b[i]),
                                      jg.np_xyt_mul(a[i], b[i]))
        np.testing.assert_array_equal(tg.np_xyt_inv_mul(a[i], b[i]),
                                      jg.np_xyt_inv_mul(a[i], b[i]))
        np.testing.assert_array_equal(tg.np_xyt_inv(a[i]), jg.np_xyt_inv(a[i]))


def test_eval_xyt_and_gn_blocks():
    rng = np.random.default_rng(1)
    N, F = 40, 96
    pts = _poses(rng, N)
    ia, ib = rng.integers(0, N, F), rng.integers(0, N, F)
    z = _poses(rng, F) * 0.1
    W = _info(rng, F)
    evj = jf.eval_xyt(jnp.asarray(pts), jnp.asarray(ia), jnp.asarray(ib),
                      jnp.asarray(z), jnp.asarray(W))
    evt = tf.eval_xyt(torch.from_numpy(pts), torch.from_numpy(ia),
                      torch.from_numpy(ib), torch.from_numpy(z),
                      torch.from_numpy(W))
    _close(evt.r, evj.r)
    _close(evt.Ja, evj.Ja)
    _close(evt.Jb, evj.Jb)
    for port, ref in zip(tf.gn_blocks_xyt(evt, torch.from_numpy(W)),
                         jf.gn_blocks_xyt(evj, jnp.asarray(W))):
        _close(port, ref)


def test_eval_xytpos():
    rng = np.random.default_rng(2)
    N, F = 30, 20
    st = _poses(rng, N)
    idx = rng.integers(0, N, F)
    z = _poses(rng, F)
    W = _info(rng, F)
    evj = jf.eval_xytpos(jnp.asarray(st), jnp.asarray(idx), jnp.asarray(z),
                         jnp.asarray(W))
    evt = tf.eval_xytpos(torch.from_numpy(st), torch.from_numpy(idx),
                         torch.from_numpy(z), torch.from_numpy(W))
    _close(evt.r, evj.r)


@pytest.mark.parametrize("F,P", [(120, 7), (0, 3), (50, 0)])
def test_graph_chi2(F, P):
    """Live-row tables in the port against the JAX package's masked
    tables (padding rows hold garbage that the mask must hide)."""
    rng = np.random.default_rng(3 + F + P)
    N = 60
    st = _poses(rng, N)
    pad = 9
    xa = rng.integers(0, N, F + pad)
    xb = rng.integers(0, N, F + pad)
    xz = _poses(rng, F + pad) * 0.2
    xW = _info(rng, F + pad)
    pn = rng.integers(0, N, P + pad)
    pz = _poses(rng, P + pad)
    pW = _info(rng, P + pad)
    ref = jf.graph_chi2(
        jnp.asarray(st), jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(xz),
        jnp.asarray(xW), jnp.asarray(pn), jnp.asarray(pz), jnp.asarray(pW),
        xyt_valid=jnp.arange(F + pad) < F, pos_valid=jnp.arange(P + pad) < P)
    t = torch.from_numpy
    got = tf.graph_chi2(t(st), t(xa[:F]), t(xb[:F]), t(xz[:F]), t(xW[:F]),
                        t(pn[:P]), t(pz[:P]), t(pW[:P]))
    _close(got, ref)


def test_chol3_and_solve_upper3():
    rng = np.random.default_rng(4)
    W = _info(rng, 64)
    W[0] = 0.0                      # the zero-W case stays finite
    W[1] = np.diag([1e4, 0.0, 0.0])  # PSD-singular prior
    for jitter in (0.0, 1e-12):
        _close(tl.chol3(torch.from_numpy(W), jitter=jitter),
               jl.chol3(jnp.asarray(W), jitter=jitter), atol=1e-12)
    R = np.triu(rng.standard_normal((64, 3, 3))) + 3 * np.eye(3)
    b = rng.standard_normal((64, 3))
    _close(tl.solve_upper3(torch.from_numpy(R), torch.from_numpy(b)),
           jl.solve_upper3(jnp.asarray(R), jnp.asarray(b)))
    # and it solves the system
    x = tl.solve_upper3(torch.from_numpy(R), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(np.einsum("fij,fj->fi", R, x), b, atol=1e-12)
