"""Tests for the in-jit small dense nonsymmetric eigensolver.

Oracle: ``numpy.linalg.eig`` (LAPACK) on the host — the very routine
that is a CPU-only callback and whose absence on the device this module
exists to fill.
Eigenvalue sets are compared by greedy nearest matching (complex
conjugate ordering differs between implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu.ops.hessenberg_eig import (
    eig_select,
    hessenberg_eigvals,
    hessenberg_eigvec,
    hessenberg_reduce,
    hessenberg_shifted_solve,
)


def _match_err(ref, got):
    got = list(got)
    worst = 0.0
    for v in ref:
        d = [abs(v - g) for g in got]
        i = int(np.argmin(d))
        worst = max(worst, d[i])
        got.pop(i)
    return worst


@pytest.mark.parametrize("m", [1, 2, 3, 8, 20, 40])
def test_dense_eigvals_match_lapack(m):
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, m))
    vals, vecs, ok = jax.jit(lambda x: eig_select(x, min(3, m)))(
        jnp.asarray(a)
    )
    assert bool(ok)
    assert _match_err(np.linalg.eigvals(a), np.asarray(vals)) < 1e-11
    # sorted ascending by modulus
    mods = np.abs(np.asarray(vals))
    assert np.all(np.diff(mods) >= -1e-12)


def test_eigvec_residuals():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((30, 30))
    vals, vecs, ok = eig_select(jnp.asarray(a), 5)
    a_np, vals_np, vecs_np = a, np.asarray(vals), np.asarray(vecs)
    for i in range(5):
        r = np.linalg.norm(a_np @ vecs_np[:, i] - vals_np[i] * vecs_np[:, i])
        assert r < 1e-10
        assert abs(np.linalg.norm(vecs_np[:, i]) - 1.0) < 1e-12


def test_hessenberg_reduce_similarity():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 16))
    h, q = hessenberg_reduce(jnp.asarray(a))
    h_np, q_np = np.asarray(h), np.asarray(q)
    # similarity: Q H Q^H = A
    assert np.linalg.norm(q_np @ h_np @ q_np.conj().T - a) < 1e-12
    # unitary
    assert np.linalg.norm(q_np.conj().T @ q_np - np.eye(16)) < 1e-13
    # Hessenberg structure
    assert np.max(np.abs(np.tril(h_np, -2))) == 0.0


def test_hessenberg_eigvals_direct():
    rng = np.random.default_rng(11)
    h = np.triu(rng.standard_normal((25, 25)), -1)
    vals, ok = jax.jit(hessenberg_eigvals)(jnp.asarray(h))
    assert bool(ok)
    assert _match_err(np.linalg.eigvals(h), np.asarray(vals)) < 1e-11


def test_symmetric_tridiagonal_analytic():
    # 1-D Laplacian: eigenvalues 2 - 2 cos(k pi / (m+1)), all real.
    m = 24
    t = (2.0 * np.eye(m) - np.eye(m, k=1) - np.eye(m, k=-1))
    vals, ok = hessenberg_eigvals(jnp.asarray(t))
    assert bool(ok)
    vals_np = np.sort(np.asarray(vals).real)
    exact = np.sort(2.0 - 2.0 * np.cos(np.arange(1, m + 1) * np.pi / (m + 1)))
    assert np.max(np.abs(np.asarray(vals).imag)) < 1e-12
    np.testing.assert_allclose(vals_np, exact, atol=1e-12)


def test_rotation_matrix_complex_pair():
    th = 0.7
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    vals, vecs, ok = eig_select(jnp.asarray(rot), 2)
    assert bool(ok)
    vals_np = np.asarray(vals)
    assert _match_err(
        np.array([np.exp(1j * th), np.exp(-1j * th)]), vals_np
    ) < 1e-12


def test_companion_matrix_known_roots():
    # roots of (x-1)(x-2)(x-3)(x+0.5)
    roots = np.array([1.0, 2.0, 3.0, -0.5])
    coeffs = np.poly(roots)  # leading 1
    m = 4
    c = np.zeros((m, m))
    c[0, :] = -coeffs[1:]
    c[1:, :-1] = np.eye(m - 1)
    vals, ok = hessenberg_eigvals(jnp.asarray(c))
    assert bool(ok)
    assert _match_err(roots.astype(complex), np.asarray(vals)) < 1e-10


def test_defective_jordan_block_converges():
    # Defective matrix: QR still terminates; eigenvalues accurate to
    # the defect-limited O(eps^(1/3)) bar.
    j = 2.0 * np.eye(6) + np.eye(6, k=1)
    vals, ok = hessenberg_eigvals(jnp.asarray(j))
    assert bool(ok)
    assert np.max(np.abs(np.asarray(vals) - 2.0)) < 1e-4


def test_shifted_solve_hessenberg():
    rng = np.random.default_rng(5)
    h = np.triu(rng.standard_normal((12, 12)), -1)
    lam = 0.3 + 0.1j
    rhs = rng.standard_normal(12)
    y = hessenberg_shifted_solve(
        jnp.asarray(h), jnp.asarray(lam), jnp.asarray(rhs)
    )
    res = (h - lam * np.eye(12)) @ np.asarray(y) - rhs
    assert np.linalg.norm(res) < 1e-10


def test_eigvec_inverse_iteration_close_eigs():
    # Two well-separated + one pair of close (but simple) eigenvalues.
    d = np.diag([1.0, 1.0 + 1e-5, 4.0, 9.0])
    rng = np.random.default_rng(9)
    s = rng.standard_normal((4, 4))
    a = s @ d @ np.linalg.inv(s)
    h, q = hessenberg_reduce(jnp.asarray(a))
    vals, ok = hessenberg_eigvals(h)
    assert bool(ok)
    lam = np.asarray(vals)[np.argmin(np.abs(np.asarray(vals) - 4.0))]
    v = np.asarray(q @ hessenberg_eigvec(h, jnp.asarray(lam)))
    assert np.linalg.norm(a @ v - lam * v) < 1e-8


def test_f32_path():
    rng = np.random.default_rng(13)
    a = rng.standard_normal((10, 10)).astype(np.float32)
    vals, vecs, ok = eig_select(jnp.asarray(a), 2)
    assert bool(ok)
    assert vals.dtype == jnp.complex64
    ref = np.linalg.eigvals(a.astype(np.float64))
    assert _match_err(ref, np.asarray(vals, dtype=complex)) < 1e-3


def test_largest_selection():
    a = np.diag([1.0, -5.0, 2.0, 0.5])
    vals, vecs, ok = eig_select(jnp.asarray(a), 1, which="largest")
    assert bool(ok)
    assert abs(np.asarray(vals)[0] - (-5.0)) < 1e-12
    v = np.abs(np.asarray(vecs)[:, 0])
    assert np.argmax(v) == 1


def test_bad_which_raises():
    with pytest.raises(ValueError):
        eig_select(jnp.eye(3), 1, which="middle")
