"""Unit tests for the numerical building blocks: Givens machinery,
masked triangular solve, compact-WY reflectors, the jnp stencils
against dense NumPy oracles, and the basis contractions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu.ops import householder as wy
from gmres_tpu.ops.flat import flat_add, flat_get, flat_set, mask_ge, mask_lt
from gmres_tpu.ops.givens import givens_init, givens_step
from gmres_tpu.ops.stencil import (
    stencil_5pt_apply,
    stencil_5pt_general,
    stencil_5pt_halo,
)
from gmres_tpu.ops.tri import masked_back_substitution


def test_flat_ops():
    x = jnp.arange(12.0).reshape(3, 4)
    assert float(flat_get(x, 5)) == 5.0
    y = flat_set(x, 5, -1.0)
    assert float(flat_get(y, 5)) == -1.0
    z = flat_add(x, 7, 10.0)
    assert float(flat_get(z, 7)) == 17.0
    np.testing.assert_allclose(
        np.asarray(mask_lt(x, 5)).reshape(-1)[5:], 0.0
    )
    np.testing.assert_allclose(
        np.asarray(mask_ge(x, 5)).reshape(-1)[:5], 0.0
    )


def test_givens_sequence_matches_numpy_qr():
    """Feeding Hessenberg columns through givens_step must triangularize
    H with the least-squares residual |g[k]| = min ‖βe₁ − H y‖."""
    rng = np.random.default_rng(5)
    m = 6
    h = np.triu(rng.standard_normal((m + 1, m)), k=-1)  # Hessenberg
    beta = 2.5
    g0 = jnp.zeros(m + 1).at[0].set(beta)
    st = givens_init(m, g0)
    hstore = jnp.zeros((m + 1, m))
    for t in range(m):
        col = jnp.zeros(m + 1).at[: t + 2].set(jnp.asarray(h[: t + 2, t]))
        st, rcol, gnext = givens_step(st, col, t)
        hstore = hstore.at[:, t].set(rcol)
    # residual of the projected LS problem
    e1 = np.zeros(m + 1)
    e1[0] = beta
    y, res, *_ = np.linalg.lstsq(h, e1, rcond=None)
    np.testing.assert_allclose(abs(float(gnext)), np.sqrt(res[0]) if res.size
                               else 0.0, rtol=1e-9)
    # rotated H is upper triangular and solves match
    ours = masked_back_substitution(hstore, st.g, m)
    np.testing.assert_allclose(np.asarray(ours), y, rtol=1e-9)


def test_masked_back_substitution_partial():
    rng = np.random.default_rng(6)
    m = 8
    r = np.triu(rng.standard_normal((m, m))) + 4 * np.eye(m)
    g = rng.standard_normal(m)
    k = 5
    h = jnp.zeros((m + 1, m)).at[:m, :].set(jnp.asarray(r))
    y = masked_back_substitution(h, jnp.zeros(m + 1).at[:m].set(g), k)
    expected = np.zeros(m)
    expected[:k] = np.linalg.solve(r[:k, :k], g[:k])
    np.testing.assert_allclose(np.asarray(y), expected, rtol=1e-12)


def test_compact_wy_matches_explicit_reflectors():
    rng = np.random.default_rng(7)
    n, k, m = 40, 5, 8
    # random unit reflectors with the Householder zero-prefix structure
    p_rows = np.zeros((m + 1, n))
    for i in range(k):
        u = np.zeros(n)
        u[i:] = rng.standard_normal(n - i)
        p_rows[i] = u / np.linalg.norm(u)

    p = jnp.zeros((m + 1, n))
    t = jnp.zeros((m + 1, m + 1))
    for i in range(k):
        p, t = wy.wy_append(p, t, jnp.asarray(p_rows[i]), i)

    v = rng.standard_normal(n)
    # explicit: Q v = (I−2p₀p₀ᵀ)···(I−2p_{k-1}p_{k-1}ᵀ) v applied
    # right-to-left
    expl = v.copy()
    for i in range(k - 1, -1, -1):
        expl -= 2.0 * p_rows[i] * (p_rows[i] @ expl)
    ours = wy.wy_apply(p, t, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(ours), expl, rtol=1e-12)

    # transpose: Qᵀ v applies left-to-right
    expl_t = v.copy()
    for i in range(k):
        expl_t -= 2.0 * p_rows[i] * (p_rows[i] @ expl_t)
    ours_t = wy.wy_apply_transpose(p, t, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(ours_t), expl_t, rtol=1e-12)


def test_wy_basis_orthonormal():
    rng = np.random.default_rng(8)
    n, k, m = 30, 6, 6
    p = jnp.zeros((m + 1, n))
    t = jnp.zeros((m + 1, m + 1))
    for i in range(k):
        u = np.zeros(n)
        u[i:] = rng.standard_normal(n - i)
        p, t = wy.wy_append(p, t, jnp.asarray(u / np.linalg.norm(u)), i)
    v = wy.wy_basis(p, t, m)
    gram = np.asarray(v @ v.T)
    np.testing.assert_allclose(gram, np.eye(m), atol=1e-12)


def test_stencil_halo_matches_global():
    """Blocked stencil with explicit halos == global stencil."""
    rng = np.random.default_rng(9)
    n = 16
    x = jnp.asarray(rng.standard_normal((n, n)))
    full = stencil_5pt_apply(x)
    half = n // 2
    zero = jnp.zeros(n)
    top_block = stencil_5pt_halo(x[:half], zero, x[half])
    bot_block = stencil_5pt_halo(x[half:], x[half - 1], zero)
    np.testing.assert_allclose(np.asarray(top_block),
                               np.asarray(full[:half]), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(bot_block),
                               np.asarray(full[half:]), rtol=1e-13)


def _dense_5pt(n, coefs):
    """Dense (n², n²) matrix of the 5-point stencil with Dirichlet
    truncation, C-order flattening (the NumPy oracle)."""
    c0, cw, ce, cs, cn = coefs
    a = np.zeros((n * n, n * n))
    for i in range(n):
        for j in range(n):
            k = i * n + j
            a[k, k] = c0
            if j > 0:
                a[k, k - 1] = cw
            if j < n - 1:
                a[k, k + 1] = ce
            if i > 0:
                a[k, k - n] = cs
            if i < n - 1:
                a[k, k + n] = cn
    return a


_COEF_SETS = {
    "laplace": (4.0, -1.0, -1.0, -1.0, -1.0),
    "convdiff": (4.0, -1.4, -0.6, -1.2, -0.8),
}


@pytest.mark.parametrize("coefs", ["laplace", "convdiff"])
@pytest.mark.parametrize("n", [75, 96, 128])
def test_stencil_general_matches_dense_oracle(n, coefs):
    """The plain jnp stencil (the only single-sweep stencil: XLA fuses
    it into one pass) against the assembled matrix, f64."""
    c = _COEF_SETS[coefs]
    x = np.random.default_rng(n).standard_normal((n, n))
    y = stencil_5pt_general(jnp.asarray(x), *c)
    np.testing.assert_allclose(
        np.asarray(y).reshape(-1), _dense_5pt(n, c) @ x.reshape(-1),
        rtol=1e-12, atol=1e-12,
    )


def _numpy_laplace(x):
    y = 4.0 * x
    y[1:, :] -= x[:-1, :]
    y[:-1, :] -= x[1:, :]
    y[:, 1:] -= x[:, :-1]
    y[:, :-1] -= x[:, 1:]
    return y


@pytest.mark.parametrize("n,k", [(64, 1), (64, 16), (200, 8),
                                 (256, 32)])
def test_chained_f64_stencil_matches_numpy(n, k):
    """k chained f64 applications (native f64 on the GPU; the
    double-double emulation this replaces targeted ~2^-48 per
    application) stay within a few ulps of NumPy's f64."""
    x = np.random.default_rng(k).standard_normal((n, n))
    ref = x.copy()
    for _ in range(k):
        ref = _numpy_laplace(ref)
    y = jax.jit(lambda v: jax.lax.fori_loop(
        0, k, lambda _, u: stencil_5pt_apply(u), v))(jnp.asarray(x))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(np.asarray(y) - ref)) / scale < 1e-14


class TestSolveSmall:
    """solve_small (ops/tri.py): the pure-jnp replacement for
    jnp.linalg.solve on small replicated systems (f64 LuDecomposition
    is F32/C64-only on some backends)."""

    def test_matches_numpy_f64(self):
        import numpy as np

        from gmres_tpu.ops.tri import solve_small

        rng = np.random.default_rng(0)
        a = rng.standard_normal((12, 12))
        b = rng.standard_normal(12)
        x = np.asarray(solve_small(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(x, np.linalg.solve(a, b),
                                   atol=1e-11)

    def test_matrix_rhs_and_complex(self):
        import numpy as np

        from gmres_tpu.ops.tri import solve_small

        rng = np.random.default_rng(1)
        a = rng.standard_normal((9, 9)) + 1j * rng.standard_normal(
            (9, 9))
        b = rng.standard_normal((9, 3)) + 1j * rng.standard_normal(
            (9, 3))
        x = np.asarray(solve_small(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(x, np.linalg.solve(a, b),
                                   atol=1e-11)

    def test_pivoting_needed(self):
        """Zero diagonal head: unpivoted elimination would divide by
        zero; partial pivoting must sail through."""
        import numpy as np

        from gmres_tpu.ops.tri import solve_small

        a = np.array([[0.0, 1.0], [1.0, 0.0]])
        b = np.array([2.0, 3.0])
        x = np.asarray(solve_small(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(x, [3.0, 2.0], atol=1e-14)

    def test_singular_nan_poisons(self):
        import numpy as np

        from gmres_tpu.ops.tri import solve_small

        a = jnp.asarray(np.ones((4, 4)))
        b = jnp.asarray(np.ones(4))
        x = np.asarray(solve_small(a, b))
        assert np.isnan(x).all()

    def test_under_jit_with_traced_operands(self):
        import numpy as np

        from gmres_tpu.ops.tri import solve_small

        rng = np.random.default_rng(2)
        a = jnp.asarray(rng.standard_normal((7, 7)))
        b = jnp.asarray(rng.standard_normal(7))
        x = jax.jit(solve_small)(a, b)
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(np.asarray(a),
                                           np.asarray(b)), atol=1e-11)


class TestRowContractCombine:
    """ops/blas.py row_contract/row_combine: the basis contractions
    equal the tensordot oracle and pin Precision.HIGHEST (no TF32 in the
    f32 Arnoldi of GMRES-IR)."""

    def _data(self, dtype, extra=()):
        import numpy as np

        rng = np.random.default_rng(5)
        rows = jnp.asarray(
            rng.standard_normal((6, 4, 5)), dtype=dtype
        )
        v = jnp.asarray(rng.standard_normal((4, 5)), dtype=dtype)
        coefs = jnp.asarray(
            rng.standard_normal((6,) + extra), dtype=dtype
        )
        return rows, v, coefs

    def test_matches_tensordot_f64(self):
        import numpy as np

        from gmres_tpu.ops.blas import row_combine, row_contract

        rows, v, coefs = self._data(jnp.float64)
        np.testing.assert_allclose(
            np.asarray(row_contract(rows, v)),
            np.tensordot(np.asarray(rows), np.asarray(v), 2),
            rtol=1e-14,
        )
        np.testing.assert_allclose(
            np.asarray(row_combine(coefs, rows)),
            np.tensordot(np.asarray(coefs), np.asarray(rows),
                         axes=(0, 0)),
            rtol=1e-14,
        )

    @pytest.mark.parametrize("which", ["contract", "combine"])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex64])
    def test_lowering_pins_highest_precision(self, which, dtype):
        """The lowered dot carries HIGHEST: on the GPU an f32 dot may
        otherwise run in TF32."""
        from gmres_tpu.ops.blas import row_combine, row_contract

        rows = jnp.zeros((6, 4, 5), dtype)
        if which == "contract":
            fn, args = row_contract, (rows, jnp.zeros((4, 5), dtype))
        else:
            fn, args = row_combine, (jnp.zeros((6,), dtype), rows)
        text = jax.jit(fn).lower(*args).as_text()
        assert "dot_general" in text
        assert "HIGHEST" in text

    def test_conj_for_complex(self):
        import numpy as np

        from gmres_tpu.ops.blas import row_contract

        rng = np.random.default_rng(7)
        rows = jnp.asarray(
            rng.standard_normal((3, 8)) + 1j * rng.standard_normal((3, 8))
        )
        v = jnp.asarray(
            rng.standard_normal(8) + 1j * rng.standard_normal(8)
        )
        np.testing.assert_allclose(
            np.asarray(row_contract(rows, v, conj=True)),
            np.conj(np.asarray(rows)) @ np.asarray(v),
            rtol=1e-13,
        )
