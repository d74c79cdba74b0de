"""Sparse formats + SpMV (SURVEY §2 C13: CSR/COO beyond-reference
requirement). Oracle: dense matvec on the same matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gmres_tpu as gt
from gmres_tpu.ops import sparse as sp


def _random_sparse(rng, n, density=0.2):
    a = rng.standard_normal((n, n))
    a[rng.random((n, n)) > density] = 0.0
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)  # nonzero diag, DD
    return a


@pytest.fixture
def dense():
    return _random_sparse(np.random.default_rng(0), 37)


def test_csr_roundtrip_and_spmv(dense):
    a = sp.csr_from_dense(dense)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(37))
    np.testing.assert_allclose(
        sp.csr_spmv(a, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_coo_spmv(dense):
    a = sp.coo_from_dense(dense)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(37))
    np.testing.assert_allclose(
        sp.coo_spmv(a, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_ell_spmv(dense):
    a = sp.ell_from_dense(dense)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(37))
    np.testing.assert_allclose(
        sp.ell_spmv(a, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_csr_to_ell(dense):
    a = sp.csr_to_ell(sp.csr_from_dense(dense))
    x = jnp.asarray(np.ones(37))
    np.testing.assert_allclose(
        sp.ell_spmv(a, x), dense @ np.ones(37), rtol=1e-12
    )


def test_poisson_csr_matches_stencil():
    n = 12
    a = sp.poisson_csr(n)
    x = jnp.asarray(
        np.random.default_rng(4).standard_normal((n, n))
    )
    y_csr = sp.csr_spmv(a, x.reshape(-1))
    y_st = gt.poisson_apply(x).reshape(-1)
    np.testing.assert_allclose(y_csr, y_st, rtol=1e-13)


def test_poisson_csr_matches_dense_matrix():
    n = 7
    a = sp.poisson_csr(n)
    dense = np.asarray(gt.poisson_matrix(n))
    x = np.random.default_rng(5).standard_normal(n * n)
    np.testing.assert_allclose(
        sp.csr_spmv(a, jnp.asarray(x)), dense @ x, rtol=1e-13
    )


def test_bsr_jnp_spmv(dense):
    # pad to block multiple
    n = 40
    padded = np.zeros((n, n))
    padded[:37, :37] = dense
    np.fill_diagonal(padded, np.where(np.diag(padded) == 0, 1.0,
                                      np.diag(padded)))
    a = sp.bsr_from_dense(padded, block_size=8)
    x = np.random.default_rng(6).standard_normal(n)
    np.testing.assert_allclose(
        sp.bsr_spmv(a, jnp.asarray(x)), padded @ x, rtol=1e-12
    )


def test_sparse_operator_in_gmres():
    """CSR operator drives the full GMRES path end-to-end."""
    n = 10
    a = sp.poisson_csr(n)
    op = sp.sparse_operator(a)
    b = op(jnp.ones(n * n))
    res = gt.gmres(op, b, restart=30, tol=1e-10, max_restarts=50)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)


def test_sparse_operator_in_cg():
    n = 10
    a = sp.csr_to_ell(sp.poisson_csr(n))
    op = sp.sparse_operator(a)
    b = op(jnp.ones(n * n))
    res = gt.cg(op, b, tol=1e-10, max_iterations=500)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)


def test_spmv_under_jit_and_sharding():
    """ELL SpMV row-sharded over the 8-device mesh."""
    from gmres_tpu.parallel.mesh import solver_mesh

    mesh = solver_mesh(8)
    n = 16
    a = sp.csr_to_ell(sp.poisson_csr(n))
    x = jnp.ones(n * n)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("grid")
    )
    a_sh = sp.ELLMatrix(
        data=jax.device_put(
            a.data,
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("grid", None)
            ),
        ),
        cols=jax.device_put(
            a.cols,
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("grid", None)
            ),
        ),
        shape=a.shape,
    )
    x_sh = jax.device_put(x, sharding)
    y = jax.jit(lambda m, v: sp.ell_spmv(m, v))(a_sh, x_sh)
    np.testing.assert_allclose(
        y, gt.poisson_apply(x.reshape(n, n)).reshape(-1), rtol=1e-13
    )


def test_dia_from_dense(dense):
    a = sp.dia_from_dense(dense)
    x = jnp.asarray(np.random.default_rng(8).standard_normal(37))
    np.testing.assert_allclose(
        sp.dia_spmv(a, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_poisson_dia_matches_stencil():
    n = 12
    a = sp.poisson_dia(n)
    x = jnp.asarray(np.random.default_rng(9).standard_normal((n, n)))
    np.testing.assert_allclose(
        sp.dia_spmv(a, x.reshape(-1)),
        gt.poisson_apply(x).reshape(-1),
        rtol=1e-13,
    )


def test_dia_operator_in_cg():
    n = 10
    op = sp.sparse_operator(sp.poisson_dia(n))
    b = op(jnp.ones(n * n))
    res = gt.cg(op, b, tol=1e-10, max_iterations=500)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)


# ---------------------------------------------------------------------------
# HYB (DIA + ELL residue) and the Pallas DIA kernel.
# ---------------------------------------------------------------------------


def _banded_with_stragglers(rng, n=500):
    """Mostly-diagonal matrix with random straggler entries — the
    structure HYB is designed for."""
    dense = np.zeros((n, n))
    for off in (-259, -37, -1, 0, 1, 37, 130):
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    rr = rng.integers(0, n, 200)
    cc = rng.integers(0, n, 200)
    dense[rr, cc] = rng.standard_normal(200)
    return dense


def test_hyb_split_exact():
    """Every nonzero lands in exactly one part: hyb == csr == dense."""
    rng = np.random.default_rng(20)
    dense = _banded_with_stragglers(rng)
    hyb = sp.csr_to_hyb(sp.csr_from_dense(dense))
    assert hyb.ell is not None  # stragglers must be in the residue
    assert len(hyb.dia.offsets) == 7  # all 7 dense diagonals extracted
    # split accounting: dia nnz + residue nnz == total
    total_nnz = int((dense != 0).sum())
    res_nnz = int((np.asarray(hyb.ell.data) != 0).sum())
    assert hyb.nnz_dia + res_nnz == total_nnz
    x = jnp.asarray(rng.standard_normal(dense.shape[0]))
    np.testing.assert_allclose(
        sp.hyb_spmv(hyb, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_hyb_poisson_is_pure_dia():
    """A stencil matrix converts to pure DIA — no gather residue."""
    hyb = sp.csr_to_hyb(sp.poisson_csr(16))
    assert hyb.ell is None
    assert hyb.dia.offsets == (-16, -1, 0, 1, 16)
    x = jnp.asarray(np.random.default_rng(21).standard_normal(256))
    np.testing.assert_allclose(
        sp.hyb_spmv(hyb, x),
        gt.poisson_apply(x.reshape(16, 16)).reshape(-1),
        rtol=1e-12,
    )


def test_hyb_fully_random_degrades_to_ell():
    """No diagonal clears the occupancy bar on a random matrix — all
    entries stay on the gather path, result still exact."""
    rng = np.random.default_rng(22)
    dense = _random_sparse(rng, 64, density=0.05)
    np.fill_diagonal(dense, 0.0)  # kill the main diagonal too
    dense[0, 0] = 1.0
    hyb = sp.csr_to_hyb(sp.csr_from_dense(dense), min_occupancy=0.9)
    x = jnp.asarray(rng.standard_normal(64))
    np.testing.assert_allclose(
        sp.hyb_spmv(hyb, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_coo_to_hyb():
    rng = np.random.default_rng(23)
    dense = _banded_with_stragglers(rng, n=300)
    hyb = sp.coo_to_hyb(sp.coo_from_dense(dense))
    x = jnp.asarray(rng.standard_normal(300))
    np.testing.assert_allclose(
        sp.hyb_spmv(hyb, x), dense @ np.asarray(x), rtol=1e-12
    )


def test_bsr_spmv_f32_matches_dense():
    """The jnp BSR SpMV in f32 (the block matvec pins no precision on
    CPU; GPU f32 runs are covered by the same einsum)."""
    n, bs = 64, 8
    rng = np.random.default_rng(7)
    dense = _random_sparse(rng, n, density=0.15).astype(np.float32)
    a = sp.bsr_from_dense(dense, block_size=bs)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    y = sp.bsr_spmv(a, x)
    np.testing.assert_allclose(y, dense @ np.asarray(x), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("offsets_case", ["narrow", "wide", "exact128"])
def test_dia_spmv_dense_oracle(offsets_case):
    """Shift-based DIA SpMV vs the dense oracle: short offsets, long
    offsets, and offsets on multiples of 128."""
    rng = np.random.default_rng(24)
    n = 700
    offs = {
        "narrow": (-3, -1, 0, 2, 5),
        "wide": (-301, -128, -17, 0, 17, 256, 301),
        "exact128": (-256, -128, 0, 128, 256),
    }[offsets_case]
    dense = np.zeros((n, n))
    for off in offs:
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    a = sp.dia_from_dense(dense)
    assert a.offsets == tuple(sorted(offs))
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(sp.dia_spmv(a, x), dense @ np.asarray(x),
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("n", [90, 160])
def test_dia_spmv_poisson_sizes(n):
    """Poisson DIA at the grid sizes that once spanned several row
    blocks of the removed tiled kernel."""
    a = sp.poisson_dia(n)
    x = jnp.asarray(np.random.default_rng(n).standard_normal((n, n)))
    np.testing.assert_allclose(
        sp.dia_spmv(a, x.reshape(-1)), gt.poisson_apply(x).reshape(-1),
        rtol=1e-12, atol=1e-12,
    )


def test_hyb_operator_in_gmres():
    """HYB operator (auto-split from CSR) drives GMRES end-to-end."""
    n = 10
    hyb = sp.csr_to_hyb(sp.poisson_csr(n))
    op = sp.sparse_operator(hyb)
    b = op(jnp.ones(n * n))
    res = gt.gmres(op, b, restart=30, tol=1e-10, max_restarts=50)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, 1.0, atol=1e-7)


def test_hyb_sharded_parity():
    """Row-sharded HYB operator: solver iteration counts match the
    unsharded run exactly (the DIA shifts lower to collective
    permutes, the residue gather stays local per row block)."""
    from gmres_tpu.parallel.mesh import solver_mesh

    mesh = solver_mesh(8)
    n = 16
    hyb = sp.csr_to_hyb(sp.poisson_csr(n))
    op = sp.sparse_operator(hyb)
    b = op(jnp.ones(n * n))
    f = jax.jit(lambda bb: gt.cg(op, bb, tol=1e-10, max_iterations=500))
    plain = f(b)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("grid")
    )
    shard = f(jax.device_put(b, sharding))
    assert int(plain.iterations) == int(shard.iterations)
    np.testing.assert_allclose(shard.x, 1.0, atol=1e-7)
