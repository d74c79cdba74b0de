"""In-jit dense nonsymmetric eigensolver for small (replicated) matrices.

``jnp.linalg.eig`` / ``lax.linalg.schur`` are CPU-only LAPACK
callbacks, so anything that needs eigenpairs of the projected
Hessenberg matrix *inside* a jitted solver — deflated restarting
(GMRES-DR), harmonic Ritz extraction — would otherwise need a host
round trip per restart. This module implements the classical dense
path with fixed shapes and ``lax`` control flow so it compiles for any
backend and runs replicated on every device, like the rest of
the small-matrix machinery (SURVEY §2 C14, ops/givens.py):

* :func:`hessenberg_reduce` — Householder similarity reduction of a
  dense matrix to upper Hessenberg form, accumulating Q (scan over
  masked full-size reflectors; O(m³) on an m ≤ ~100 matrix is
  microseconds of replicated vector work).
* :func:`hessenberg_eigvals` — explicit single-shift QR iteration with
  Wilkinson shifts, bottom-up deflation and LAPACK-style exceptional
  shifts, in complex arithmetic (a complex Schur form has no 2×2
  real-pair blocks, so the fixed-shape loop stays simple). One
  ``lax.while_loop`` whose body is two O(m²) Givens scans.
* :func:`eig_select` — eigenvalues sorted by modulus plus inverse
  iteration eigenvectors (shifted Hessenberg solves, vmapped over
  shifts) for the ``nvec`` smallest/largest, mapped back through the
  reduction's Q.

The reference has no counterpart — its README(11) only *claims* a
power-method bound; this generalizes the build's C10 answer
(solvers/lanczos.py, SPD-only ``jnp.linalg.eigh``) to the nonsymmetric
projected problems GMRES-DR needs, entirely on device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _complex_dtype(dtype):
    return jnp.complex128 if jnp.dtype(dtype) == jnp.float64 else (
        jnp.complex64 if jnp.dtype(dtype) in (jnp.float32, jnp.complex64)
        else jnp.complex128
    )


def _real_eps(cdtype):
    return jnp.finfo(jnp.zeros((), cdtype).real.dtype).eps


# ----------------------------------------------------------------------
# Householder reduction to Hessenberg form
# ----------------------------------------------------------------------
def hessenberg_reduce(a: jnp.ndarray):
    """Unitary similarity reduction A = Q H Q^H, H upper Hessenberg.

    a: (m, m) real or complex. Returns (h, q) in the promoted complex
    dtype. Fixed-shape scan over m-2 masked full-size reflectors.
    """
    m = a.shape[0]
    cdtype = _complex_dtype(a.dtype)
    a = a.astype(cdtype)
    if m <= 2:
        return a, jnp.eye(m, dtype=cdtype)
    idx = jnp.arange(m)

    def body(carry, j):
        h, q = carry
        x = h[:, j]
        mask = idx > j  # rows to fold into the reflector
        xm = jnp.where(mask, x, 0.0)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(xm) ** 2).real)
        pivot = x[j + 1]
        # alpha = -sign(pivot)*nrm with complex sign, LAPACK gehrd-style.
        psign = jnp.where(
            jnp.abs(pivot) > 0, pivot / jnp.abs(pivot),
            jnp.ones((), cdtype),
        )
        alpha = -psign * nrm
        v = xm.at[j + 1].add(-alpha)
        vnorm2 = jnp.sum(jnp.abs(v) ** 2).real
        beta = jnp.where(vnorm2 > 0, 2.0 / vnorm2, 0.0).astype(cdtype)
        # H ← P H P,  Q ← Q P  with P = I − β v vᴴ (rank-1 updates).
        w = beta * (jnp.conj(v) @ h)           # vᴴ H
        h = h - v[:, None] * w[None, :]
        w2 = beta * (h @ v)                    # H v
        h = h - w2[:, None] * jnp.conj(v)[None, :]
        wq = beta * (q @ v)
        q = q - wq[:, None] * jnp.conj(v)[None, :]
        return (h, q), None

    (h, q), _ = jax.lax.scan(
        body, (a, jnp.eye(m, dtype=cdtype)), jnp.arange(m - 2)
    )
    # Scrub sub-subdiagonal roundoff so downstream code sees exact zeros.
    h = jnp.where(idx[:, None] > idx[None, :] + 1, 0.0, h)
    return h, q


# ----------------------------------------------------------------------
# Shifted QR iteration on a complex Hessenberg matrix
# ----------------------------------------------------------------------
def _left_sweep(b, p, rhs=None):
    """One explicit QR pass: zero the subdiagonal of b for rows ≤ p.

    Returns (r, rotations) with rotations = (ar, br) per step such that
    U_j = [[conj(ar), conj(br)], [−br, ar]] acted on rows (j, j+1); if
    ``rhs`` is given it is rotated alongside (for least-squares solves).
    """
    m = b.shape[0]

    def body(carry, j):
        b, rhs = carry
        rows = jax.lax.dynamic_slice(b, (j, 0), (2, m))
        pair = jax.lax.dynamic_slice(rows, (0, j), (2, 1))[:, 0]
        aa, bb = pair[0], pair[1]
        r = jnp.sqrt((jnp.abs(aa) ** 2 + jnp.abs(bb) ** 2))
        active = (j < p) & (r > 0)
        rsafe = jnp.where(r > 0, r, 1.0)
        ar = jnp.where(active, aa / rsafe, 1.0).astype(b.dtype)
        br = jnp.where(active, bb / rsafe, 0.0).astype(b.dtype)
        new0 = jnp.conj(ar) * rows[0] + jnp.conj(br) * rows[1]
        new1 = -br * rows[0] + ar * rows[1]
        b = jax.lax.dynamic_update_slice(
            b, jnp.stack([new0, new1]), (j, 0)
        )
        if rhs is not None:
            rpair = jax.lax.dynamic_slice(rhs, (j,), (2,))
            rnew = jnp.stack([
                jnp.conj(ar) * rpair[0] + jnp.conj(br) * rpair[1],
                -br * rpair[0] + ar * rpair[1],
            ])
            rhs = jax.lax.dynamic_update_slice(rhs, rnew, (j,))
        return (b, rhs), (ar, br)

    (r, rhs_out), rots = jax.lax.scan(
        body, (b, rhs), jnp.arange(m - 1)
    )
    return r, rots, rhs_out


def _right_sweep(b, rots):
    """Apply stored rotations on the right: B ← B · U₀ᴴ … U_{m-2}ᴴ."""
    m = b.shape[0]

    def body(b, inp):
        j, ar, br = inp
        cols = jax.lax.dynamic_slice(b, (0, j), (m, 2))
        new0 = cols[:, 0] * ar + cols[:, 1] * br
        new1 = -cols[:, 0] * jnp.conj(br) + cols[:, 1] * jnp.conj(ar)
        return jax.lax.dynamic_update_slice(
            b, jnp.stack([new0, new1], axis=1), (0, j)
        ), None

    b, _ = jax.lax.scan(body, b, (jnp.arange(m - 1),) + rots)
    return b


def _wilkinson_shift(h, p):
    """Eigenvalue of the trailing active 2×2 block closest to H[p, p]."""
    a = h[p - 1, p - 1]
    b = h[p - 1, p]
    c = h[p, p - 1]
    d = h[p, p]
    delta = (a - d) * 0.5
    s = jnp.sqrt(delta * delta + b * c)
    q1 = delta + s
    q2 = delta - s
    q = jnp.where(jnp.abs(q1) >= jnp.abs(q2), q1, q2)
    mu = jnp.where(
        jnp.abs(q) > 0, d - b * c / jnp.where(jnp.abs(q) > 0, q, 1.0), d
    )
    return mu


@partial(jax.jit, static_argnames=("max_sweeps",))
def hessenberg_eigvals(h: jnp.ndarray, *, max_sweeps: int | None = None):
    """Eigenvalues of an upper-Hessenberg matrix by shifted QR.

    h: (m, m) real or complex upper Hessenberg (entries below the first
    subdiagonal are ignored). Returns (vals, converged) where vals is
    the (m,) complex eigenvalue vector (unordered) and converged is a
    bool scalar (False ⇒ the sweep budget ran out; values are then the
    current diagonal — callers should treat the decomposition as
    unavailable, e.g. fall back to an undeflated restart).
    """
    m = h.shape[0]
    cdtype = _complex_dtype(h.dtype)
    a = h.astype(cdtype)
    idx = jnp.arange(m)
    a = jnp.where(idx[:, None] > idx[None, :] + 1, 0.0, a)
    if m == 1:
        return a[0, :1], jnp.array(True)
    eps = _real_eps(cdtype)
    fro = jnp.sqrt(jnp.sum(jnp.abs(a) ** 2))
    floor = eps * jnp.maximum(fro, jnp.asarray(1.0, fro.dtype))
    if max_sweeps is None:
        max_sweeps = 30 * m

    def small_sub(a, p):
        return jnp.abs(a[p, p - 1]) <= (
            eps * (jnp.abs(a[p - 1, p - 1]) + jnp.abs(a[p, p])) + floor
        )

    def deflate(state):
        a, p = state

        def cond(st):
            a, p = st
            return (p > 0) & small_sub(a, p)

        def body(st):
            a, p = st
            return a.at[p, p - 1].set(0.0), p - 1

        return jax.lax.while_loop(cond, body, (a, p))

    def cond(state):
        a, p, it, stall = state
        return (p > 0) & (it < max_sweeps)

    def body(state):
        a, p, it, stall = state
        a, p = deflate((a, p))

        def sweep(args):
            a, p, stall = args
            mu = _wilkinson_shift(a, p)
            mu = jnp.where(
                stall >= 8,
                a[p, p] + 0.75 * jnp.abs(a[p, p - 1]).astype(cdtype),
                mu,
            )
            stall = jnp.where(stall >= 8, 0, stall)
            b = a - mu * jnp.eye(m, dtype=cdtype)
            r, rots, _ = _left_sweep(b, p)
            b = _right_sweep(r, rots)
            return b + mu * jnp.eye(m, dtype=cdtype), stall + 1

        def skip(args):
            a, _, stall = args
            return a, stall

        a, stall = jax.lax.cond(p > 0, sweep, skip, (a, p, stall))
        return a, p, it + 1, stall

    a, p, _, _ = jax.lax.while_loop(
        cond, body, (a, jnp.int32(m - 1), jnp.int32(0), jnp.int32(0))
    )
    a, p = deflate((a, p))
    return jnp.diagonal(a), p == 0


# ----------------------------------------------------------------------
# Schur decomposition (QR iteration with accumulated Q) + reordering
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("max_sweeps",))
def hessenberg_schur(h: jnp.ndarray, *, max_sweeps: int | None = None):
    """Complex Schur form H = Q T Qᴴ of an upper-Hessenberg matrix.

    Same shifted-QR engine as :func:`hessenberg_eigvals`, additionally
    accumulating the unitary similarity: each sweep's left rotations L
    give T ← L T Lᴴ, so Q ← Q Lᴴ (one extra O(m²) Givens scan per
    sweep). Returns (t, q, ok): t upper triangular with the eigenvalues
    on the diagonal (unordered), q unitary, ok bool (sweep budget
    sufficed). Needed by Krylov-Schur restarting (solvers/arnoldi.py),
    where the WANTED invariant subspace — not just eigenvalues — must
    survive the restart truncation.
    """
    m = h.shape[0]
    cdtype = _complex_dtype(h.dtype)
    a = h.astype(cdtype)
    idx = jnp.arange(m)
    a = jnp.where(idx[:, None] > idx[None, :] + 1, 0.0, a)
    q0 = jnp.eye(m, dtype=cdtype)
    if m == 1:
        return a, q0, jnp.array(True)
    eps = _real_eps(cdtype)
    fro = jnp.sqrt(jnp.sum(jnp.abs(a) ** 2))
    floor = eps * jnp.maximum(fro, jnp.asarray(1.0, fro.dtype))
    if max_sweeps is None:
        max_sweeps = 30 * m

    def small_sub(a, p):
        return jnp.abs(a[p, p - 1]) <= (
            eps * (jnp.abs(a[p - 1, p - 1]) + jnp.abs(a[p, p])) + floor
        )

    def deflate(state):
        a, p = state

        def cond(st):
            a, p = st
            return (p > 0) & small_sub(a, p)

        def body(st):
            a, p = st
            return a.at[p, p - 1].set(0.0), p - 1

        return jax.lax.while_loop(cond, body, (a, p))

    def cond(state):
        a, q, p, it, stall = state
        return (p > 0) & (it < max_sweeps)

    def body(state):
        a, q, p, it, stall = state
        a, p = deflate((a, p))

        def sweep(args):
            a, q, p, stall = args
            mu = _wilkinson_shift(a, p)
            mu = jnp.where(
                stall >= 8,
                a[p, p] + 0.75 * jnp.abs(a[p, p - 1]).astype(cdtype),
                mu,
            )
            stall = jnp.where(stall >= 8, 0, stall)
            b = a - mu * jnp.eye(m, dtype=cdtype)
            r, rots, _ = _left_sweep(b, p)
            b = _right_sweep(r, rots)
            return (b + mu * jnp.eye(m, dtype=cdtype),
                    _right_sweep(q, rots), stall + 1)

        def skip(args):
            a, q, _, stall = args
            return a, q, stall

        a, q, stall = jax.lax.cond(p > 0, sweep, skip, (a, q, p, stall))
        return a, q, p, it + 1, stall

    a, q, p, _, _ = jax.lax.while_loop(
        cond, body, (a, q0, jnp.int32(m - 1), jnp.int32(0),
                     jnp.int32(0))
    )
    a, p = deflate((a, p))
    # Scrub the strictly-lower triangle (converged ⇒ roundoff only).
    t = jnp.where(idx[:, None] > idx[None, :], 0.0, a)
    return t, q, p == 0


def schur_sort(t: jnp.ndarray, q: jnp.ndarray, key: jnp.ndarray):
    """Reorder a complex Schur form so diagonal entries appear in
    ascending `key` order (key: (m,) real, computed by the caller from
    diag(t) BEFORE the call — e.g. -|λ| for largest-modulus-first).

    Bubble-sort network of adjacent swaps (LAPACK ztrexc-style): to
    swap the block [[a, c],[0, d]], rotate with the unitary G whose
    first column is the block's unit eigenvector [c, d−a] for d; then
    Gᴴ·block·G = [[d, c'],[0, a]]. Each swap updates two rows, two
    columns, q's two columns, and the key pair — all fixed-shape
    dynamic slices inside a scan of m(m−1)/2 steps; keys ride along so
    the network needs no re-sorting passes.
    """
    m = t.shape[0]
    if m == 1:
        return t, q
    cdtype = t.dtype

    def swap_at(args, j):
        t, q, key = args
        a = t[j, j]
        c = t[j, j + 1]
        d = t[j + 1, j + 1]
        do = key[j] > key[j + 1]
        y1, y2 = c, d - a
        nrm = jnp.sqrt(jnp.abs(y1) ** 2 + jnp.abs(y2) ** 2)
        # Degenerate (already decoupled & equal): identity rotation.
        ok = do & (nrm > 0)
        nsafe = jnp.where(nrm > 0, nrm, 1.0)
        g11 = jnp.where(ok, y1 / nsafe, 1.0).astype(cdtype)
        g21 = jnp.where(ok, y2 / nsafe, 0.0).astype(cdtype)
        # G = [[g11, -conj(g21)], [g21, conj(g11)]]
        # rows j, j+1: T ← Gᴴ T
        rows = jax.lax.dynamic_slice(t, (j, 0), (2, m))
        r0 = jnp.conj(g11) * rows[0] + jnp.conj(g21) * rows[1]
        r1 = -g21 * rows[0] + g11 * rows[1]
        t = jax.lax.dynamic_update_slice(t, jnp.stack([r0, r1]), (j, 0))
        # cols j, j+1: T ← T G, Q ← Q G
        cols = jax.lax.dynamic_slice(t, (0, j), (m, 2))
        c0 = cols[:, 0] * g11 + cols[:, 1] * g21
        c1 = -cols[:, 0] * jnp.conj(g21) + cols[:, 1] * jnp.conj(g11)
        t = jax.lax.dynamic_update_slice(
            t, jnp.stack([c0, c1], axis=1), (0, j)
        )
        qc = jax.lax.dynamic_slice(q, (0, j), (m, 2))
        q0c = qc[:, 0] * g11 + qc[:, 1] * g21
        q1c = -qc[:, 0] * jnp.conj(g21) + qc[:, 1] * jnp.conj(g11)
        q = jax.lax.dynamic_update_slice(
            q, jnp.stack([q0c, q1c], axis=1), (0, j)
        )
        # scrub the subdiagonal the swap zeroed analytically
        t = t.at[j + 1, j].set(jnp.zeros((), cdtype))
        kj, kj1 = key[j], key[j + 1]
        key = key.at[j].set(jnp.where(do, kj1, kj))
        key = key.at[j + 1].set(jnp.where(do, kj, kj1))
        return (t, q, key), None

    js = jnp.concatenate(
        [jnp.arange(m - 1 - s) for s in range(m - 1)]
    )
    (t, q, _), _ = jax.lax.scan(swap_at, (t, q, key), js)
    return t, q


def schur_eigvec(t: jnp.ndarray, i: jnp.ndarray):
    """Unit eigenvector of upper-triangular T for its i-th diagonal
    eigenvalue (traced index): solve (T − t_ii I) y = 0 with y_i = 1,
    y_j = 0 for j > i, by masked back-substitution — fixed shapes, no
    inverse iteration."""
    m = t.shape[0]
    cdtype = t.dtype
    lam = t[i, i]
    idx = jnp.arange(m)
    eps = _real_eps(cdtype)
    scale = jnp.sqrt(jnp.sum(jnp.abs(t) ** 2)) + 1.0

    def body(y, jr):
        j = m - 1 - jr  # j runs m-1 .. 0
        rhs = -jnp.sum(jnp.where(idx > j, t[j] * y, 0.0))
        den = t[j, j] - lam
        # Perturb near-singular pivots (clustered eigenvalues) the
        # LAPACK ztrevc way, relative to the matrix scale.
        small = jnp.abs(den) < eps * scale
        den = jnp.where(small, (eps * scale).astype(cdtype), den)
        yj = jnp.where(j == i, jnp.ones((), cdtype),
                       jnp.where(j > i, jnp.zeros((), cdtype),
                                 rhs / den))
        return y.at[j].set(yj), None

    y0 = jnp.zeros((m,), cdtype)
    y, _ = jax.lax.scan(body, y0, jnp.arange(m))
    n = jnp.sqrt(jnp.sum(jnp.abs(y) ** 2))
    return y / jnp.where(n > 0, n, 1.0)


# ----------------------------------------------------------------------
# Shifted Hessenberg solve + inverse iteration
# ----------------------------------------------------------------------
def hessenberg_shifted_solve(h, lam, rhs):
    """Solve (H − λI) y = rhs for upper-Hessenberg H (complex)."""
    m = h.shape[0]
    cdtype = _complex_dtype(h.dtype)
    b = h.astype(cdtype) - lam * jnp.eye(m, dtype=cdtype)
    if m == 1:
        eps1 = _real_eps(cdtype)
        d = b[0, 0]
        dsafe = jnp.where(
            jnp.abs(d) > eps1, d, jnp.asarray(eps1, cdtype)
        )
        return rhs.astype(cdtype) / dsafe
    r, _, g = _left_sweep(b, jnp.int32(m - 1), rhs.astype(cdtype))
    eps = _real_eps(cdtype)
    scale = jnp.max(jnp.abs(r)) + jnp.asarray(1.0, eps.dtype)
    diag = jnp.diagonal(r)
    dsafe = jnp.where(
        jnp.abs(diag) > eps * scale,
        diag,
        (eps * scale).astype(cdtype),
    )
    rr = r - jnp.diag(diag) + jnp.diag(dsafe)

    def back(y, i):
        yi = (g[i] - jnp.sum(rr[i] * y)) / rr[i, i]
        return y.at[i].set(yi), None

    y0 = jnp.zeros((m,), cdtype)
    y, _ = jax.lax.scan(back, y0, jnp.arange(m - 1, -1, -1))
    return y


def hessenberg_eigvec(h, lam, *, iters: int = 3):
    """Unit eigenvector of Hessenberg H for eigenvalue ≈ lam by inverse
    iteration (shift perturbed off the exact eigenvalue)."""
    m = h.shape[0]
    cdtype = _complex_dtype(h.dtype)
    eps = _real_eps(cdtype)
    hnorm = jnp.sqrt(jnp.sum(jnp.abs(h.astype(cdtype)) ** 2))
    shift = lam + (16.0 * eps * (hnorm + jnp.abs(lam))).astype(cdtype)
    # Deterministic non-degenerate start (no RNG inside solvers).
    v = (1.0 + 0.25 * jnp.sin(jnp.arange(m, dtype=hnorm.dtype))).astype(
        cdtype
    )

    def body(v, _):
        y = hessenberg_shifted_solve(h, shift, v)
        n = jnp.sqrt(jnp.sum(jnp.abs(y) ** 2))
        return y / jnp.where(n > 0, n, 1.0), None

    v, _ = jax.lax.scan(body, v / jnp.sqrt(jnp.asarray(m, hnorm.dtype)),
                        None, length=iters)
    return v


def eig_select(a: jnp.ndarray, nvec: int, *, which: str = "smallest",
               max_sweeps: int | None = None):
    """Sorted eigenvalues + selected eigenvectors of a small dense
    matrix, fully in-jit.

    a: (m, m) real or complex dense. nvec: number of eigenvectors
    (static). which: 'smallest' or 'largest' (by modulus) — order of
    the returned sort and of the eigenvector selection.

    Returns (vals, vecs, ok): vals (m,) complex sorted by |·|
    (ascending for 'smallest'), vecs (m, nvec) complex unit
    eigenvectors of A for vals[:nvec], ok bool (QR iteration
    converged; if False the vectors are unreliable).
    """
    if which not in ("smallest", "largest"):
        raise ValueError(f"unknown selection '{which}'")
    h, q = hessenberg_reduce(a)
    vals, ok = hessenberg_eigvals(h, max_sweeps=max_sweeps)
    order = jnp.argsort(jnp.abs(vals))
    if which == "largest":
        order = order[::-1]
    vals = vals[order]
    vecs_h = jax.vmap(lambda lam: hessenberg_eigvec(h, lam),
                      out_axes=1)(vals[:nvec])
    vecs = q @ vecs_h
    nrm = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2, axis=0))
    vecs = vecs / jnp.where(nrm > 0, nrm, 1.0)[None, :]
    return vals, vecs, ok


def smallest_invariant_subspace(
    a: jnp.ndarray, k: int, *, iters: int = 40
):
    """REAL-arithmetic approximate orthonormal basis (n, k) for the
    invariant subspace of the k smallest-|λ| eigenvalues of a REAL
    matrix: orthogonal (subspace) iteration on A⁻¹ — one
    ``solve_small`` inverse plus ``iters`` small (n, k) matmul+QR
    rounds, all replicated, NO complex arithmetic.

    Why this exists: the exact route (``eig_select`` → realified
    eigenvector columns) runs the in-jit COMPLEX QR eigensolver. On a
    runtime without a complex datapath that route cannot compile; this
    routine is the real-only alternative behind GCRO-DR's and
    GMRES-DR's ``deflation="subspace"`` option.

    Quality contract: converges to the exact invariant subspace at
    rate (|λ_k|/|λ_{k+1}|)^iters; a PARTIALLY converged span is still
    a useful deflation space (deflation degrades gracefully — the
    consumers' true-residual certification is unaffected). A complex
    conjugate pair straddling the k-cut has no k-dimensional real
    invariant subspace; the iteration then returns a span mixing the
    pair, which deflates the pair's modulus class just as well.

    Returns (z, ok): z (n, k) with orthonormal columns (zeros when
    ok=False — singular a or non-finite iterates; callers keep their
    existing fallback guards).
    """
    from gmres_tpu.ops.tri import solve_small

    n = a.shape[0]
    ai = solve_small(a, jnp.eye(n, dtype=a.dtype))
    z0 = jax.random.normal(
        jax.random.PRNGKey(7), (n, k), dtype=a.dtype
    )
    z0, _ = jnp.linalg.qr(z0, mode="reduced")

    def step(_, z):
        q, _ = jnp.linalg.qr(
            jnp.matmul(ai, z, precision=jax.lax.Precision.HIGHEST),
            mode="reduced",
        )
        return q

    z = jax.lax.fori_loop(0, iters, step, z0)
    ok = jnp.all(jnp.isfinite(z))
    return jnp.where(ok, z, jnp.zeros_like(z)), ok
