"""GMRES-polynomial preconditioning (Loe & Morgan 2021 style).

The nonsymmetric analogue of the deep Chebyshev preconditioner
(precond/chebyshev.py): Chebyshev needs a REAL spectral interval, so
it covers SPD operators and (via the Manteuffel ellipse transform)
mildly complex smoothing spectra — but as a full preconditioner it has
no nonsymmetric story. The degree-d GMRES residual polynomial does:
its roots are the harmonic Ritz values of A (the roots GMRES itself
would place), and the induced s(z) = (1 − Π(1 − z/θᵢ))/z is a
polynomial approximation of A⁻¹ tailored to A's actual spectrum,
complex parts and all.

Why this matters on a device mesh: applying s(A) is d operator
applications and ZERO reductions — the same latency shape as the
Chebyshev cycle (SURVEY §3.3's all-reduce tax avoided). A
GMRES(m)+poly(d) solve pays GMRES's per-iteration collectives once
per d operator applications.

Setup: one d-step Arnoldi (solvers/lanczos.py:arnoldi_hessenberg, a
handful of matvecs) + a (d, d) host-side harmonic Ritz eigensolve —
once per preconditioner build. Application: the product form is
evaluated root-by-root in MODIFIED LEJA ORDER (max-product ordering;
adjacent conjugate pairs), the standard stabilization — a naive
ordering overflows by ~10^30 past degree ~20. Conjugate pairs are
fused into real quadratic segments, so real operators stay in real
arithmetic throughout:

    pair (θ, θ̄):  y += (2·Re θ)/|θ|²·w − 1/|θ|²·(A w)
                  w ← w − (2·Re θ)/|θ|²·(A w) + 1/|θ|²·A(A w)

Degree sizing, learned by measurement: the polynomial must place roots
near the WHOLE spectrum, and for the grid operators the smallest
eigenvalues scale like h², so the required degree grows like 1/h —
deg 24 collapses convdiff 64² (448 → 15 iterations) but DIVERGES at
256² on every backend (|1 − z·s(z)| > 1 over the unreached lower
spectrum; the failure mode
tests/test_polynomial.py::test_degree_too_low pins). For fine grids
use the multigrid cycles or pair the polynomial with deflation; this
preconditioner's regime is clustered/moderate spectra where its
zero-reduction application shines.

No reference counterpart (the reference's only preconditioner is the
degree-2 Chebyshev, chebyshev.f90:8-38).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from gmres_tpu.types import LinearOperator, Preconditioner


def _modified_leja(roots):
    """Order complex roots by the modified Leja rule (greedy
    max-product-of-distances), keeping conjugate pairs adjacent.
    Host-side numpy, setup-time only."""
    import numpy as np

    pts = list(roots)
    ordered = []
    # start from the largest-modulus root
    cur = max(range(len(pts)), key=lambda i: abs(pts[i]))
    while pts:
        ordered.append(pts.pop(cur))
        last = ordered[-1]
        if abs(last.imag) > 1e-14 * max(abs(last), 1.0):
            # pull the conjugate next (it must stay adjacent for the
            # real-quadratic fusion)
            j = min(
                range(len(pts)),
                key=lambda i: abs(pts[i] - np.conj(last)),
            )
            ordered.append(pts.pop(j))
        if not pts:
            break
        # greedy Leja: next root maximizes Π distance to those chosen
        # (log-sum for overflow safety)
        logs = [
            sum(np.log(max(abs(p - q), 1e-300)) for q in ordered)
            for p in pts
        ]
        cur = int(np.argmax(logs))
    return ordered


def harmonic_ritz_values(A: LinearOperator, probe, degree: int):
    """Harmonic Ritz values of A from a degree-step Arnoldi factorization
    — the roots of the degree-``degree`` GMRES residual polynomial
    (host-side numpy eigensolve at setup, like arnoldi_ritz_values)."""
    import numpy as np

    from gmres_tpu.solvers.lanczos import arnoldi_hessenberg

    h = np.asarray(arnoldi_hessenberg(A, probe, degree))
    hm = h[:degree, :degree]
    h2 = float(h[degree, degree - 1]) ** 2
    e = np.zeros(degree)
    e[-1] = 1.0
    f = np.linalg.solve(hm.conj().T, e)
    return np.linalg.eigvals(hm + h2 * np.outer(f, e))


def gmres_polynomial_preconditioner(
    A: LinearOperator,
    probe,
    degree: int = 8,
) -> Preconditioner:
    """Build M ≈ A⁻¹ as the degree-``degree`` GMRES polynomial of A.

    probe: a representative vector (e.g. the right-hand side) seeding
    the Arnoldi space whose harmonic Ritz values become the roots.
    The returned callable applies d operator applications and no
    reductions; valid for any (real) nonsymmetric A whose field of
    values excludes the origin — a root pair straddling zero makes the
    polynomial explode, which shows up immediately as divergence, not
    silently. Degrees ≳ 24 are unrolled at trace time; prefer
    moderate d with restarts (CLAUDE.md rule 6)."""
    import numpy as np

    roots = _modified_leja(harmonic_ritz_values(A, probe, degree))

    # Fuse into real segments: (is_pair, c1, c2) with
    # single: y += w/θ;            w ← w − (1/θ)·Aw
    # pair:   y += c1·w − c2·Aw;   w ← w − c1·Aw + c2·A(Aw)
    segments = []
    i = 0
    while i < len(roots):
        th = roots[i]
        if abs(th.imag) > 1e-14 * max(abs(th), 1.0):
            mod2 = float(abs(th) ** 2)
            segments.append((True, 2.0 * float(th.real) / mod2,
                             1.0 / mod2))
            i += 2
        else:
            segments.append((False, 1.0 / float(th.real), 0.0))
            i += 1

    def m_inv(r: jnp.ndarray) -> jnp.ndarray:
        w = r
        y = jnp.zeros_like(r)
        for is_pair, c1, c2 in segments:
            aw = A(w)
            if is_pair:
                y = y + c1 * w - c2 * aw
                w = w - c1 * aw + c2 * A(aw)
            else:
                y = y + c1 * w
                w = w - c1 * aw
        return y

    m_inv.roots = np.asarray(roots)
    m_inv.degree = degree
    return m_inv
