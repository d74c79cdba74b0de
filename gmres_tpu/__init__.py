"""gmres_tpu — a Krylov-subspace solver library in JAX for GPUs.

A from-scratch re-design (not a port) of the capabilities of the reference
Fortran+OpenMP library AlexanderGSC/gmres (see /root/reference):

* Restarted GMRES(m) with two Arnoldi variants:
  - Householder reflectors (Walker '84), here in *compact-WY* form so that
    reflector sweeps are matmuls with a single all-reduce
    (reference: ``src/gmres_hh.f90``).
  - Modified Gram-Schmidt with re-orthogonalization (MGS2), plus a
    fast CGS2 mode (reference: ``src/gmres_mgsr.f90``).
* CG / PCG (reference: ``src/cg.f90``), plus a pipelined
  (Ghysels-Vanroose) variant with one fused all-reduce per iteration.
* BiCGSTAB / PBiCGSTAB (reference: ``src/bicgstab.f90``).
* Communication-avoiding s-step GMRES (``sstep_gmres``): two
  collectives per s iterations via an equilibrated Gram least-squares
  cycle — no reference analogue.
* Chebyshev polynomial preconditioner of arbitrary order, with Lanczos
  spectral-bound estimation (reference: ``src/preconds/chebyshev.f90``;
  Lanczos was claimed in the reference README but absent from its code).
* MINRES for symmetric indefinite systems (Paige-Saunders), with the
  SPD shifted-Laplacian multigrid preconditioner — no reference
  analogue (the reference leaves this class to GMRES).
* Complex-operator support (conjugate-correct dots/Givens; MGSR
  GMRES), with the complex-shifted-Laplacian (Erlangga-Oosterlee-Vuik)
  multigrid preconditioner for Helmholtz — the reference is real-only.
* LOBPCG preconditioned block eigensolver (k smallest SPD eigenpairs).
* Model problems: 2-D Poisson (dense + matrix-free 5-point stencil),
  Hilbert matrix, 2-D convection-diffusion, 2-D Helmholtz (symmetric
  indefinite), 3-D Poisson (7-point stencil + 3-D multigrid)
  (reference: ``src/problems/`` — 2-D only).
* Sparse operators: CSR / COO / ELL / BSR / DIA SpMV (Pallas block-sparse kernel; gather-free DIA for banded matrices).
* SPMD distribution over a ``jax.sharding.Mesh``: vectors are sharded,
  dot products become ``psum`` all-reduces, stencil halos become
  collective-permutes — the same solver code runs from one chip to a
  multi-host slice. Pallas kernels cover the hot single-chip ops.
"""

from gmres_tpu.types import (
    SolveResult,
    GmresResult,
    EigResult,
    NewtonResult,
    SolverStatus,
)
from gmres_tpu.solvers.cg import cg
from gmres_tpu.solvers.bicgstab import bicgstab
from gmres_tpu.solvers.bicgstabl import bicgstabl
from gmres_tpu.solvers.cgs import cgs
from gmres_tpu.solvers.tfqmr import tfqmr
from gmres_tpu.solvers.qmr import qmr
from gmres_tpu.solvers.idrs import idrs
from gmres_tpu.solvers.gmres import gmres
from gmres_tpu.solvers.minres import minres
from gmres_tpu.solvers.sstep import sstep_gmres
from gmres_tpu.solvers.sstep_cg import sstep_cg
from gmres_tpu.solvers.lanczos import lanczos_bounds, power_iteration_bound
from gmres_tpu.solvers.lobpcg import lobpcg
from gmres_tpu.solvers.chebyshev import chebyshev_solve
from gmres_tpu.solvers.lsmr import lsmr
from gmres_tpu.solvers.lsqr import lsqr
from gmres_tpu.precond.chebyshev import chebyshev_preconditioner
from gmres_tpu.precond.nystrom import nystrom_preconditioner
from gmres_tpu.precond.deflation import (
    coarse_space_preconditioner,
    dirichlet_poisson_modes,
)
from gmres_tpu.precond.polynomial import gmres_polynomial_preconditioner
from gmres_tpu.precond.spai import spai_matrix, spai_preconditioner
from gmres_tpu.precond.multigrid import (
    anisotropic_multigrid_preconditioner,
    convection_diffusion_multigrid_preconditioner,
    csl_multigrid_preconditioner,
    helmholtz_shifted_laplacian_preconditioner,
    poisson3d_multigrid_preconditioner,
    poisson_multigrid_preconditioner,
)
from gmres_tpu.models.poisson import (
    poisson_matrix,
    poisson_apply,
    poisson_operator,
    poisson_spectral_bounds,
    tuned_poisson_preconditioner,
)
from gmres_tpu.models.hilbert import hilbert_matrix
from gmres_tpu.models.convection_diffusion import (
    convection_diffusion_apply,
    convection_diffusion_operator,
)
from gmres_tpu.models.helmholtz import (
    complex_to_split,
    helmholtz_apply,
    helmholtz_lambda_min,
    helmholtz_matrix,
    helmholtz_operator,
    helmholtz_split_operator,
    split_to_complex,
)
from gmres_tpu.models.poisson3d import (
    poisson3d_apply,
    poisson3d_matrix,
    poisson3d_operator,
    poisson3d_spectral_bounds,
)
from gmres_tpu.models.bratu import bratu_residual
from gmres_tpu.models.anisotropic import (
    anisotropic_apply,
    anisotropic_matrix,
    anisotropic_operator,
)
from gmres_tpu.models.varcoef import (
    varcoef_apply,
    varcoef_diagonal,
    varcoef_matrix,
    varcoef_multigrid_preconditioner,
    varcoef_operator,
)
from gmres_tpu.solvers.arnoldi import arnoldi_eigs
from gmres_tpu.solvers.krylov_schur_real import arnoldi_eigs_real
from gmres_tpu.solvers.subspace_eigs import subspace_eigs
from gmres_tpu.solvers.implicit import implicit_solve
from gmres_tpu.solvers.gcrodr import gcrodr
from gmres_tpu.solvers.newton_krylov import newton_krylov
from gmres_tpu.solvers.evolve import (
    EvolveResult,
    ExpEvolveResult,
    exponential_evolve,
    theta_evolve,
)
from gmres_tpu.solvers.funm import (
    FunmResult,
    TraceResult,
    expm_multiply,
    funm_lanczos,
    trace_funm,
)
from gmres_tpu.solvers.fgmres import fgmres
from gmres_tpu.solvers.lgmres import lgmres
from gmres_tpu.solvers.gmres_dr import gmres_dr
from gmres_tpu.solvers.block_gmres import block_gmres
from gmres_tpu.solvers.block_cg import BlockCGResult, block_cg
from gmres_tpu.ops.sparse import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
    HYBMatrix,
    bsr_from_dense,
    coo_from_dense,
    coo_to_hyb,
    csr_from_dense,
    csr_to_ell,
    csr_to_hyb,
    dia_from_dense,
    ell_from_dense,
    poisson_csr,
    poisson_dia,
    sparse_operator,
)

__all__ = [
    "SolveResult",
    "GmresResult",
    "EigResult",
    "NewtonResult",
    "SolverStatus",
    "cg",
    "bicgstab",
    "bicgstabl",
    "cgs",
    "tfqmr",
    "qmr",
    "idrs",
    "gmres",
    "minres",
    "fgmres",
    "lgmres",
    "gmres_dr",
    "block_gmres",
    "block_cg",
    "BlockCGResult",
    "sstep_gmres",
    "sstep_cg",
    "lanczos_bounds",
    "power_iteration_bound",
    "lobpcg",
    "chebyshev_solve",
    "lsmr",
    "lsqr",
    "newton_krylov",
    "theta_evolve",
    "EvolveResult",
    "exponential_evolve",
    "ExpEvolveResult",
    "funm_lanczos",
    "expm_multiply",
    "trace_funm",
    "FunmResult",
    "TraceResult",
    "bratu_residual",
    "varcoef_operator",
    "varcoef_apply",
    "varcoef_diagonal",
    "varcoef_matrix",
    "varcoef_multigrid_preconditioner",
    "arnoldi_eigs",
    "arnoldi_eigs_real",
    "subspace_eigs",
    "implicit_solve",
    "gcrodr",
    "chebyshev_preconditioner",
    "coarse_space_preconditioner",
    "nystrom_preconditioner",
    "dirichlet_poisson_modes",
    "gmres_polynomial_preconditioner",
    "spai_matrix",
    "spai_preconditioner",
    "poisson_multigrid_preconditioner",
    "anisotropic_multigrid_preconditioner",
    "anisotropic_operator",
    "anisotropic_apply",
    "anisotropic_matrix",
    "convection_diffusion_multigrid_preconditioner",
    "helmholtz_shifted_laplacian_preconditioner",
    "csl_multigrid_preconditioner",
    "poisson_matrix",
    "poisson_apply",
    "poisson_operator",
    "poisson_spectral_bounds",
    "tuned_poisson_preconditioner",
    "hilbert_matrix",
    "convection_diffusion_apply",
    "convection_diffusion_operator",
    "helmholtz_apply",
    "helmholtz_split_operator",
    "complex_to_split",
    "split_to_complex",
    "helmholtz_lambda_min",
    "helmholtz_matrix",
    "helmholtz_operator",
    "poisson3d_apply",
    "poisson3d_matrix",
    "poisson3d_operator",
    "poisson3d_spectral_bounds",
    "poisson3d_multigrid_preconditioner",
    "BSRMatrix",
    "COOMatrix",
    "CSRMatrix",
    "ELLMatrix",
    "DIAMatrix",
    "bsr_from_dense",
    "coo_from_dense",
    "csr_from_dense",
    "csr_to_ell",
    "csr_to_hyb",
    "coo_to_hyb",
    "HYBMatrix",
    "dia_from_dense",
    "ell_from_dense",
    "poisson_csr",
    "poisson_dia",
    "sparse_operator",
]

__version__ = "0.1.0"
