"""Eigensolver algorithms (port of ``amgx_tpu/eigen/algorithms.py``).

Reference: ``core/src/eigensolvers/`` — POWER_ITERATION /
INVERSE_ITERATION / PAGERANK (``single_iteration_eigensolver.cu``),
SUBSPACE_ITERATION, LANCZOS, ARNOLDI, LOBPCG, JACOBI_DAVIDSON; QR and
multivector helpers (``qr.cu``).

The loops the JAX package fuses into one ``lax.while_loop`` (power
iteration, PageRank, subspace iteration, the unpreconditioned LOBPCG)
run here as eager loops on the device, one host fetch of the
convergence test per iteration, with the same arithmetic.  Blocked
products are :func:`~..ops.spmv.spmm` (one kernel launch per column).
Lanczos, Arnoldi and Jacobi–Davidson keep the JAX package's host numpy
recurrences around a device operator apply.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..device import host_scalar, to_host
from ..errors import NotImplementedError_, SolveStatus
from ..ops.spmv import spmm, spmv
from ..solvers.base import SolverFactory
from .base import EigenResult, EigenSolver, register_eigensolver


def _nrm(x):
    return torch.sqrt(torch.vdot(x, x).real)


def _status(ok: bool) -> SolveStatus:
    return SolveStatus.SUCCESS if ok else SolveStatus.NOT_CONVERGED


@register_eigensolver("POWER_ITERATION")
class PowerIterationSolver(EigenSolver):
    """Largest-|λ| eigenpair by power iteration
    (``single_iteration_eigensolver.cu`` with the plain multiply op)."""

    def _iterate_op(self, x):
        return self._op(x)

    def _solve_impl(self, x0):
        tol = self.tolerance
        x = x0 / torch.clamp(_nrm(x0), min=1e-300)
        lam = torch.zeros((), dtype=x.dtype, device=x.device)
        it, done = 0, False
        while not done and it < self.max_iters:
            y = self._iterate_op(x)
            nrm = _nrm(y)
            lam_new = torch.vdot(x, y)
            x = y / torch.clamp(nrm, min=1e-300)
            done = bool(host_scalar(torch.abs(lam_new - lam)
                                    <= tol * torch.abs(lam_new)))
            lam = lam_new
            it += 1
        lam_np = np.asarray(to_host(lam)) + self.shift
        return EigenResult(eigenvalues=np.atleast_1d(lam_np),
                           eigenvectors=to_host(x)[:, None],
                           iterations=it, status=_status(done))


@register_eigensolver("INVERSE_ITERATION")
class InverseIterationSolver(PowerIterationSolver):
    """Smallest-|λ−σ| eigenpair: power iteration on (A−σI)⁻¹ with a
    nested linear solver from config (the reference's inverse path of
    the single-iteration eigensolver)."""

    def solver_setup(self):
        self.inner = SolverFactory.allocate(self.cfg, self.scope, "solver")
        self.inner.setup(self.A if self.A is not None else self.Ad)

    def _iterate_op(self, x):
        return self.inner.apply(x)

    def _solve_impl(self, x0):
        res = super()._solve_impl(x0)
        # λ(A) = 1/λ((A−σI)⁻¹) + σ
        lam_inv = res.eigenvalues - self.shift
        with np.errstate(divide="ignore"):
            lam = np.where(lam_inv != 0, 1.0 / lam_inv, np.inf) + self.shift
        res.eigenvalues = lam
        return res


@register_eigensolver("PAGERANK")
class PageRankSolver(EigenSolver):
    """PageRank via damped power iteration on the Google matrix
    (reference ``PagerankOperator`` + pagerank_setup,
    ``amgx_eig_c.h:42``): x ← d·Pᵀx + (1−d)/n, with P the row-stochastic
    link matrix of A's pattern; the dangling pages' mass is spread
    evenly."""

    complex_refused = ("its loop carry turns real, "
                       "amgx_tpu/eigen/algorithms.py:137")

    def pagerank_setup(self, ranks=None):
        from ..core.matrix import Matrix
        from ..device import numpy_dtype
        csr = self.A.scalar_csr().astype(np.float64)
        out_deg = np.asarray(np.abs(csr).sum(axis=1)).ravel()
        dangling = out_deg == 0
        out_deg[dangling] = 1.0
        P = sp.csr_matrix(sp.diags(1.0 / out_deg) @ abs(csr))
        dt = numpy_dtype(self.Ad.dtype)
        self.PT = Matrix(sp.csr_matrix(P.T).astype(dt),
                         device=self.Ad.device).device()
        self.dangling = torch.from_numpy(dangling.astype(dt)).to(
            self.Ad.device)
        return self

    def solver_setup(self):
        self.pagerank_setup()

    def _solve_impl(self, x0):
        n = self.Ad.n
        d = self.damping
        x = torch.abs(x0)
        x = x / torch.sum(x)
        it, delta = 0, float("inf")
        while delta > self.tolerance and it < self.max_iters:
            y = d * spmv(self.PT, x) + (1.0 - d) / n
            # dangling mass redistribution
            y = y + d * torch.sum(x * self.dangling) / n
            y = y / torch.sum(y)
            delta = host_scalar(torch.sum(torch.abs(y - x)))
            x = y
            it += 1
        return EigenResult(eigenvalues=np.array([1.0]),
                           eigenvectors=to_host(x)[:, None],
                           iterations=it,
                           status=_status(delta <= self.tolerance))


def _sym_eigh(G):
    """``eigh((G + Gᵀ)/2)`` as the JAX package computes it: its ``eigh``
    symmetrises its input, ``(H + Hᴴ)/2``, which changes a complex
    ``H`` (``torch.linalg.eigh`` reads one triangle only)."""
    H = (G + G.T) / 2
    if H.is_complex():
        H = (H + H.mH) / 2
    return torch.linalg.eigh(H)


@register_eigensolver("SUBSPACE_ITERATION")
class SubspaceIterationSolver(EigenSolver):
    """Block power iteration + Rayleigh–Ritz (``subspace_iteration.cu``)."""

    complex_refused = ("its loop carry turns real, "
                       "amgx_tpu/eigen/algorithms.py:177")

    def _shifted_mm(self, X):
        Y = spmm(self.Ad, X)
        return Y - self.shift * X if self.shift else Y

    def _solve_impl(self, x0):
        k = max(self.wanted_count, 1)
        n = self.Ad.n
        m = min(2 * k + 2, n)
        rng = np.random.default_rng(1)
        X = self._to_device(rng.standard_normal((n, m)))
        X, _ = torch.linalg.qr(X)
        lam_old = torch.zeros(m, dtype=X.dtype, device=X.device)
        it, done = 0, False
        while not done and it < self.max_iters:
            Q, _ = torch.linalg.qr(self._shifted_mm(X))
            H = Q.T @ self._shifted_mm(Q)
            w, V = _sym_eigh(H)
            order = torch.argsort(-torch.abs(w))
            X = Q @ V[:, order]
            lam = w[order]
            done = bool(host_scalar(
                torch.max(torch.abs(lam[:k] - lam_old[:k]))
                <= self.tolerance * torch.clamp(
                    torch.max(torch.abs(lam[:k])), min=1e-30)))
            lam_old = lam
            it += 1
        return EigenResult(eigenvalues=to_host(lam_old)[:k] + self.shift,
                           eigenvectors=to_host(X)[:, :k],
                           iterations=it, status=_status(done))


class _HostKrylov(EigenSolver):
    """Host numpy recurrences around the device operator apply."""

    def _mv(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(to_host(self._op(self._to_device(v))),
                          dtype=np.float64)

    def _start(self, x0) -> np.ndarray:
        v = np.array(to_host(x0), dtype=np.float64)
        return v / np.linalg.norm(v)


@register_eigensolver("LANCZOS")
class LanczosSolver(_HostKrylov):
    """Symmetric Lanczos tridiagonalisation (``lanczos.cu``): m Krylov
    steps with full reorthogonalisation, then eigh of the tridiagonal."""

    def _solve_impl(self, x0):
        n = self.Ad.n
        m = min(self.max_iters, n)
        V = np.zeros((m + 1, n))
        alpha = np.zeros(m)
        beta = np.zeros(m + 1)
        V[0] = self._start(x0)
        k_done = m
        for k in range(m):
            w = self._mv(V[k])
            alpha[k] = V[k] @ w
            w = w - alpha[k] * V[k] - (beta[k] * V[k - 1] if k > 0 else 0)
            # full reorthogonalisation (the reference reorthogonalises too)
            w = w - V[:k + 1].T @ (V[:k + 1] @ w)
            beta[k + 1] = np.linalg.norm(w)
            if beta[k + 1] < 1e-12:
                k_done = k + 1
                break
            V[k + 1] = w / beta[k + 1]
        T = np.diag(alpha[:k_done]) + np.diag(beta[1:k_done], 1) + \
            np.diag(beta[1:k_done], -1)
        w_all, S = np.linalg.eigh(T)
        if self.which == "smallest":
            order = np.argsort(w_all)
        else:
            order = np.argsort(-np.abs(w_all))
        k = max(self.wanted_count, 1)
        lam = w_all[order[:k]] + self.shift
        vecs = V[:k_done].T @ S[:, order[:k]]
        return EigenResult(eigenvalues=lam, eigenvectors=vecs,
                           iterations=k_done, status=SolveStatus.SUCCESS)


@register_eigensolver("ARNOLDI")
class ArnoldiSolver(_HostKrylov):
    """Arnoldi Hessenberg factorisation for nonsymmetric spectra
    (``arnoldi.cu``), classical Gram–Schmidt with a second pass."""

    def _solve_impl(self, x0):
        n = self.Ad.n
        m = min(self.max_iters, n)
        V = np.zeros((m + 1, n))
        H = np.zeros((m + 1, m))
        V[0] = self._start(x0)
        k_done = m
        for k in range(m):
            w = self._mv(V[k])
            h = V[:k + 1] @ w
            w = w - V[:k + 1].T @ h
            h2 = V[:k + 1] @ w
            w = w - V[:k + 1].T @ h2
            H[:k + 1, k] = h + h2
            H[k + 1, k] = np.linalg.norm(w)
            if H[k + 1, k] < 1e-12:
                k_done = k + 1
                break
            V[k + 1] = w / H[k + 1, k]
        w_all, S = np.linalg.eig(H[:k_done, :k_done])
        if self.which == "smallest":
            order = np.argsort(np.abs(w_all))
        else:
            order = np.argsort(-np.abs(w_all))
        k = max(self.wanted_count, 1)
        lam = w_all[order[:k]] + self.shift
        vecs = V[:k_done].T @ np.real(S[:, order[:k]])
        return EigenResult(eigenvalues=lam, eigenvectors=vecs,
                           iterations=k_done, status=SolveStatus.SUCCESS)


@register_eigensolver("LOBPCG")
class LOBPCGSolver(EigenSolver):
    """Locally optimal block preconditioned CG
    (``lobpcg_eigensolver.cu``): blocked SpMV, a nested preconditioner
    from config and Rayleigh–Ritz on [X R P] (the ``fused`` variant, no
    preconditioner) or [X W P] with W = M·R (the host variant).

    The preconditioner is built under the JAX package's condition (a
    ``preconditioner`` or ``solver`` in the scope); a failure of its
    setup raises, where the JAX package drops the preconditioner."""

    def solver_setup(self):
        self.precond = None
        if self.cfg.has("preconditioner", self.scope) or \
                self.cfg.has("solver", self.scope):
            self.precond = SolverFactory.allocate(self.cfg, self.scope,
                                                  "preconditioner")
            self.precond.setup(self.A if self.A is not None else self.Ad)
        if self.precond is None and self.Ad.dtype.is_complex:
            # the fused loop (no preconditioner)
            raise NotImplementedError_(
                "LOBPCG without a preconditioner on a complex operator: "
                "the reference JAX package does not run it (its fused "
                "loop's carry turns real, amgx_tpu/eigen/algorithms.py:336)")

    def _shifted_mm(self, X):
        AX = spmm(self.Ad, X)
        return AX - self.shift * X if self.shift else AX

    def _x0_block(self, k: int) -> torch.Tensor:
        rng = np.random.default_rng(3)
        X0 = np.linalg.qr(rng.standard_normal((self.Ad.n, k)))[0]
        return self._to_device(X0)

    def _solve_impl(self, x0):
        if self.precond is None:
            return self._solve_impl_fused(x0)
        return self._solve_impl_host(x0)

    def _result(self, X, lam, it, converged, smallest):
        lam_np = to_host(lam)
        order = np.argsort(lam_np) if smallest else np.argsort(-lam_np)
        return EigenResult(eigenvalues=lam_np[order] + self.shift,
                           eigenvectors=to_host(X)[:, order],
                           iterations=it, status=_status(converged))

    def _solve_impl_fused(self, x0):
        """The JAX package's fused loop, eagerly: P rides as a zero block
        on the first iteration, and the step after the convergence test
        still runs (the test reads the current X)."""
        k = max(self.wanted_count, 1)
        smallest = self.which != "largest"
        X = self._x0_block(k)
        P = torch.zeros_like(X)
        lam = torch.zeros(k, dtype=X.dtype, device=X.device)
        it, done = 0, False
        while not done and it < self.max_iters:
            AX = self._shifted_mm(X)
            lam_x, U = _sym_eigh(X.T @ AX)
            X = X @ U
            AX = AX @ U
            R = AX - X * lam_x[None, :]
            rnorm = torch.linalg.vector_norm(R, dim=0)
            conv = torch.max(rnorm) <= self.tolerance * torch.clamp(
                torch.max(torch.abs(lam_x)), min=1e-30)
            Q, _ = torch.linalg.qr(torch.cat([X, R, P], dim=1))
            w_all, V = _sym_eigh(Q.T @ self._shifted_mm(Q))
            idx = (torch.argsort(w_all) if smallest
                   else torch.argsort(-w_all))[:k]
            X_new = Q @ V[:, idx]
            P = X_new - X @ (X.T @ X_new)
            X, lam = X_new, w_all[idx]
            it += 1
            done = bool(host_scalar(conv))
        return self._result(X, lam, it, done, smallest)

    def _solve_impl_host(self, x0):
        k = max(self.wanted_count, 1)
        smallest = self.which != "largest"
        X = self._x0_block(k)
        P = lam = None
        it_done, converged = 0, False
        for it in range(self.max_iters):
            AX = self._shifted_mm(X)
            lam, U = _sym_eigh(X.T @ AX)
            X = X @ U
            AX = AX @ U
            R = AX - X * lam[None, :]
            rnorm = torch.linalg.vector_norm(R, dim=0)
            it_done = it + 1
            if bool(host_scalar(torch.max(rnorm) <= self.tolerance *
                                torch.clamp(torch.max(torch.abs(lam)),
                                            min=1e-300))):
                converged = True
                break
            # the preconditioner column by column (a kernel launch per
            # column, as the JAX package loops)
            W = torch.stack([self.precond.apply(R[:, j].contiguous())
                             for j in range(R.shape[1])], dim=1)
            basis = [X, W] + ([P] if P is not None else [])
            Q, _ = torch.linalg.qr(torch.cat(basis, dim=1))
            # the unshifted product, as upstream's host loop
            w_all, V = _sym_eigh(Q.T @ spmm(self.Ad, Q))
            idx = (torch.argsort(w_all) if smallest
                   else torch.argsort(-w_all))[:k]
            X_new = Q @ V[:, idx]
            P = X_new - X @ (X.T @ X_new)
            X = X_new
        return self._result(X, lam, it_done, converged, smallest)


@register_eigensolver("JACOBI_DAVIDSON")
class JacobiDavidsonSolver(_HostKrylov):
    """Davidson method with a diagonal (Jacobi) correction preconditioner
    (``jacobi_davidson.cu`` behavioural parity)."""

    def _solve_impl(self, x0):
        n = self.Ad.n
        m_max = min(max(20, 2 * self.wanted_count + 10), n)
        diag = np.asarray(to_host(self.Ad.diag), dtype=np.float64)
        if diag.ndim > 1:
            diag = np.ones(n)
        V = np.zeros((m_max, n))
        V[0] = self._start(x0)
        m = 1
        theta = 0.0
        u = V[0]
        it_done = 0
        for it in range(self.max_iters):
            W = np.stack([self._mv(V[i]) for i in range(m)])
            H = V[:m] @ W.T
            w_all, S = np.linalg.eigh((H + H.T) / 2)
            pick = -1 if self.which == "largest" else 0
            theta = w_all[pick]
            u = V[:m].T @ S[:, pick]
            r = self._mv(u) - theta * u
            it_done = it + 1
            if np.linalg.norm(r) <= self.tolerance * max(abs(theta), 1e-300):
                break
            # Davidson correction with the diagonal preconditioner
            denom = diag - theta
            denom[np.abs(denom) < 1e-12] = 1e-12
            t = -r / denom
            t = t - V[:m].T @ (V[:m] @ t)
            nt = np.linalg.norm(t)
            if nt < 1e-14 or m >= m_max:
                # restart with the current best
                V[0] = u / np.linalg.norm(u)
                m = 1
                continue
            V[m] = t / nt
            m += 1
        return EigenResult(eigenvalues=np.array([theta + self.shift]),
                           eigenvectors=u[:, None], iterations=it_done,
                           status=_status(it_done < self.max_iters))
