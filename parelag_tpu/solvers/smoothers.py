"""Smoothers for the AMGe hierarchy (jitted, device-resident).

The reference wraps hypre smoothers (HypreSmootherWrapper: Jacobi, L1-GS,
Chebyshev, ... ParELAG_HypreSmootherFactory.cpp:73-84) and the two-space
HiptmairSmoother (ParELAG_HiptmairSmoother.hpp:25-90). Gauss-Seidel is
inherently sequential, so the data-parallel set is:

  * l1-Jacobi  — x += r / d with d_i = sum_j |a_ij| (provably convergent
                 symmetric smoother, hypre's l1 variant)
  * Chebyshev  — degree-k polynomial in D^{-1}A over [lmax/theta, lmax]
  * Hiptmair   — primary smoother + potential-space smoothing through D:
                 x += D S_aux(D^T r)  (for H(curl)/H(div) forms)

All are pure functions over array pytrees; parameters are precomputed on
host at setup.
"""

from dataclasses import dataclass
import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from parelag_tpu.ops.device_sparse import (
    EllMatrix, from_scipy, l1_row_weights)


@jax.tree_util.register_pytree_node_class
@dataclass
class L1JacobiSmoother:
    dinv: jnp.ndarray
    sweeps: int = 1
    omega: float = 1.0

    def tree_flatten(self):
        return (self.dinv,), (self.sweeps, self.omega)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    def _d(self, b):
        return self.dinv if b.ndim == 1 else self.dinv[:, None]

    def apply(self, A: EllMatrix, b, x):
        d = self._d(b)
        for _ in range(self.sweeps):
            x = x + self.omega * d * (b - A @ x)
        return x

    def apply_zero(self, A: EllMatrix, b):
        """Smooth from a known-zero initial guess (saves one SpMV)."""
        d = self._d(b)
        x = self.omega * d * b
        for _ in range(self.sweeps - 1):
            x = x + self.omega * d * (b - A @ x)
        return x


@jax.tree_util.register_pytree_node_class
@dataclass
class ChebyshevSmoother:
    """Chebyshev over [lmax/theta, lmax] of D^{-1}A (hypre-style)."""
    dinv: jnp.ndarray
    coeffs: tuple            # static polynomial recurrence params (alpha,beta)

    def tree_flatten(self):
        return (self.dinv,), (self.coeffs,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    def apply(self, A: EllMatrix, b, x):
        lmin, lmax, degree = self.coeffs
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - A @ x)
        d = r / theta
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            x = x + d
            r = dinv * (b - A @ x)
            d = rho_new * rho * d + 2.0 * rho_new / delta * r
            rho = rho_new
        return x + d


def make_l1_jacobi(A_scipy, sweeps=1, omega=1.0) -> L1JacobiSmoother:
    d = l1_row_weights(A_scipy)
    d = np.where(d > 0, d, 1.0)
    return L1JacobiSmoother(jnp.asarray(1.0 / d), sweeps, omega)


def estimate_lmax(A_scipy, dinv, iters=20, seed=0):
    """Power iteration for lambda_max(D^{-1} A) on host."""
    rng = np.random.RandomState(seed)
    n = A_scipy.shape[0]
    x = rng.rand(n)
    A = sp.csr_matrix(A_scipy)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam)


@jax.tree_util.register_pytree_node_class
@dataclass
class BlockJacobiSmoother:
    """Damped block-Jacobi smoother over a block-contiguous permuted
    system (the facet supervariables of the hybridized multiplier
    system — see amge.hybridization._facet_blocks; point smoothers are
    near-singular on the spectral coarse multiplier systems).  `binv`
    is an ops.device_sparse.BlockDiagInverse."""
    binv: object
    sweeps: int = 1
    omega: float = 0.7

    def tree_flatten(self):
        return (self.binv,), (self.sweeps, self.omega)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    def apply(self, A, b, x):
        for _ in range(self.sweeps):
            x = x + self.omega * (self.binv @ (b - A @ x))
        return x

    def apply_zero(self, A, b):
        x = self.omega * (self.binv @ b)
        for _ in range(self.sweeps - 1):
            x = x + self.omega * (self.binv @ (b - A @ x))
        return x


def make_chebyshev(A_scipy, degree=3, ratio=0.3) -> ChebyshevSmoother:
    d = sp.csr_matrix(A_scipy).diagonal()
    d = np.where(d > 0, d, 1.0)
    dinv = 1.0 / d
    lmax = 1.1 * estimate_lmax(A_scipy, dinv)
    return ChebyshevSmoother(jnp.asarray(dinv), (ratio * lmax, lmax, degree))


@jax.tree_util.register_pytree_node_class
@dataclass
class HiptmairSmoother:
    """Two-space smoother: primary on A, auxiliary on A_aux = D^T A D
    through the potential space (reference ParELAG_HiptmairSmoother.hpp)."""
    primary: object
    aux: object
    D: EllMatrix             # potential -> form (e.g. gradient for Hcurl)
    Dt: EllMatrix
    A_aux: EllMatrix

    def tree_flatten(self):
        return (self.primary, self.aux, self.D, self.Dt, self.A_aux), ()

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        return cls(*children)

    def apply(self, A: EllMatrix, b, x):
        # forward: primary, then auxiliary-space correction
        x = self.primary.apply(A, b, x)
        r = b - A @ x
        raux = self.Dt @ r
        eaux = self.aux.apply(
            self.A_aux, raux, jnp.zeros_like(raux))
        x = x + self.D @ eaux
        x = self.primary.apply(A, b, x)
        return x


def make_hiptmair(A_scipy, D_scipy, primary_sweeps=1,
                  aux_sweeps=1) -> HiptmairSmoother:
    A = sp.csr_matrix(A_scipy)
    D = sp.csr_matrix(D_scipy)
    A_aux = (D.T @ A @ D).tocsr()
    # fix empty aux rows (e.g. eliminated-BC potentials)
    diag = A_aux.diagonal()
    fix = np.where(np.asarray(np.abs(A_aux).sum(axis=1)).ravel() == 0)[0]
    if fix.size:
        A_aux = (A_aux + sp.csr_matrix(
            (np.ones(fix.size), (fix, fix)), shape=A_aux.shape)).tocsr()
    return HiptmairSmoother(
        primary=make_l1_jacobi(A, sweeps=primary_sweeps),
        aux=make_l1_jacobi(A_aux, sweeps=aux_sweeps),
        D=from_scipy(D),
        Dt=from_scipy(D.T.tocsr()),
        A_aux=from_scipy(A_aux),
    )
