"""Krylov solvers (jitted device PCG / host wrapper).

Replaces the reference KrylovSolver wrapper over mfem::CGSolver
(ParELAG_KrylovSolver.hpp:25-144). The convergence criterion matches mfem CG:
stop when r.z <= max(rtol^2 * (r0.z0), atol^2).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def pcg(matvec, b, precond=None, x0=None, rtol=1e-6, atol=1e-12,
        maxiter=500):
    """Preconditioned conjugate gradients, jit-friendly.

    matvec/precond: callables on device vectors. Returns (x, info) where
    info = (niter, final r.z).
    """
    if precond is None:
        precond = lambda r: r
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    d = z
    # columnwise dots: b may be (n,) or (n, s) for multi-RHS — the loop
    # then runs a simultaneous CG with per-column alpha/beta until every
    # column converges
    dot = lambda u, v: jnp.sum(u * v, axis=0)
    nom0 = dot(r, z)
    tol2 = jnp.maximum(rtol * rtol * nom0, atol * atol)

    def cond(state):
        x, r, z, d, nom, it = state
        return jnp.any(nom > tol2) & (it < maxiter)

    def body(state):
        x, r, z, d, nom, it = state
        Ad = matvec(d)
        dAd = dot(d, Ad)
        alpha = nom / jnp.where(dAd != 0, dAd, 1.0)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        nom_new = dot(r, z)
        beta = nom_new / jnp.where(nom != 0, nom, 1.0)
        d = z + beta * d
        return x, r, z, d, nom_new, it + 1

    x, r, z, d, nom, it = jax.lax.while_loop(
        cond, body, (x, r, z, d, nom0, jnp.asarray(0)))
    return x, (it, nom)


def minres(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
           maxiter=500):
    """Jitted preconditioned MINRES (Paige-Saunders Lanczos recurrence with
    Givens rotations, the Elman-Silvester-Wathen PMINRES formulation).

    Matches the reference Krylov dispatch's hypre/mfem MINRES
    (ParELAG_KrylovSolver.cpp:42-61): symmetric (possibly indefinite)
    operator, SPD preconditioner. Returns (x, (niter, |eta|)) where |eta|
    is the preconditioned residual norm estimate."""
    if precond is None:
        precond = lambda r: r
    x = jnp.zeros_like(b) if x0 is None else x0
    v1 = b - matvec(x)
    z1 = precond(v1)
    gamma1 = jnp.sqrt(jnp.maximum(jnp.vdot(v1, z1).real, 0.0))
    tol = jnp.maximum(rtol * gamma1, atol)
    v0 = jnp.zeros_like(b)
    w0 = jnp.zeros_like(b)
    w1 = jnp.zeros_like(b)
    eta = gamma1
    gamma0 = jnp.asarray(1.0, dtype=b.dtype)
    c0 = c1 = jnp.asarray(1.0, dtype=b.dtype)
    s0 = s1 = jnp.asarray(0.0, dtype=b.dtype)

    def cond(st):
        (x, v0, v1, z1, w0, w1, gamma0, gamma1,
         c0, c1, s0, s1, eta, it) = st
        return (jnp.abs(eta) > tol) & (it < maxiter) & (gamma1 > 0)

    def body(st):
        (x, v0, v1, z1, w0, w1, gamma0, gamma1,
         c0, c1, s0, s1, eta, it) = st
        g1 = jnp.where(gamma1 != 0, gamma1, 1.0)
        z = z1 / g1
        Az = matvec(z)
        delta = jnp.vdot(z, Az).real.astype(b.dtype)
        g0 = jnp.where(gamma0 != 0, gamma0, 1.0)
        v2 = Az - (delta / g1) * v1 - (gamma1 / g0) * v0
        z2 = precond(v2)
        gamma2 = jnp.sqrt(jnp.maximum(jnp.vdot(v2, z2).real, 0.0)
                          ).astype(b.dtype)
        a0 = c1 * delta - c0 * s1 * gamma1
        a1 = jnp.sqrt(a0 * a0 + gamma2 * gamma2)
        a2 = s1 * delta + c0 * c1 * gamma1
        a3 = s0 * gamma1
        a1s = jnp.where(a1 != 0, a1, 1.0)
        c2 = a0 / a1s
        s2 = gamma2 / a1s
        w2 = (z - a3 * w0 - a2 * w1) / a1s
        x = x + (c2 * eta) * w2
        eta = -s2 * eta
        return (x, v1, v2, z2, w1, w2, gamma1, gamma2,
                c1, c2, s1, s2, eta, it + 1)

    st = (x, v0, v1, z1, w0, w1, gamma0, gamma1,
          c0, c1, s0, s1, eta, jnp.asarray(0))
    st = jax.lax.while_loop(cond, body, st)
    return st[0], (st[13], jnp.abs(st[12]))


def bicgstab(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
             maxiter=500):
    """Jitted preconditioned BiCGSTAB (van der Vorst), right-preconditioned
    like mfem's BiCGSTABSolver in the reference Krylov dispatch
    (ParELAG_KrylovSolver.cpp:42-61). Returns (x, (niter, ||r||^2))."""
    if precond is None:
        precond = lambda r: r
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    nrm2 = jnp.vdot(r, r).real
    tol2 = jnp.maximum(rtol * rtol * nrm2, atol * atol)
    rho = alpha = omega = jnp.asarray(1.0, dtype=b.dtype)
    v = jnp.zeros_like(b)
    p = jnp.zeros_like(b)

    def cond(st):
        x, r, p, v, rho, alpha, omega, res2, it, ok = st
        return (res2 > tol2) & (it < maxiter) & ok

    def body(st):
        x, r, p, v, rho, alpha, omega, res2, it, ok = st
        rho_new = jnp.vdot(rhat, r).real.astype(b.dtype)
        denom_r = jnp.where(rho != 0, rho, 1.0)
        denom_o = jnp.where(omega != 0, omega, 1.0)
        beta = (rho_new / denom_r) * (alpha / denom_o)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        rv = jnp.vdot(rhat, v).real.astype(b.dtype)
        alpha = rho_new / jnp.where(rv != 0, rv, 1.0)
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = jnp.vdot(t, t).real.astype(b.dtype)
        omega = jnp.vdot(t, s).real.astype(b.dtype) \
            / jnp.where(tt != 0, tt, 1.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        res2 = jnp.vdot(r, r).real
        # breakdown guard: rho or omega collapsing ends the iteration
        ok = jnp.isfinite(res2) & (jnp.abs(rho_new) > 0)
        return x, r, p, v, rho_new, alpha, omega, res2, it + 1, ok

    st = (x, r, p, v, rho, alpha, omega, nrm2, jnp.asarray(0),
          jnp.asarray(True))
    st = jax.lax.while_loop(cond, body, st)
    return st[0], (st[8], st[7])


def gmres(matvec, b, precond=None, x0=None, rtol=1e-6, atol=0.0,
          restart=30, max_restarts=20):
    """Jitted right-preconditioned restarted GMRES(m).

    The Arnoldi loop runs as a lax.fori_loop over a fixed-size Krylov basis
    (static shapes); the restart loop is a while_loop on the residual norm.
    Replaces mfem::GMRESSolver in the reference KrylovSolver wrapper.
    """
    if precond is None:
        precond = lambda r: r
    n = b.shape[0]
    m = min(restart, n)
    x = jnp.zeros_like(b) if x0 is None else x0
    b_norm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * b_norm, atol)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=b.dtype)
        H = jnp.zeros((m + 1, m), dtype=b.dtype)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))

        def body(j, carry):
            V, H = carry
            w = matvec(precond(V[j]))
            # modified Gram-Schmidt
            def mgs(i, wh):
                w, h = wh
                hij = jnp.where(i <= j, w @ V[i], 0.0)
                return w - hij * V[i], h.at[i].set(hij)
            w, hcol = jax.lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros(m + 1, dtype=b.dtype)))
            hj1 = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hj1)
            V = V.at[j + 1].set(w / jnp.where(hj1 > 1e-30, hj1, 1.0))
            H = H.at[:, j].set(hcol)
            return V, H

        V, H = jax.lax.fori_loop(0, m, body, (V, H))
        # least squares: min || beta e1 - H y ||
        e1 = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1)
        dx = precond(V[:m].T @ y)
        return x + dx

    def cond(state):
        x, it = state
        r = b - matvec(x)
        return (jnp.linalg.norm(r) > tol) & (it < max_restarts)

    def body(state):
        x, it = state
        return arnoldi_cycle(x), it + 1

    x, it = jax.lax.while_loop(cond, body, (x, jnp.asarray(0)))
    return x, (it, jnp.linalg.norm(b - matvec(x)))


def make_pcg_stepper(matvec, precond=None, steps_per_sync=2):
    """Host-driven PCG: one jitted CG step (matvec + preconditioner +
    vector updates), convergence checked on host every `steps_per_sync`
    steps. Use when the operator's XLA graph compiles poorly inside
    lax.while_loop (a host loop around a jitted step compiles the step
    alone).
    Same stopping rule as pcg (r.z <= max(rtol^2 * nom0, atol^2); mfem
    IterativeSolver semantics). Returns solve(b, rtol, atol, maxiter) ->
    (x, (niter, final r.z))."""
    if precond is None:
        precond = lambda r: r

    @jax.jit
    def init(b):
        z = precond(b)
        return jnp.zeros_like(b), b, z, z, b @ z

    @jax.jit
    def step(x, r, z, d, nom):
        Ad = matvec(d)
        alpha = nom / (d @ Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        nom_new = r @ z
        d = z + (nom_new / nom) * d
        return x, r, z, d, nom_new

    def solve(b, rtol=1e-6, atol=0.0, maxiter=500):
        state = init(b)
        nom = float(state[-1])
        tol2 = max(rtol * rtol * nom, atol * atol)
        it = 0
        while nom > tol2 and it < maxiter:
            for _ in range(min(steps_per_sync, maxiter - it)):
                state = step(*state)
                it += 1
            nom = float(state[-1])
        return state[0], (it, nom)

    return solve


def pcg_host(A_scipy, b, precond=None, rtol=1e-6, atol=1e-12, maxiter=500):
    """Host-convenience wrapper: scipy matrix in, numpy solution out."""
    from parelag_tpu.ops.device_sparse import from_scipy
    A = from_scipy(A_scipy, dtype=np.float64)
    bj = jnp.asarray(b)
    x, info = pcg(A.matvec, bj, precond=precond, rtol=rtol, atol=atol,
                  maxiter=maxiter)
    return np.asarray(x), info
