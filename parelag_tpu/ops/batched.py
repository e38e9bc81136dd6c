"""Bucketed, padded, batched dense linear algebra for per-agglomerate work.

The coarsening hot loops (SURVEY.md §3.5: per-AE saddle-point factor+solve,
per-AE SVD/eigensolve) are many independent small dense problems of ragged
sizes. The device execution: bucket by padded shape, pad, and run ONE
vmapped device call per bucket (recompile count bounded by the bucket count).

Padding a linear system appends identity rows/columns and zero RHS columns,
which leaves the original solution block unchanged.
"""

import numpy as np

_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def _round_bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(-(-n // 1024) * 1024)


def batched_solve(systems, rhs, backend="auto", skip=None):
    """Solve systems[i] @ X[i] = rhs[i] for ragged lists of dense (n_i, n_i)
    matrices and (n_i, k_i) right-hand sides. Returns a list-compatible
    ragged.BlockList of (n_i, k_i) solutions.

    skip[i] truthy -> system i is not factored and out[i] = rhs[i]
    (passthrough for degenerate systems handled separately by the caller).

    backend 'host'  -> stacked LAPACK per shape group;
            'device'-> bucketed vmapped jnp.linalg.solve;
            'auto'  -> device when a non-CPU jax backend is default and the
                       batch is large enough to amortize dispatch.
    """
    from parelag_tpu.ops.ragged import BlockList
    n_items = len(systems)
    if n_items == 0:
        return []
    rsz = np.fromiter((b.shape[0] for b in rhs), np.int64, n_items)
    csz = np.fromiter((b.shape[1] for b in rhs), np.int64, n_items)
    out_off = np.zeros(n_items + 1, np.int64)
    np.cumsum(rsz * csz, out=out_off[1:])
    out_cat = np.zeros(int(out_off[-1]), dtype=np.asarray(rhs[0]).dtype)
    out = BlockList(out_cat, out_off, rsz, csz)
    if skip is None:
        skip = (False,) * n_items
    if backend == "auto":
        # auto = host; pass backend="device" explicitly to route the
        # per-AE stacks to the accelerator.  Which side wins on the H100
        # is not measured (ROADMAP: setup placement).
        backend = "host"

    def _scatter(idxs, X):
        """Vectorized write of same-shape solutions into the flat output."""
        idxs = np.asarray(idxs, np.int64)
        k = X.shape[1] * X.shape[2]
        flat = out_off[idxs][:, None] + np.arange(k, dtype=np.int64)
        out_cat[flat] = X.reshape(len(idxs), -1)

    pas = [i for i in range(n_items) if skip[i]]
    if pas:
        for i in pas:                     # passthrough: out[i] = rhs[i]
            out_cat[out_off[i]:out_off[i + 1]] = np.asarray(rhs[i]).ravel()

    if backend == "host":
        # group identical shapes and run stacked LAPACK gesv in one numpy
        # call per group (the shape distribution is highly repetitive on
        # quasi-uniform agglomerations; Python-per-system overhead dominated
        # this stage before)
        groups = {}
        for i, (A, b) in enumerate(zip(systems, rhs)):
            if skip[i] or A.shape[0] == 0 or b.shape[1] == 0:
                continue
            groups.setdefault((A.shape[0], b.shape[1]), []).append(i)
        for (n, k), idxs in groups.items():
            Ast = np.stack([systems[i] for i in idxs])
            Bst = np.stack([rhs[i] for i in idxs])
            _scatter(idxs, _host_solve_stack(Ast, Bst))
        return out

    import jax
    import jax.numpy as jnp

    buckets = {}
    for i, (A, b) in enumerate(zip(systems, rhs)):
        n, k = A.shape[0], b.shape[1]
        if skip[i] or n == 0 or k == 0:
            continue
        key = (_round_bucket(n), _round_bucket(k))
        buckets.setdefault(key, []).append(i)

    for (nb, kb), idxs in buckets.items():
        m = len(idxs)
        Ab = np.tile(np.eye(nb), (m, 1, 1))
        Bb = np.zeros((m, nb, kb))
        for j, i in enumerate(idxs):
            n, k = systems[i].shape[0], rhs[i].shape[1]
            Ab[j, :n, :n] = systems[i]
            Ab[j, :n, n:] = 0.0
            Ab[j, n:, :n] = 0.0
            Bb[j, :n, :k] = rhs[i]
        X = _device_solve_refined(Ab, Bb)
        for j, i in enumerate(idxs):
            n, k = systems[i].shape[0], rhs[i].shape[1]
            out_cat[out_off[i]:out_off[i + 1]] = X[j, :n, :k].ravel()
    return out


def solve_groups(As, Bs, backend="auto", skip=None):
    """Group-level batched solve: As[i] (m_i, n_i, n_i), Bs[i] (m_i, n_i,
    k_i) -> list of (m_i, n_i, k_i) solutions. skip[i] -> out[i] = Bs[i].
    The group-stacked twin of batched_solve (the setup engine produces
    shape-grouped stacks directly)."""
    if skip is None:
        skip = (False,) * len(As)
    if backend == "auto":
        backend = "host"     # see batched_solve: device is opt-in
    out = []
    for A, B, sk in zip(As, Bs, skip):
        if sk or A.shape[1] == 0 or B.shape[2] == 0:
            out.append(B)
            continue
        if backend == "host":
            out.append(_host_solve_stack(A, B))
        else:
            out.append(_device_solve_refined(A, B))
    return out


def _host_solve_stack(A, B):
    """Stacked host solve with min-norm-lstsq repair of (near-)singular
    members. Routes through the native batched LU (f64 accumulation —
    LAPACK per-call overhead dominates at per-AE sizes and the f32 LAPACK
    path needed frequent lstsq redo passes) with np.linalg.solve as the
    fallback."""
    from parelag_tpu.ops import native
    rtol_v = max(1e-8, 1e3 * float(np.finfo(A.dtype).eps))
    rc = 1e-12 if A.dtype == np.float64 else 1e-5
    if native.available():
        # fused solve + residual: the residual is computed in-kernel while
        # each system is cache-hot, saving the numpy batched-matmul pass
        X, hard_bad, res, bmax = native.batched_solve_res(A, B)
        scale = np.maximum(bmax, 1.0)
    else:
        hard_bad = None
        try:
            X = np.linalg.solve(A, B)
        except np.linalg.LinAlgError:
            X = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                          for a, b in zip(A, B)])
        res = np.abs(A @ X - B).max(axis=(1, 2))
        scale = np.maximum(np.abs(B).max(axis=(1, 2)), 1.0)
    bad = res > rtol_v * scale
    if hard_bad is not None:
        bad |= hard_bad
    for j in np.where(bad)[0]:
        X[j] = np.linalg.lstsq(A[j], B[j], rcond=rc)[0]
    return X


_NS_JIT = None


def _ns_inverse_batch(A32):
    """Batched approximate inverse via Newton-Schulz iteration — pure
    matmuls (no batched LU). X0 = A^T / (||A||_1 ||A||_inf)
    makes the error matrix E = I - X A contract exactly quadratically
    (E_{k+1} = E_k^2), so ~4 log2(cond) iterations reach the f32 floor."""
    global _NS_JIT
    if _NS_JIT is None:
        import jax
        import jax.numpy as jnp

        def f(A):
            n = A.shape[1]
            a1 = jnp.abs(A).sum(axis=1).max(axis=1)
            ainf = jnp.abs(A).sum(axis=2).max(axis=1)
            c = jnp.maximum(a1 * ainf, 1e-30)
            X = A.transpose(0, 2, 1) / c[:, None, None]
            I2 = 2.0 * jnp.eye(n, dtype=A.dtype)[None]

            def body(_, X):
                return X @ (I2 - A @ X)
            return jax.lax.fori_loop(0, 96, body, X)
        _NS_JIT = jax.jit(f)
    return _NS_JIT(A32)


_NSSOLVE_JIT = None


def _ns_solve_batch(A32, B32):
    """One jitted device call per shape bucket: batched f32 Newton-Schulz
    inverse (pure matmuls, no batched LU), initial solve, and 4 f32
    refinement
    sweeps ON DEVICE. Transfer-minimal: only A/B go up and Y comes back
    (the previous scheme downloaded the full inverses and ran up to 30
    host-f64 refinement GEMMs, which cost as much as solving on host)."""
    global _NSSOLVE_JIT
    import jax
    import jax.numpy as jnp
    if _NSSOLVE_JIT is None:
        def f(A, B):
            n = A.shape[1]
            a1 = jnp.abs(A).sum(axis=1).max(axis=1)
            ainf = jnp.abs(A).sum(axis=2).max(axis=1)
            c = jnp.maximum(a1 * ainf, 1e-30)
            X = A.transpose(0, 2, 1) / c[:, None, None]
            I2 = 2.0 * jnp.eye(n, dtype=A.dtype)[None]

            def body(_, X):
                return X @ (I2 - A @ X)
            X = jax.lax.fori_loop(0, 96, body, X)
            Y = X @ B

            def rbody(_, Y):
                return Y + X @ (B - A @ Y)
            return jax.lax.fori_loop(0, 4, rbody, Y)
        _NSSOLVE_JIT = jax.jit(f)
    return _NSSOLVE_JIT(A32, B32)


def _device_solve_refined(A, B, rtol=None):
    """Mixed-precision stacked solve on the accelerator: symmetric Jacobi
    equilibration on host, padded f32 batch shipped ONCE, Newton-Schulz
    inverse + solve + refinement fully on device, solutions shipped back.
    Accuracy is the f32 refinement floor (~1e-6 relative on
    well-equilibrated systems); ONE host f64 residual check routes
    genuinely failed members (cond beyond the f32 floor, pinched-saddle
    singularities) to host lstsq."""
    m, n, k = B.shape
    nb = _round_bucket(n)
    kb = _round_bucket(k)
    mb = _round_bucket(m)      # bucket batch AND size: every distinct
    #                            shape is a separate XLA compile
    # equilibrate: D A D with d_i = 1/sqrt(max_j |A_ij|)
    s = np.abs(A).max(axis=2)
    d = 1.0 / np.sqrt(np.where(s > 0, s, 1.0))
    Aeq = A * d[:, :, None] * d[:, None, :]
    Beq = B * d[:, :, None]
    Ab = np.tile(np.eye(nb, dtype=np.float32), (mb, 1, 1))
    Ab[:m, :n, :n] = Aeq.astype(np.float32)
    Bb = np.zeros((mb, nb, kb), dtype=np.float32)
    Bb[:m, :n, :k] = Beq.astype(np.float32)
    import jax.numpy as jnp
    Y = np.asarray(_ns_solve_batch(jnp.asarray(Ab), jnp.asarray(Bb)),
                   dtype=np.float64)[:m, :n, :k]

    scale = np.maximum(np.abs(Beq).max(axis=(1, 2)), 1.0)
    res = np.abs(Beq - Aeq @ Y).max(axis=(1, 2))
    bad = ~np.isfinite(res) | (res > 2e-4 * scale)
    for j in np.where(bad)[0]:
        Y[j] = np.linalg.lstsq(Aeq[j], Beq[j], rcond=1e-12)[0]
    return Y * d[:, :, None]


_SOLVE_JIT = None
_SVD_JIT = None


def _solve_batch(A, B):
    """Module-cached jitted batched solve: one compile per (shape, dtype)
    bucket for the whole process (a fresh jit closure per call would
    recompile on every dispatch)."""
    global _SOLVE_JIT
    if _SOLVE_JIT is None:
        import jax
        import jax.numpy as jnp
        _SOLVE_JIT = jax.jit(lambda A, B: jnp.linalg.solve(A, B))
    return _SOLVE_JIT(A, B)


def batched_svd_basis(mats, backend="auto"):
    """Left singular vectors + singular values for a ragged list of (n_i, k)
    matrices (the trace/null SVD stage). Returns list of (U_i, s_i)."""
    n_items = len(mats)
    if n_items == 0:
        return []
    if backend == "auto":
        backend = "host"
        if n_items >= 64 and all(m.dtype == np.float32 for m in mats[:1]):
            try:
                import jax
                if jax.default_backend() != "cpu":
                    backend = "device"
            except Exception:
                pass
    if backend == "host":
        out = []
        for T in mats:
            if T.shape[0] == 0 or T.shape[1] == 0:
                out.append((np.zeros((T.shape[0], 0)), np.zeros(0)))
            else:
                U, s, _ = np.linalg.svd(T, full_matrices=False)
                out.append((U, s))
        return out

    import jax.numpy as jnp
    import jax
    buckets = {}
    for i, T in enumerate(mats):
        n, k = T.shape
        if n == 0 or k == 0:
            continue
        buckets.setdefault((_round_bucket(n), _round_bucket(k)),
                           []).append(i)
    out = [(np.zeros((T.shape[0], 0)), np.zeros(0)) for T in mats]
    for (nb, kb), idxs in buckets.items():
        m = len(idxs)
        Tb = np.zeros((m, nb, kb))
        for j, i in enumerate(idxs):
            n, k = mats[i].shape
            Tb[j, :n, :k] = mats[i]

        global _SVD_JIT
        if _SVD_JIT is None:
            _SVD_JIT = jax.jit(
                lambda T: jnp.linalg.svd(T, full_matrices=False))
        U, s, _ = _SVD_JIT(jnp.asarray(Tb))
        U = np.asarray(U)
        s = np.asarray(s)
        for j, i in enumerate(idxs):
            n, k = mats[i].shape
            kk = min(n, k)
            out[i] = (U[j, :n, :kk], s[j, :kk])
    return out


def weighted_svd_group(Mst, Tst):
    """Stacked M-weighted SVD: Mst (m,n,n), Tst (m,n,t) ->
    (U (m,n,min(n,t)), s (m,min(n,t))) with U^T M U = I per member.
    One stacked LAPACK call for the whole group (diagonal-M fast path)."""
    m, n, t = Tst.shape
    if t == 0 or n == 0:
        return np.zeros((m, n, 0)), np.zeros((m, 0))
    d = np.einsum("bii->bi", Mst)
    offd = Mst - d[:, :, None] * np.eye(n)
    if np.count_nonzero(offd) == 0:
        sc = np.sqrt(d)                            # (m, n)
        U, s, _ = np.linalg.svd(Tst * sc[:, :, None],
                                full_matrices=False)
        U = U / sc[:, :, None]
    else:
        w, V = np.linalg.eigh(Mst)
        w = np.maximum(w, 0.0)
        sq = np.sqrt(w)
        isq = 1.0 / np.sqrt(np.maximum(w, 1e-300))
        X = np.einsum("bij,bj,bkj->bik", V, sq, V)
        Xinv = np.einsum("bij,bj,bkj->bik", V, isq, V)
        U0, s, _ = np.linalg.svd(X @ Tst, full_matrices=False)
        U = Xinv @ U0
    return U, s


def batched_weighted_svd(Ms, Ts):
    """M-weighted SVD orthonormalization for ragged lists (the trace-stage
    hot loop): returns [(U_i, s_i)] with U^T M U = I. Groups identical
    shapes and runs ONE stacked LAPACK call per group (np.linalg batches in
    C), instead of one Python-level eigh/svd per agglomerate."""
    from parelag_tpu.ops.ragged import take
    out = [None] * len(Ms)
    groups = {}
    for i, T in enumerate(Ts):
        if T.shape[1] == 0 or T.shape[0] == 0:
            out[i] = (np.zeros((T.shape[0], 0)), np.zeros(0))
            continue
        groups.setdefault(T.shape, []).append(i)
    for (n, t), idxs in groups.items():
        Mst = take(Ms, idxs, (n, n))                   # (m, n, n)
        Tst = np.stack([Ts[i] for i in idxs])          # (m, n, t)
        U, s = weighted_svd_group(Mst, Tst)
        for j, i in enumerate(idxs):
            out[i] = (U[j], s[j])
    return out


def batched_plain_svd(mats):
    """Thin-SVD (U, s) for a ragged list, one stacked LAPACK call per
    shape group (the null-bubble stage of the extensions)."""
    out = [None] * len(mats)
    groups = {}
    for i, B in enumerate(mats):
        if B.shape[0] == 0 or B.shape[1] == 0:
            out[i] = (np.zeros((B.shape[0], 0)), np.zeros(0))
            continue
        groups.setdefault(B.shape, []).append(i)
    for shape, idxs in groups.items():
        st = np.stack([mats[i] for i in idxs])
        U, sv, _ = np.linalg.svd(st, full_matrices=False)
        for j, i in enumerate(idxs):
            out[i] = (U[j], sv[j])
    return out
