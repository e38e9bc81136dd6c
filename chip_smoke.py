"""Smoke test of parelag_tpu on NVIDIA GPUs: the setup -> solve path a
ParElag user runs, through the library's own entry points, checked
against host references.

    python chip_smoke.py           # one GPU: device, h1, kernels,
                                   # structured, spe10
    python chip_smoke.py --multi   # four GPUs: the distributed solve only

Every phase prints one JSON line with its name, its seconds, its numbers,
its checks and the device's peak bytes in use.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The run exits non-zero, without that line, when JAX finds no GPU or when
any phase fails a check.  Host f64 references that need JAX run in one
child process pinned to the CPU platform (it never opens the card); the
numpy/scipy references run in this process.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

H1_NX = 96                      # 912,673 H1 dofs, 4 levels
STRUCT_SHAPE = (32, 32, 32)     # structured-engine checks
CHUNK_SHAPE = (16, 16, 16)      # chunked-vs-whole check
SPE10_FULL = (60, 220, 85)      # published SPE10 grid (device setup)
SPE10_SMALL = (30, 55, 21)      # host-f64 comparison + multiplier solve
MULTI_GRID = (48, 48, 48)       # --multi: H1 elements over 4 ranks
N_RHS = 16


class PhaseFailed(RuntimeError):
    pass


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_phase(name, fn, *args, **kwargs):
    """Run one phase: fn returns (record, state); record["checks"] holds
    [name, value, bound, ok] rows.  Prints the phase line, then raises
    PhaseFailed if any check failed."""
    t0 = time.perf_counter()
    rec, state = fn(*args, **kwargs)
    checks = rec.pop("checks", [])
    ok = all(c[3] for c in checks)
    line = {"phase": name, "seconds": time.perf_counter() - t0, "ok": ok,
            **rec, "checks": checks, "peak_bytes_in_use": _peak_bytes()}
    print(json.dumps(line, default=_jsonable), flush=True)
    if not ok:
        bad = [c for c in checks if not c[3]]
        raise PhaseFailed(f"phase {name} failed: {bad}")
    return state


def _check(checks, name, value, bound, ok):
    checks.append([name, value, bound, bool(ok)])


def _timed(fn, *args, reps=20):
    """Mean seconds per call after a warm-up call, ended by
    block_until_ready (calls are queued back to back)."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ------------------------------------------------------------------ #
# device
# ------------------------------------------------------------------ #

def nvidia_smi():
    """The card's name and power limit, read by a child that does not
    import JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return r.stdout.strip() or r.stderr.strip()


def phase_device(n_expected):
    import jax
    from parelag_tpu.utils.compile_cache import (
        enable_persistent_compile_cache)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseFailed(
            f"no GPU: JAX found {devs[0].platform!r} devices "
            f"({devs}); this smoke test has no CPU fallback")
    cache = enable_persistent_compile_cache()
    print(json.dumps({"nvidia_smi": nvidia_smi(),
                      "jax_version": jax.__version__,
                      "XLA_FLAGS": os.environ.get("XLA_FLAGS"),
                      "compile_cache_dir": cache}), flush=True)
    checks = []
    _check(checks, "device_count", len(devs), n_expected,
           len(devs) >= n_expected)
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), checks=checks), None


# ------------------------------------------------------------------ #
# host f64 reference child (CPU platform, x64)
# ------------------------------------------------------------------ #

def start_reference(out_dir, struct_shape, spe10_cells):
    """Start the CPU-pinned f64 reference child; returns the Popen."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cfg = json.dumps(dict(struct_shape=list(struct_shape),
                          spe10_cells=list(spe10_cells)))
    log = open(os.path.join(out_dir, "reference.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--reference",
             out_dir, cfg], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    finally:
        log.close()


def wait_reference(proc, out_dir, name="reference.json", timeout=1200):
    """Wait until the child has written `name` (the structured chain's
    files come first, the SPE10 reference last) or has failed."""
    path = os.path.join(out_dir, name)
    t_end = time.monotonic() + timeout
    while not os.path.exists(path):
        rc = proc.poll()
        if rc is not None or time.monotonic() > t_end:
            if rc is None:
                proc.kill()
                proc.wait()
                rc = "timeout"
            with open(os.path.join(out_dir, "reference.log")) as f:
                tail = f.read()[-3000:]
            raise PhaseFailed(f"reference child failed ({rc}):\n{tail}")
        time.sleep(0.5)
    if name == "reference.json" and proc.wait(timeout=60) != 0:
        raise PhaseFailed("reference child exited non-zero")
    with open(path) as f:
        return json.load(f)


def _spe10_problem(cells):
    from parelag_tpu.models.spe10 import synthetic_spe10_field
    field = synthetic_spe10_field(tuple(cells), seed=0)
    coeff = field.inv_perm.mean(-1).transpose(2, 1, 0).ravel()
    return field, coeff


def _spe10_mode_counts(out):
    return dict(facet=np.asarray(out.n_facet_dofs),
                ae_u=np.asarray(out.n_ae_u_dofs),
                ae_p=np.asarray(out.n_ae_p_dofs))


def reference_main(out_dir, cfg):
    """Child: the structured chain and the SPE10 spectral setup in f64 on
    the CPU platform, written to out_dir."""
    import jax
    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "cpu":
        sys.exit("reference child must run with JAX_PLATFORMS=cpu")
    import scipy.sparse as sp
    import bench
    from parelag_tpu.amge import structured as st
    from parelag_tpu.amge import structured_spectral as sps

    rec = {}
    t0 = time.perf_counter()
    lvl0 = st.fine_level(tuple(cfg["struct_shape"]), dtype=np.float64)
    levels, outs = st.coarsen_chain(lvl0, 3, jform_start=0)
    for l, (lvl, out) in enumerate(zip(levels, outs)):
        for j in range(4):
            sp.save_npz(os.path.join(out_dir, f"P{l}_{j}.npz"),
                        st.materialize_P(out, lvl.shape, j).tocsr())
        sp.save_npz(os.path.join(out_dir, f"A{l + 1}.npz"),
                    st.h1_stiffness(levels[l + 1]).tocsr())
    rec["chain_s"] = time.perf_counter() - t0
    # the parent polls for chain.json: write it whole, then rename
    with open(os.path.join(out_dir, "chain.tmp"), "w") as f:
        json.dump(rec, f)
    os.replace(os.path.join(out_dir, "chain.tmp"),
               os.path.join(out_dir, "chain.json"))

    t0 = time.perf_counter()
    cells = tuple(cfg["spe10_cells"])
    field, coeff = _spe10_problem(cells)
    out = sps.spectral_coarsen_darcy(
        cells, bench._pick_factors(cells), coeff, h=field.sizes,
        spect_tol=0.002, max_evects=5, dtype=np.float64)
    uf = bench.spe10_fine_velocity(cells, coeff, field.sizes)
    np.save(os.path.join(out_dir, "spe10_uf.npy"), uf)
    rec["spe10"] = dict(
        coarse_u=int(out.P2.shape[1]), coarse_p=int(out.P3.shape[1]),
        u_l2_rel=bench.spe10_upscaling_error(
            cells, coeff, field.sizes, out.P2, out.P3, uf=uf),
        modes={k: v.tolist() for k, v in _spe10_mode_counts(out).items()},
        seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, "reference.tmp"), "w") as f:
        json.dump(rec, f)
    os.replace(os.path.join(out_dir, "reference.tmp"),
               os.path.join(out_dir, "reference.json"))


# ------------------------------------------------------------------ #
# h1: flagship setup -> solve
# ------------------------------------------------------------------ #

def _h1_setup(nx):
    import jax
    import jax.numpy as jnp
    import bench
    from parelag_tpu.solvers.hierarchy import build_hierarchy
    from parelag_tpu.solvers.smoothers import make_l1_jacobi
    A_levels, P_levels, b = bench._build_h1_structured(nx)
    H = build_hierarchy(
        A_levels, P_levels, lambda A, l: make_l1_jacobi(A, sweeps=2),
        dtype=np.float32, matrix_format="dia",
        transfer_dtype=jnp.bfloat16)
    jax.block_until_ready(H)
    return A_levels, P_levels, b, H


def h1_solver():
    """f32 PCG to rtol 1e-5, preconditioned by the bf16 V(2,2)-cycle."""
    import jax
    import jax.numpy as jnp
    from parelag_tpu.solvers.cg import pcg

    @jax.jit
    def solve(H, Hb, b):
        def precond(r):
            return Hb.apply(r.astype(jnp.bfloat16)).astype(jnp.float32)
        return pcg(lambda v: H.levels[0].A @ v, b, precond=precond,
                   rtol=1e-5, atol=0.0, maxiter=100)
    return solve


def phase_h1(nx):
    import jax
    import jax.numpy as jnp
    import bench
    t0 = time.perf_counter()
    A_levels, P_levels, b, H = _h1_setup(nx)
    setup_cold = time.perf_counter() - t0
    stages = bench._stage_split()
    t0 = time.perf_counter()
    _h1_setup(nx)
    setup_warm = time.perf_counter() - t0

    Hb = H.cast(jnp.bfloat16)
    solve = h1_solver()
    bj = jnp.asarray(b.astype(np.float32))
    t0 = time.perf_counter()
    x, (it, _) = jax.block_until_ready(solve(H, Hb, bj))
    solve_cold = time.perf_counter() - t0
    solve_warm = _timed(lambda: solve(H, Hb, bj)[0], reps=3)
    iters = int(it)
    A64 = A_levels[0].astype(np.float64)
    b64 = b.astype(np.float64)
    rel = float(np.linalg.norm(b64 - A64 @ np.asarray(x, np.float64))
                / np.linalg.norm(b64))

    Ah = [a.astype(np.float64) for a in A_levels]
    Ph = [p.astype(np.float64) for p in P_levels]
    t0 = time.perf_counter()
    _, host_iters = bench._host_vcycle_pcg(Ah, Ph, b64, rtol=1e-5)
    host_s = time.perf_counter() - t0

    checks = []
    _check(checks, "iters<=host_iters+2", iters, host_iters + 2,
           iters <= host_iters + 2)
    _check(checks, "rel_res", rel, 2e-5, rel <= 2e-5)
    rec = dict(ndofs=int(A_levels[0].shape[0]), levels=len(H.levels),
               formats=[type(lv.A).__name__ for lv in H.levels],
               transfer_formats=[type(lv.P).__name__ for lv in H.levels
                                 if lv.P is not None],
               setup_cold_s=setup_cold, setup_warm_s=setup_warm,
               setup_stages=stages, solve_cold_s=solve_cold,
               solve_warm_s=solve_warm, iters=iters, host_iters=host_iters,
               host_solve_s=host_s, rel_res=rel, checks=checks)
    return rec, (A_levels, H, Hb)


# ------------------------------------------------------------------ #
# kernels: level-0 DIA SpMV and l1-Jacobi sweep
# ------------------------------------------------------------------ #

def phase_kernels(A_scipy, H, n_rhs=N_RHS, reps=20):
    import jax
    import jax.numpy as jnp
    from parelag_tpu.solvers.smoothers import L1JacobiSmoother
    A = H.levels[0].A
    n, nd = A.shape[0], len(A.offs)
    sweep1 = L1JacobiSmoother(H.levels[0].pre.dinv, 1, H.levels[0].pre.omega)
    dinv64 = np.asarray(sweep1.dinv, np.float64) * sweep1.omega
    A64 = A_scipy.astype(np.float64)
    rng = np.random.RandomState(0)
    spmv = jax.jit(lambda M, v: M @ v)
    sweep = jax.jit(lambda S, M, bb, v: S.apply(M, bb, v))

    rec = dict(rows=n, offsets=nd, dtype=str(A.dtype), impls={})
    checks = []
    res = {}
    for s in (1, n_rhs):
        shp = (n,) if s == 1 else (n, s)
        x = rng.rand(*shp).astype(np.float32)
        bb = rng.rand(*shp).astype(np.float32)
        xj, bj = jnp.asarray(x), jnp.asarray(bb)
        y_ref = A64 @ x.astype(np.float64)
        y = np.asarray(spmv(A, xj), np.float64)
        err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        _check(checks, f"xla_spmv_{s}rhs_err", err, 2e-6, err <= 2e-6)
        d = dinv64 if s == 1 else dinv64[:, None]
        xn_ref = x + d * (bb - y_ref)
        xn = np.asarray(sweep(sweep1, A, bj, xj), np.float64)
        err_j = float(np.abs(xn - xn_ref).max() / np.abs(xn_ref).max())
        _check(checks, f"xla_jacobi_{s}rhs_err", err_j, 2e-6,
               err_j <= 2e-6)
        t_spmv = _timed(spmv, A, xj, reps=reps)
        t_jac = _timed(sweep, sweep1, A, bj, xj, reps=reps)
        table = nd * n * 4
        res[f"spmv_{s}rhs"] = dict(
            s=t_spmv, bytes=table + 2 * s * n * 4,
            gbps=(table + 2 * s * n * 4) / t_spmv / 1e9, err=err)
        res[f"jacobi_{s}rhs"] = dict(
            s=t_jac, bytes=table + 3 * s * n * 4 + n * 4,
            gbps=(table + 3 * s * n * 4 + n * 4) / t_jac / 1e9, err=err_j)
    rec["impls"]["xla"] = res

    # yardstick: a large device-to-device stream (read + write) in the
    # same process
    big = jnp.ones(1 << 28, jnp.float32)
    scale = jax.jit(lambda v: v * 2.0)
    t_copy = _timed(scale, big, reps=10)
    rec["copy_bytes"] = 2 * big.size * 4
    rec["copy_gbps"] = 2 * big.size * 4 / t_copy / 1e9
    del big
    rec["checks"] = checks
    return rec, None


# ------------------------------------------------------------------ #
# structured engine checks
# ------------------------------------------------------------------ #

def _rel_fro(A, B):
    D = (A - B).tocsr()
    den = np.sqrt((B.multiply(B)).sum())
    return float(np.sqrt(D.multiply(D).sum()) / max(den, 1e-300))


def _rel_max(A, B):
    """max|A - B| / max|B| for dense arrays or scipy sparse matrices
    (sparse stays sparse)."""
    if hasattr(A, "tocsr"):
        D = (A - B).tocsr()
        B = B.tocsr()
        num = np.abs(D.data).max() if D.nnz else 0.0
        den = np.abs(B.data).max() if B.nnz else 0.0
    else:
        num = np.abs(np.asarray(A) - np.asarray(B)).max()
        den = np.abs(np.asarray(B)).max()
    return float(num / max(den, 1e-300))


def phase_structured(ref_dir, ref_proc, shape, chunk_shape):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from parelag_tpu.amge import structured as st
    from parelag_tpu.amge.spectral import _device_eigh_batch
    from parelag_tpu.ops.batched import _device_solve_refined
    checks = []
    rec = {}

    # precision canary: default f32 matmul vs the engine's context
    rng = np.random.RandomState(0)
    Am = rng.randn(64, 33, 33).astype(np.float32)
    ref = np.einsum("nij,njk->nik", Am.astype(np.float64),
                    Am.astype(np.float64))
    mm = jax.jit(lambda a: a @ a)
    err_def = _rel_max(np.asarray(mm(jnp.asarray(Am)), np.float64), ref)
    with jax.default_matmul_precision("float32"):
        mm32 = jax.jit(lambda a: a @ a)
        err_32 = _rel_max(np.asarray(mm32(jnp.asarray(Am)), np.float64),
                          ref)
    rec["matmul_err_default"] = err_def
    rec["matmul_err_float32"] = err_32
    _check(checks, "matmul_err_float32", err_32, 1e-6, err_32 <= 1e-6)

    # the chain in both solve modes (the mode is not decided here)
    chains = {}
    for mode in ("direct", "ns"):
        t0 = time.perf_counter()
        lvl0 = st.fine_level(shape, dtype=np.float32)
        with st.solve_mode(mode):
            levels, outs = st.coarsen_chain(lvl0, 3, jform_start=0)
        st.force_outputs(*levels, *outs)
        rec[f"{mode}_s"] = time.perf_counter() - t0
        rec[f"{mode}_guards"] = dict(
            bub_sv=max(float(o.bub_sv) for o in outs),
            max_rel_sv=max(float(o.max_rel_sv) for o in outs),
            ns_res=max(float(o.ns_res) for o in outs))
        chains[mode] = (levels, outs)

    levels, outs = chains["direct"]
    t0 = time.perf_counter()
    # invariants on the device chain
    inv = dict(pi_p=0.0, dc_pi_d_p=0.0, commute=0.0, galerkin=0.0)
    for lvl, out, coarse in zip(levels, outs, levels[1:]):
        ncf = st.grid_counts(lvl.shape)[0]
        nff = sum(st.grid_counts(lvl.shape)[1])
        ncc = st.grid_counts(out.cshape)[0]
        nfc = sum(st.grid_counts(out.cshape)[1])
        F3 = sp.coo_matrix(
            (np.asarray(out.f3, np.float64).ravel(),
             (np.repeat(np.arange(ncc), 8), np.asarray(out.cc).ravel())),
            shape=(ncc, ncf)).tocsr()
        F2 = sp.coo_matrix(
            (np.asarray(out.f2, np.float64).ravel(),
             (np.repeat(np.arange(nfc), 4), np.asarray(out.cf).ravel())),
            shape=(nfc, nff)).tocsr()
        P = [st.materialize_P(out, lvl.shape, j).astype(np.float64)
             for j in range(4)]
        inv["pi_p"] = max(inv["pi_p"],
                          _rel_max(F3 @ P[3], sp.identity(ncc)),
                          _rel_max(F2 @ P[2], sp.identity(nfc)))
        D2f = st.global_derivative(lvl, 2).astype(np.float64)
        D2c = st.global_derivative(coarse, 2).astype(np.float64)
        inv["dc_pi_d_p"] = max(inv["dc_pi_d_p"],
                               _rel_max(F3 @ D2f @ P[2], D2c))
        for j in range(3):
            lhs = st.global_derivative(lvl, j).astype(np.float64) @ P[j]
            rhs = P[j + 1] @ st.global_derivative(coarse, j).astype(
                np.float64)
            inv["commute"] = max(inv["commute"], _rel_max(lhs, rhs))
        for j in range(4):
            Mc = (P[j].T @ st.global_mass(lvl, j).astype(np.float64)
                  @ P[j])
            inv["galerkin"] = max(inv["galerkin"], _rel_max(
                Mc, st.global_mass(coarse, j).astype(np.float64)))
    rec["invariants"] = inv
    rec["invariants_s"] = time.perf_counter() - t0
    for k, v in inv.items():
        _check(checks, f"invariant_{k}", v, 1e-5, v <= 1e-5)

    # chunked == whole-level
    lvl0 = st.fine_level(chunk_shape, dtype=np.float32)
    cw, outw = st.coarsen_structured(lvl0, jform_start=0, chunk=0)
    cc, outc = st.coarsen_structured(lvl0, jform_start=0, chunk=100)
    chunk_err = max(
        _rel_max(np.asarray(getattr(outc, f), np.float64),
                 np.asarray(getattr(outw, f), np.float64))
        for f in ("ptr3", "ptr2", "pint2", "d2c", "pf1", "pc1", "d1c",
                  "pe0", "pf0", "pc0", "d0c"))
    rec["chunked_vs_whole"] = chunk_err
    _check(checks, "chunked_vs_whole", chunk_err, 1e-5, chunk_err <= 1e-5)

    # device eigh and batched solve against numpy f64
    Ae = rng.randn(8, 20, 20)
    Ae = (Ae + Ae.transpose(0, 2, 1)) / 2
    w_d, V_d = (np.asarray(v, np.float64) for v in
                _device_eigh_batch(jnp.asarray(Ae, jnp.float32)))
    w_h = np.linalg.eigvalsh(Ae)
    eig_err = float(np.abs(np.sort(w_d, axis=1) - w_h).max()
                    / np.abs(w_h).max())
    eig_res = float(np.abs(np.einsum("nij,njk->nik", Ae, V_d)
                           - w_d[:, None, :] * V_d).max()
                    / np.abs(w_h).max())
    rec["eigh_err"], rec["eigh_res"] = eig_err, eig_res
    _check(checks, "eigh_eigenvalues", eig_err, 1e-5, eig_err <= 1e-5)
    _check(checks, "eigh_residual", eig_res, 1e-4, eig_res <= 1e-4)
    Q, _ = np.linalg.qr(rng.randn(24, 24))
    As = np.stack([(Q * np.logspace(0, -6, 24)) @ Q.T for _ in range(16)])
    Bs = rng.randn(16, 24, 4)
    Xs = _device_solve_refined(As, Bs)
    solve_res = float(np.abs(np.einsum("nij,njk->nik", As, Xs) - Bs).max())
    rec["batched_solve_res"] = solve_res
    _check(checks, "batched_solve_res", solve_res, 1e-8, solve_res <= 1e-8)

    # parity with the host f64 chain (reference child)
    t0 = time.perf_counter()
    wait_reference(ref_proc, ref_dir, "chain.json")
    rec["reference_wait_s"] = time.perf_counter() - t0
    par_P, par_A = 0.0, 0.0
    for l, (lvl, out) in enumerate(zip(levels, outs)):
        for j in range(4):
            Pd = st.materialize_P(out, lvl.shape, j).astype(np.float64)
            Pr = sp.load_npz(os.path.join(ref_dir, f"P{l}_{j}.npz"))
            par_P = max(par_P, _rel_fro(Pd.tocsr(), Pr))
        Ad = st.h1_stiffness(levels[l + 1]).astype(np.float64).tocsr()
        Ar = sp.load_npz(os.path.join(ref_dir, f"A{l + 1}.npz"))
        par_A = max(par_A, _rel_fro(Ad, Ar))
    rec["parity_P_fro"], rec["parity_A_fro"] = par_P, par_A
    _check(checks, "parity_P_fro", par_P, 1e-5, par_P <= 1e-5)
    _check(checks, "parity_A_fro", par_A, 1e-5, par_A <= 1e-5)
    rec["checks"] = checks
    return rec, None


# ------------------------------------------------------------------ #
# spe10: structured spectral setup + hybridized multiplier solve
# ------------------------------------------------------------------ #

def _spe10_setup(cells, dtype):
    import bench
    from parelag_tpu.amge import structured as st
    from parelag_tpu.amge import structured_spectral as sps
    field, coeff = _spe10_problem(cells)
    t0 = time.perf_counter()
    with st.solve_mode("direct"):
        out = sps.spectral_coarsen_darcy(
            tuple(cells), bench._pick_factors(cells), coeff.astype(dtype),
            h=field.sizes, spect_tol=0.002, max_evects=5, dtype=dtype)
    return out, field, coeff, time.perf_counter() - t0


def phase_spe10(ref_dir, ref_proc, full_cells, small_cells):
    import jax
    import bench
    from parelag_tpu.models.spe10 import spe10_darcy
    checks = []
    rec = dict(full_cells=list(full_cells))
    t0 = time.perf_counter()
    out, _, _, cold = _spe10_setup(full_cells, np.float32)
    rec["full_cold_with_field_s"] = time.perf_counter() - t0
    _, _, _, warm = _spe10_setup(full_cells, np.float32)
    rec.update(full_setup_cold_s=cold, full_setup_warm_s=warm,
               ndofs_u=int(out.P2.shape[0]), coarse_u=int(out.P2.shape[1]),
               coarse_p=int(out.P3.shape[1]), ns_res=float(out.ns_res))
    del out

    # hybridized multiplier solve: device PCG vs host CG, same hierarchy
    field, _ = _spe10_problem(small_cells)
    t0 = time.perf_counter()
    hy = spe10_darcy(field=field, cells=tuple(small_cells), n_levels=2,
                     coarsening_factor=64, spectral=True,
                     mult_solver=("device", "cg"))
    rec.update(
        hyb_total_s=time.perf_counter() - t0,
        hyb_ndofs=hy["ndofs"],
        hyb_device_iters=hy["mult_iters_by"]["device"],
        hyb_host_iters=hy["mult_iters_by"]["cg"],
        hyb_device_solve_s=hy["solve_s_by"]["device"],
        hyb_host_solve_s=hy["solve_s_by"]["cg"],
        hyb_u_l2_rel_device=hy["u_l2_rel_by"]["device"],
        hyb_u_l2_rel_host=hy["u_l2_rel_by"]["cg"])
    d_hyb = (abs(hy["u_l2_rel_by"]["device"] - hy["u_l2_rel_by"]["cg"])
             / hy["u_l2_rel_by"]["cg"])
    _check(checks, "hyb_u_l2_rel_device_vs_host", d_hyb, 0.01,
           d_hyb <= 0.01)

    # the same engine in f64 on the device against the host f64 child,
    # sharing the child's fine velocity
    with jax.enable_x64(True):
        out, field, coeff, dev_s = _spe10_setup(small_cells, np.float64)
    t0 = time.perf_counter()
    ref = wait_reference(ref_proc, ref_dir)
    rec["reference_wait_s"] = time.perf_counter() - t0
    uf = np.load(os.path.join(ref_dir, "spe10_uf.npy"))
    u_rel = bench.spe10_upscaling_error(
        tuple(small_cells), coeff, field.sizes, out.P2, out.P3, uf=uf)
    href = ref["spe10"]
    dims = (int(out.P2.shape[1]), int(out.P3.shape[1]))
    rec.update(small_cells=list(small_cells), small_setup_s=dev_s,
               small_coarse_u=dims[0], small_coarse_p=dims[1],
               small_u_l2_rel=u_rel, host_coarse_u=href["coarse_u"],
               host_coarse_p=href["coarse_p"],
               host_u_l2_rel=href["u_l2_rel"])
    same = dims == (href["coarse_u"], href["coarse_p"])
    if not same:
        rec["mode_flips"] = {
            k: int(np.sum(v != np.asarray(href["modes"][k])))
            for k, v in _spe10_mode_counts(out).items()}
    _check(checks, "coarse_dims", list(dims),
           [href["coarse_u"], href["coarse_p"]], same)
    drel = abs(u_rel - href["u_l2_rel"]) / href["u_l2_rel"]
    _check(checks, "u_l2_rel_vs_host", drel, 0.01, drel <= 0.01)
    rec["checks"] = checks
    return rec, None


# ------------------------------------------------------------------ #
# --multi: distributed solve on four cards
# ------------------------------------------------------------------ #

def phase_multi(grid, n_dev):
    import jax
    from parelag_tpu.parallel.dist_bench import (
        distributed_setup, compare_solves)
    devs = jax.devices()[:n_dev]
    setup, b, setup_s = distributed_setup(grid, n_dev)
    rec = dict(grid=list(grid), setup_s=setup_s,
               ndofs=[int(v) for v in setup.ndofs])
    checks = []
    with jax.enable_x64(True):
        r64 = compare_solves(devs, setup, b, dtype=np.float64)
    r32 = compare_solves(devs, setup, b, dtype=np.float32)
    x64, x32 = r64.pop("x"), r32.pop("x")
    d32 = float(np.linalg.norm(x32 - x64) / np.linalg.norm(x64))
    rec["f32_vs_f64_x_rel_diff"] = d32
    for tag, r in (("f64", r64), ("f32", r32)):
        rec[tag] = r
        _check(checks, f"{tag}_iters", [r["dist_iters"], r["serial_iters"]],
               "equal +-1", abs(r["dist_iters"] - r["serial_iters"]) <= 1)
        _check(checks, f"{tag}_setup_solve_err", r["setup_solve_err"],
               1e-4, r["setup_solve_err"] <= 1e-4)
        ranks = r["placement"]["values_l0"]["devices"]
        _check(checks, f"{tag}_blocks_on_distinct_cards", ranks, n_dev,
               len(set(ranks)) == n_dev)
    # f64 pins the algorithm (distributed == serial); the f32 run against
    # the f64 one pins the precision of the contractions (TF32 would
    # leave an error far above 3e-4)
    _check(checks, "f64_x_rel_diff", r64["x_rel_diff"], 1e-5,
           r64["x_rel_diff"] <= 1e-5)
    _check(checks, "f32_vs_f64_x_rel_diff", d32, 3e-4, d32 <= 3e-4)
    rec["checks"] = checks
    return rec, None


# ------------------------------------------------------------------ #

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the distributed solve on four GPUs")
    ap.add_argument("--reference", nargs=2, metavar=("DIR", "CFG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference:
        reference_main(args.reference[0], json.loads(args.reference[1]))
        return 0

    import jax
    n_dev = 4 if args.multi else 1
    run_phase("device", phase_device, n_dev)
    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if args.multi:
        run_phase("multi", phase_multi, MULTI_GRID, n_dev)
    else:
        with tempfile.TemporaryDirectory() as ref_dir:
            proc = start_reference(ref_dir, STRUCT_SHAPE, SPE10_SMALL)
            try:
                A_levels, H, _ = run_phase("h1", phase_h1, H1_NX)
                run_phase("kernels", phase_kernels, A_levels[0], H)
                del A_levels, H
                run_phase("structured", phase_structured, ref_dir, proc,
                          STRUCT_SHAPE, CHUNK_SHAPE)
                run_phase("spe10", phase_spe10, ref_dir, proc, SPE10_FULL,
                          SPE10_SMALL)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
