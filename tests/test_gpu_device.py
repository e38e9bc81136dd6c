"""GPU acceptance lane: the f32 solve phase ON THE CARD — hierarchy
V-cycle PCG, device SpMV, and coarsening invariants via device matvecs —
with tolerances relaxed to f32.  Catches device-only regressions (dtype
truncation, layout, compile failures) that the CPU-x64 suite cannot see.

The suite's conftest pins the CPU platform in-process, so the check runs
JAX in a child process with a clean environment.  Whether a GPU exists is
decided in the `gpu` fixture, never at import; without one the test
skips.  On a machine with a card: `python -m pytest tests -m gpu`.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.gpu


def _clean_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _run(script, timeout=1200):
    return subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True,
                          env=_clean_env(), timeout=timeout)


@pytest.fixture(scope="session")
def gpu():
    """Skip unless a child JAX process finds a GPU."""
    r = _run("import jax; print(jax.devices()[0].platform)", timeout=300)
    platform = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or platform != "gpu":
        pytest.skip(f"no GPU (JAX platform {platform or 'unavailable'!r})")


_DEVICE_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
assert jax.devices()[0].platform == "gpu", jax.devices()

from parelag_tpu.mesh.mesh import hex_grid_mesh
from parelag_tpu.topology.topology import AgglomeratedTopology
from parelag_tpu.amge.fespace import DeRhamSequenceFE
from parelag_tpu.partitioning.partitioners import refined_mesh_partition
from parelag_tpu.models.upscaling import (
    mark_dofs_on_bndr, boundary_rhs, eliminate_rowcols)
from parelag_tpu.solvers.amge_solver import build_amge_hierarchy
from parelag_tpu.solvers.cg import pcg
from parelag_tpu.ops.device_sparse import from_scipy

mesh = hex_grid_mesh(4, 4, 4).uniform_refinement()      # 512 elements
topo = AgglomeratedTopology.from_mesh(mesh)
topo.coarsen_local_partitioning(refined_mesh_partition(512, 64))
seq = DeRhamSequenceFE(topo, mesh)
seq.set_upscaling_targets(0)
seqs = [seq, seq.coarsen()]

M = seq.compute_mass_operator(0)
W = seq.compute_mass_operator(1)
D = seq.D[0]
A = (M + D.T @ W @ D).tocsr()
b = boundary_rhs(seq, 0, {1: -1.0})
marker = mark_dofs_on_bndr(seq, 0, {2, 3, 4, 5})
A, b = eliminate_rowcols(A, b, marker, np.zeros(A.shape[0]))
A32 = A.astype(np.float32)

# 1. f32 device SpMV matches scipy within f32 tolerance
Ad = from_scipy(A32, dtype=np.float32)
x = np.random.RandomState(0).randn(A.shape[0]).astype(np.float32)
y_dev = np.asarray(Ad @ jnp.asarray(x))
y_ref = A32 @ x
scale = np.abs(y_ref).max()
assert np.abs(y_dev - y_ref).max() < 5e-5 * scale, "device SpMV mismatch"
print("spmv ok")

# 2. f32 coarsening invariants via device matvecs: Pi P v = v and the
# commuting property D P v = P_c D_c v on random vectors
P = seqs[0].P[0].astype(np.float32)
Pi = seqs[0].Pi[0].matrix.astype(np.float32)
Pd = from_scipy(P, dtype=np.float32)
Pid = from_scipy(Pi, dtype=np.float32)
v = np.random.RandomState(1).randn(P.shape[1]).astype(np.float32)
w = np.asarray(Pid @ (Pd @ jnp.asarray(v)))
assert np.abs(w - v).max() < 1e-4 * max(np.abs(v).max(), 1), "Pi P != I"
Df = from_scipy(seqs[0].D[0].astype(np.float32), dtype=np.float32)
P1 = from_scipy(seqs[0].P[1].astype(np.float32), dtype=np.float32)
Dc = from_scipy(seqs[1].D[0].astype(np.float32), dtype=np.float32)
lhs = np.asarray(Df @ (Pd @ jnp.asarray(v)))
rhs = np.asarray(P1 @ (Dc @ jnp.asarray(v)))
assert np.abs(lhs - rhs).max() < 1e-4 * max(np.abs(lhs).max(), 1), \
    "commuting property violated on device"
print("invariants ok")

# 3. V-cycle-PCG solve on the chip (hierarchy passed as jit ARGUMENT)
H, _, _ = build_amge_hierarchy(seqs, 0, A32, smoother="l1jacobi",
                               sweeps=2, dtype=np.float32)
bj = jnp.asarray(b.astype(np.float32))

@jax.jit
def solve(Harg, bb):
    return pcg(lambda u: Harg.levels[0].A @ u, bb, precond=Harg.apply,
               rtol=1e-5, atol=0.0, maxiter=100)

x, (it, nom) = solve(H, bj)
res = float(np.linalg.norm(b - A @ np.asarray(x, dtype=np.float64)))
rel = res / float(np.linalg.norm(b))
assert np.isfinite(rel) and rel < 1e-3, f"device PCG rel_res={rel}"
print(f"pcg ok iters={int(it)} rel={rel:.2e}")
"""


def test_f32_solve_phase_on_device(gpu):
    r = _run(_DEVICE_SCRIPT, timeout=1200)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for tag in ("spmv ok", "invariants ok", "pcg ok"):
        assert tag in r.stdout, r.stdout
