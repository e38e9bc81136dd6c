"""chip_smoke.py on the CPU: it must refuse to run (no CPU fallback), and
its phases, driven at tiny sizes with the CPU-pinned f64 reference child,
must pass their own checks (the rehearsal of the GPU run)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <repo>/.jax_cache with no per-backend subdirectory."""
    from parelag_tpu.utils.compile_cache import default_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert default_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
        assert default_cache_dir() == str(tmp_path / env_dir)


def test_phases_rehearse_on_cpu(tmp_path, capsys):
    proc = cs.start_reference(str(tmp_path), (8, 8, 8), (6, 10, 6))
    try:
        A_levels, H, _ = cs.run_phase("h1", cs.phase_h1, 16)
        cs.run_phase("kernels", cs.phase_kernels, A_levels[0], H,
                     n_rhs=4, reps=1)
        cs.run_phase("structured", cs.phase_structured, str(tmp_path),
                     proc, (8, 8, 8), (4, 4, 4))
        cs.run_phase("spe10", cs.phase_spe10, str(tmp_path), proc,
                     (6, 10, 6), (6, 10, 6))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [ln["phase"] for ln in lines] == [
        "h1", "kernels", "structured", "spe10"]
    assert all(ln["ok"] for ln in lines)
    assert np.isfinite(lines[0]["rel_res"])
