"""Loader for the caching numpy data allocator (native/parelag_npalloc.c).

Built on demand with gcc/g++ like ops/native.py; everything degrades to a
no-op when the toolchain is missing. Installed at parelag_tpu import
(see __init__._install_np_allocator); disable with PARELAG_NPALLOC=0.

Why it exists: first population of fresh heap pages is slow on some
virtualized hosts, and the setup engine's GB-scale numpy temporaries can
make ALLOCATION (not compute) the dominant coarsening cost; its effect on
the GPU machine's host is not measured. The C
handler keeps freed >=1 MB blocks in size-class free lists so their
already-populated pages are reused (allocator analog of the reference's
MemoryUtils, src/utilities/MemoryUtils.hpp).
"""

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig

_MOD = None
_TRIED = False

_ROOT = os.environ.get(
    "PARELAG_NATIVE_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def _load():
    global _MOD, _TRIED
    if _TRIED:
        return _MOD
    _TRIED = True
    src = os.path.abspath(os.path.join(_ROOT, "parelag_npalloc.c"))
    so = os.path.abspath(os.path.join(_ROOT, "parelag_npalloc.so"))
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        srchash = hashlib.sha256(f.read()).hexdigest()
    sidecar = so + ".srchash"
    stale = True
    if os.path.exists(so) and os.path.exists(sidecar):
        with open(sidecar) as f:
            stale = f.read().strip() != srchash
    if stale:
        try:
            import numpy as np
            cmd = ["gcc", "-O2", "-shared", "-fPIC",
                   "-I" + sysconfig.get_paths()["include"],
                   "-I" + np.get_include(), "-o", so, src]
            subprocess.run(cmd, check=True, capture_output=True)
            with open(sidecar, "w") as f:
                f.write(srchash)
        except Exception:
            if not os.path.exists(so):
                return None
    try:
        loader = importlib.machinery.ExtensionFileLoader(
            "parelag_npalloc", so)
        spec = importlib.util.spec_from_loader("parelag_npalloc", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except Exception:
        return None
    _MOD = mod
    return _MOD


def install(cap_bytes=0):
    """Install the caching allocator; returns True on success."""
    mod = _load()
    if mod is None:
        return False
    mod.install(cap_bytes)
    return True


def stats():
    mod = _load()
    return mod.stats() if mod is not None else None


def trim():
    mod = _load()
    if mod is not None:
        mod.trim()
