"""Build-at-first-use loader for the hand-written CUDA kernels in ``csrc/``.

``load(name)`` returns ``csrc/<name>.cu`` compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, ``build/kernels/<name>-<hash>.so`` at the root of the
checkout, and loads it with ``ctypes``.  The hash covers every source in
``csrc/`` and the flags, so an edit rebuilds and an unchanged tree reuses
the library.  A failed build raises with nvcc's stderr; nothing falls back.
A missing library is built together with every other missing one: one nvcc
per source, all started at once, so the kernels build in parallel
(``build_all()`` does just that).  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas resource usage) for a build this process made
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def _start(name: str, out: Path):
    """Start one nvcc for ``csrc/<name>.cu``; returns (process, temp path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, out: Path, proc, tmp: Path) -> None:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{stderr}{stdout}")
    os.replace(tmp, out)
    build_logs[name] = stderr + stdout


def _build_missing() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` not built yet, one nvcc per source, all
    started together (the caller holds ``_lock``); returns the seconds until
    each build was done (0 for one already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    started = {}
    errors = []
    try:
        for name in names:
            out = _path(name)
            if not out.exists():
                started[name] = (out, *_start(name, out))
    finally:
        took = {name: 0.0 for name in names}
        for name, (out, proc, tmp) in started.items():
            try:
                _finish(name, out, proc, tmp)
            except RuntimeError as exc:
                errors.append(str(exc))
            took[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_all() -> Dict[str, float]:
    """Build every kernel that is not built yet, in parallel."""
    with _lock:
        return _build_missing()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _path(name)
            if not path.exists():
                _build_missing()
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
