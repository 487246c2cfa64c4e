"""Native (C) host components, built at first use with the system compiler.

* ``_mcode`` — the canonical wire/signing codec (``mcode.c``), bound in
  :mod:`mochi_tpu_torch.protocol.codec`.
* ``_hbatch`` — batched SHA-512(R||A||M) mod L for the device verifier's
  host prepare (:func:`mochi_tpu_torch.crypto.batch_verify.prepare_packed`),
  and the host Ed25519 engine (verify, sign) and X25519 that
  :mod:`mochi_tpu_torch.crypto.hostfallback` routes to on hosts without the
  ``cryptography`` wheel (``hbatch.c``).

Build model: ``<name>.c`` is compiled with ``$CC`` (default ``cc``) against
this interpreter's ``Python.h`` into ``build/native/_<name>-<hash>.so`` at
the root of the checkout; the hash covers the source, the flags and the
interpreter's extension suffix, so an edited source or another Python never
loads a stale build.  The build writes a temporary file and renames it into
place, so processes that build at once race benignly.  Nothing is built
when this module is imported.

The native modules are optional, as in the reference package: without a
compiler or ``Python.h`` (or with ``MOCHI_NO_NATIVE`` set) the callers use
their pure-Python paths, which give the same bytes and verdicts.
:func:`native_status` says, for each module, whether it was built and why
not.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

LOG = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_cached: Dict[str, Optional[ModuleType]] = {}
# name -> the compiler's error (or why no build was tried) for a module
# that is not available
_errors: Dict[str, str] = {}


def _include_dir() -> str:
    return sysconfig.get_paths()["include"]


def so_path(name: str) -> Path:
    """Where ``_<name>``'s extension is, or will be, built."""
    src = SRC_DIR / f"{name[1:]}.c"
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update((sysconfig.get_config_var("EXT_SUFFIX") or ".so").encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(src: Path, out: Path) -> Optional[str]:
    """Compile ``src`` into ``out``; returns None, or why it failed."""
    include = _include_dir()
    if not os.path.exists(os.path.join(include, "Python.h")):
        return f"no Python.h under {include}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, f"-I{include}", str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        tmp.unlink(missing_ok=True)
        return f"{cmd[0]} unavailable: {exc}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{cmd[0]} exit {proc.returncode}: {proc.stderr.strip()}"
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return None


def _get_native(name: str) -> Optional[ModuleType]:
    """The compiled ``_<name>`` module, building ``<name>.c`` if needed;
    None when it cannot be built or loaded (the callers then take their
    pure-Python paths)."""
    if os.environ.get("MOCHI_NO_NATIVE"):
        return None
    with _lock:
        if name in _cached:
            return _cached[name]
        mod = None
        out = so_path(name)
        err = None if out.exists() else _build(SRC_DIR / f"{name[1:]}.c", out)
        if err is None:
            qual = f"{__name__}.{name}"
            try:
                spec = importlib.util.spec_from_file_location(qual, out)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                sys.modules[qual] = mod
            except ImportError as exc:
                err, mod = f"load failed: {exc}", None
        if err is not None:
            LOG.warning("native %s unavailable, using the pure-Python path: %s", name, err)
            _errors[name] = err
        _cached[name] = mod
        return mod


def get_mcode() -> Optional[ModuleType]:
    return _get_native("_mcode")


def get_hbatch() -> Optional[ModuleType]:
    return _get_native("_hbatch")


def native_status() -> Dict[str, Dict[str, object]]:
    """For each native module: whether it is built and loaded, where, and
    the compiler's error (or ``MOCHI_NO_NATIVE``) when it is not.  Builds
    what is missing."""
    out = {}
    for name in ("_mcode", "_hbatch"):
        if os.environ.get("MOCHI_NO_NATIVE"):
            out[name] = {"built": False, "error": "MOCHI_NO_NATIVE is set"}
            continue
        mod = _get_native(name)
        out[name] = {"built": mod is not None, "path": str(so_path(name)) if mod is not None else None,
                     "error": _errors.get(name)}
    return out
