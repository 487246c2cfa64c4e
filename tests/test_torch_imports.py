"""The port stands alone: ``mochi_tpu_torch`` imports neither JAX nor any
module of the JAX package, and neither does ``chip_smoke.py``."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import mochi_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "mochi_tpu_torch")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="mochi_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = ["mochi_tpu_torch"] + _port_modules()
    assert "mochi_tpu_torch.crypto.cuda_verify" in mods
    assert "mochi_tpu_torch.verifier.service" in mods
    for m in ("crypto.comb", "crypto.cuda_comb", "server.replica", "server.__main__", "client.client",
              "testing.virtual_cluster", "storage.spi", "tools.gen_cluster", "testing.byzantine",
              "testing.byzantine_client", "testing.schedule", "testing.scenario",
              "analysis.core", "analysis.wire_taint", "analysis.__main__"):
        assert f"mochi_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k, v in sys.modules.items() if v is not None)))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    leaked = [m for m in loaded if m == "mochi_tpu" or m.startswith("mochi_tpu.")]
    assert not leaked, leaked
    assert not [m for m in loaded if m.startswith("jax")]


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_nothing_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            if top in ("mochi_tpu", "jax", "jaxlib"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad
    assert mochi_tpu_torch.__version__
