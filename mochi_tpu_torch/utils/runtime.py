"""Process-level runtime tuning for mochi server/verifier processes.

The asyncio request path allocates heavily (envelopes, futures, frames);
CPython's default generational GC thresholds (700, 10, 10) make gen-0/1
collections fire every few requests, and the collector walks the whole
young set each time.  Relaxing the thresholds and freezing the post-boot
heap into the permanent generation was measured at +15-20% cluster
throughput on the config-1 bench (5 replicas, 40 clients, single core);
20k/50k/200k gen-0 thresholds all measured within noise of each other,
so the value below is not delicate.

This is deliberately a *server-process* knob, called from process entry
points (``server/__main__.py``, ``verifier.service:main``, the benchmark
harnesses) — never on library import, which would impose our GC policy on
embedding applications.
"""

from __future__ import annotations

import gc
import hashlib
import os
import platform


def host_cache_dir(base: str) -> str:
    """CPU-backend XLA cache subdirectory keyed by this host's CPU features.

    XLA:CPU's persistent cache key does NOT include the CPU feature set its
    AOT code was specialized for; a cache directory populated on a machine
    with (say) AVX-512 feeds SIGILL-prone code to a host without it —
    a multi-chip run's log was full of exactly this machine-feature-
    mismatch warning.  Every CPU-backend cache site (dry runs, bench.py's
    forced-CPU fallback, vpu_peak --allow-cpu) must use this instead of
    the shared TPU cache dir.
    """
    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    feat += " " + " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    tag = hashlib.sha256(feat.encode()).hexdigest()[:12]
    return os.path.join(base, f"cpu-{tag}")


def tune_gc_for_server() -> None:
    """Relax GC for allocation-heavy serving; freeze the boot-time heap.

    Reference-cycle garbage still gets collected — only less often, with
    the (acyclic) steady-state request garbage reclaimed by refcounting as
    usual.  Call after imports/boot so ``gc.freeze`` captures module state.
    """
    gc.collect()
    gc.freeze()
    gc.set_threshold(50000, 50, 50)


def reset_gc_debt() -> None:
    """Collect torn-down cyclic graphs NOW and refreeze the survivors.

    Under the relaxed server thresholds a just-closed in-process cluster's
    object graph (replicas↔stores↔grant books, task callbacks — all
    cyclic) lingers uncollected; a workload that follows in the same
    process then pays repeated young-gen collections that trace the dead
    giant graph — the config-6 "GC debt" artifact that depressed an
    n16-after-n64 run ~45% (BASELINE.md).  Call between workloads that
    must not observe each other's teardown; a full collect + refreeze
    moves whatever legitimately survives out of the traced set entirely.
    """
    gc.collect()
    gc.freeze()
