"""Project-native static analysis for mochi-tpu.

``python -m mochi_tpu_torch.analysis [paths...]`` runs AST checkers tuned to
this codebase's failure modes (see docs/ANALYSIS.md):

* ``async-blocking``       — blocking calls inside coroutine bodies
* ``cancellation-hygiene`` — handlers that swallow asyncio cancellation
* ``jax-trace-safety``     — host sync / Python branching in traced code
* ``constant-time``        — timing-oracle comparisons on authenticators
* ``protocol-invariants``  — payload registration + quorum-math locality

Programmatic entry point: :func:`mochi_tpu_torch.analysis.core.run`.  The
pass is wired into tier-1 (``tests/test_torch_static_analysis.py`` scans
``mochi_tpu_torch/`` and ``chip_smoke.py``), so a finding fails CI, not code
review.  The analysis is pure ``ast``/regex work: it imports no torch.
"""

from .core import Finding, RunResult, all_rules, run

__all__ = ["Finding", "RunResult", "all_rules", "run"]
