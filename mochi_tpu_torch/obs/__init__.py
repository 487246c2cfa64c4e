"""End-to-end causal observability (round 15).

``mochi_tpu_torch.obs.trace`` is the per-process tracer behind the per-transaction
cost accounting (verifies, wire bytes, fsyncs, RTTs) and the conviction
flight recorder.  See docs/OPERATIONS.md §4j.
"""

from .trace import (  # noqa: F401
    DEFAULT_SAMPLE_RATE,
    CURRENT,
    TraceContext,
    Tracer,
    cost_cards,
    current_ctx,
    global_summary,
    merge_events,
    span_tree_connected,
)
