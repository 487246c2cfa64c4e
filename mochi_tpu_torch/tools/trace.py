"""Merge multi-process trace dumps into one Chrome trace / cost-card view.

Each process exports its own bounded span ring — the ``/trace`` admin
endpoint on replicas and clients, and the flight-recorder files convictions
and SIGTERM drains write under ``MOCHI_TRACE_DIR`` — so a transaction's
causal record is scattered across files.  This CLI joins them by trace_id:

    # one merged Chrome trace (load in chrome://tracing / Perfetto)
    python -m mochi_tpu_torch.tools.trace dumps/*.json -o merged.json

    # only one transaction's tree
    python -m mochi_tpu_torch.tools.trace dumps/*.json --trace-id 3ca2704a...

    # per-transaction cost cards (verifies unique/memoized, wire bytes,
    # fsyncs, RTTs, queue wait, stage durations)
    python -m mochi_tpu_torch.tools.trace dumps/*.json --cards

Accepted inputs: any JSON document with a ``traceEvents`` list — a /trace
response, a flight-recorder dump, or a previous merge.  Exit code 0 on
success, 2 on unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from ..obs.trace import cost_cards, merge_events, span_tree_connected


def load_dumps(paths: List[str]) -> List[dict]:
    docs = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc.get("traceEvents"), list):
            raise ValueError(f"{path}: no traceEvents list (not a trace dump)")
        docs.append(doc)
    return docs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mochi_tpu_torch.tools.trace",
        description="merge per-process trace dumps by trace_id",
    )
    parser.add_argument("dumps", nargs="+", help="trace/flight JSON files")
    parser.add_argument("--trace-id", default=None, help="keep one trace only")
    parser.add_argument(
        "--cards", action="store_true",
        help="emit per-transaction cost cards instead of a merged trace",
    )
    parser.add_argument("-o", "--out", default=None, help="output path (default stdout)")
    args = parser.parse_args(argv)

    try:
        docs = load_dumps(args.dumps)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    events = merge_events(docs)
    if args.trace_id:
        events = [
            ev for ev in events
            if ev.get("args", {}).get("trace_id") == args.trace_id
        ]

    if args.cards:
        cards = cost_cards(events)
        for tid, card in cards.items():
            card["connected"] = span_tree_connected(events, tid)
        body = json.dumps(cards, indent=2, sort_keys=True)
    else:
        body = json.dumps(
            {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "merged_from": len(docs),
                    "traces": len(
                        {
                            ev.get("args", {}).get("trace_id")
                            for ev in events
                        }
                        - {None}
                    ),
                },
            }
        )
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(body + "\n")
    else:
        print(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
