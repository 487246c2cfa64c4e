"""The control of the comparison that decides ``correct``, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--device cuda:0]

The control is the reference put in the program's place with one guarantee
of the configuration broken: the S < L rule of RFC 8032, so a malleated
signature (S + L) verifies.  For each seed it makes the cell's pool, works
out the reference's outputs and the control's, judges the control's with
the run's own judge, one step a batch, and prints one JSON line: the
numbers compared and the seconds the reference took.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seed: int, device: str) -> dict:
    from .generate import make_pool
    from .run import expected_outputs, judge

    pool = make_pool(cell.config, cell.traffic, seed)
    threshold = int(cell.config["quorum"])
    t = time.perf_counter()
    want = expected_outputs(pool, threshold, device)
    ref_s = time.perf_counter() - t
    control = expected_outputs(pool, threshold, device, check_s=False)
    checks, failed = judge([(k, 0.0, 0.0, out) for k, out in enumerate(control)], want, pool)
    return {"workload": cell.name, "seed": seed, "lanes": sum(b.lanes for b in pool),
            "reference_s": ref_s, "failed": failed,
            "checks": {k: v["value"] for k, v in checks.items()},
            "correct": all(v["value"] <= v["limit"] for v in checks.values())}


def main(argv=None) -> int:
    from .run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
