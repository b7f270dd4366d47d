"""Validate a JSONL serve-loop trace against the event schema.

Usage::

    python -m repro_torch.obs.validate trace.jsonl
    python -m repro_torch.obs.validate trace.jsonl --expect-snapshots 3 \\
        --expect-report

Checks every line parses as JSON, every event validates against
:mod:`repro_torch.obs.schema`, the first event is the ``meta`` header, the
owner-row shapes match the header's shard count, and (optionally) that
the trace contains at least N snapshots and a final report. Exit 0 on a
valid trace, 1 with the offending line number otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.schema import validate_event


def validate_file(path: str, *, expect_snapshots: int = 0,
                  expect_report: bool = False) -> dict:
    """Validate; returns per-type event counts. Raises ValueError."""
    counts = {"meta": 0, "span": 0, "snapshot": 0, "report": 0}
    shards = None
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {e}")
            try:
                t = validate_event(ev, shards=shards)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}")
            if counts["meta"] == 0 and t != "meta":
                raise ValueError(
                    f"{path}:{lineno}: first event must be 'meta', got {t!r}")
            if t == "meta":
                if counts["meta"]:
                    raise ValueError(
                        f"{path}:{lineno}: duplicate 'meta' header")
                shards = ev["shards"]
            counts[t] += 1
    if counts["meta"] == 0:
        raise ValueError(f"{path}: empty trace (no 'meta' header)")
    if counts["snapshot"] < expect_snapshots:
        raise ValueError(
            f"{path}: expected >= {expect_snapshots} snapshots, got "
            f"{counts['snapshot']}")
    if expect_report and counts["report"] == 0:
        raise ValueError(f"{path}: no end-of-run report event")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a serve-loop JSONL trace")
    ap.add_argument("trace", help="path to the .jsonl trace file")
    ap.add_argument("--expect-snapshots", type=int, default=0,
                    help="fail unless the trace has at least N snapshots")
    ap.add_argument("--expect-report", action="store_true",
                    help="fail unless the trace ends with a report event")
    args = ap.parse_args(argv)
    try:
        counts = validate_file(args.trace,
                               expect_snapshots=args.expect_snapshots,
                               expect_report=args.expect_report)
    except (ValueError, OSError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    total = sum(counts.values())
    print(f"ok  {args.trace}: {total} events "
          f"({counts['span']} spans, {counts['snapshot']} snapshots, "
          f"{counts['report']} report)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
