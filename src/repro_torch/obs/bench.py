"""Normalized BENCH_*.json schema + machine diffing (bench.v1).

Every ``benchmarks/run.py --json`` section writes through
``bench_record``, so all artifacts share one top-level shape:

    {"schema": "bench.v1", "section": str, "generated_at": float,
     "smoke": bool, "wall_s": float, "rows": [[str, ...], ...]}

Rows keep the historical 4-column layout ``[section_tag, metric,
value, note]`` (everything stringified) — existing row consumers keep
working.  ``load_bench`` upgrades legacy files (no schema key) in
memory so ``diff`` works across the boundary.

Diff semantics: rows are keyed by ``(row[0], row[1])``; only the value
column is compared.  ``wall_s``/``generated_at``/notes are run-local
and never make two benches "different" — that's the property that
makes BENCH files machine-diffable across machines and dates.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

BENCH_SCHEMA = "bench.v1"
_VOLATILE = ("wall_s", "generated_at", "smoke")


def bench_record(section: str, rows, wall_s: float, *, smoke: bool = False,
                 generated_at: Optional[float] = None) -> dict:
    """Build the canonical artifact dict for one benchmark section."""
    return {
        "schema": BENCH_SCHEMA,
        "section": str(section),
        "generated_at": float(time.time() if generated_at is None
                              else generated_at),
        "smoke": bool(smoke),
        "wall_s": float(wall_s),
        "rows": [[str(c) for c in row] for row in rows],
    }


def write_bench(path: str, record: dict) -> None:
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)


def load_bench(path: str) -> dict:
    """Load a BENCH json, upgrading legacy (schema-less) files."""
    with open(path) as fh:
        data = json.load(fh)
    if "schema" not in data:
        data = {
            "schema": "legacy",
            "section": data.get("section", "?"),
            "generated_at": 0.0,
            "smoke": False,
            "wall_s": float(data.get("wall_s", 0.0)),
            "rows": [[str(c) for c in row] for row in data.get("rows", [])],
        }
    return data


def _row_map(record: dict) -> Dict[Tuple[str, str], List[str]]:
    out = {}
    for row in record.get("rows", []):
        key = (row[0] if len(row) > 0 else "?",
               row[1] if len(row) > 1 else "?")
        out[key] = row
    return out


def diff_bench(a: dict, b: dict) -> dict:
    """Structured diff of two bench records (volatile keys ignored)."""
    ra, rb = _row_map(a), _row_map(b)
    added = sorted(k for k in rb if k not in ra)
    removed = sorted(k for k in ra if k not in rb)
    changed = []
    for k in sorted(set(ra) & set(rb)):
        va = ra[k][2] if len(ra[k]) > 2 else ""
        vb = rb[k][2] if len(rb[k]) > 2 else ""
        if va != vb:
            changed.append({"key": list(k), "a": va, "b": vb})
    return {
        "section_a": a.get("section"), "section_b": b.get("section"),
        "added": [list(k) for k in added],
        "removed": [list(k) for k in removed],
        "changed": changed,
        "identical": not (added or removed or changed),
    }


def format_diff(d: dict) -> str:
    lines = [f"bench-diff: {d['section_a']} vs {d['section_b']}"]
    if d["identical"]:
        lines.append("  identical (all row values match)")
        return "\n".join(lines)
    for k in d["removed"]:
        lines.append(f"  - {k[0]}/{k[1]}")
    for k in d["added"]:
        lines.append(f"  + {k[0]}/{k[1]}")
    for c in d["changed"]:
        lines.append(f"  ~ {c['key'][0]}/{c['key'][1]}: "
                     f"{c['a']} -> {c['b']}")
    return "\n".join(lines)


def summarize_bench(record: dict) -> str:
    rows = record.get("rows", [])
    lines = [f"BENCH {record.get('section')} · schema={record.get('schema')}"
             f" · smoke={record.get('smoke')} · {len(rows)} rows"
             f" · wall={record.get('wall_s', 0.0):.3g}s"]
    for row in rows:
        metric = row[1] if len(row) > 1 else "?"
        value = row[2] if len(row) > 2 else ""
        note = row[3] if len(row) > 3 else ""
        lines.append(f"  {metric:<32} {value:<16} {note}")
    return "\n".join(lines)
