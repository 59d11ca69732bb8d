"""Ladder-rung keys of the per-stream SLO ledger (the JAX package's
``obs/ledger.py``); the ledger itself comes with the serving slice."""

from __future__ import annotations


def rung_key(rung) -> str:
    """Canonical string for a ladder rung: ``(cut, bits)`` tuples become
    ``"nn@16"`` / ``"vj@raw"``; the on-node fallback is ``"on_node"``;
    strings pass through."""
    if rung is None:
        return "none"
    if isinstance(rung, str):
        return rung
    cut, bits = rung
    if cut is None:
        return "local"
    if cut == "on_node":
        return "on_node"
    return f"{cut}@{'raw' if bits is None else bits}"
