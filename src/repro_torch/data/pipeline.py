"""Deterministic, host-sharded synthetic token batches (the JAX package's
``data/pipeline.py``, numpy only, the port's own copy).

Token streams come from a seeded per-position hash (counter-based, so the
batch of any step is random access: a restarted job replays the same data
with no iterator state beyond the step number).  The batches equal the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0


def _philox_like(x: np.ndarray, seed: int) -> np.ndarray:
    """Cheap counter-based hash -> uint32 (deterministic random access)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64)
        x = x + np.uint64((seed * 0x9E3779B97F4A7C15) % 2**64)
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x = x * np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def batch_for_step(cfg: DataConfig, step: int, host_index: int = 0,
                   host_count: int = 1) -> dict:
    """The host-sharded batch of a global step: {"tokens": (rows, seq)
    int32}.  With probability ~3/4 a token is a fixed function of the one
    before it, so a model has structure to learn."""
    assert cfg.global_batch % host_count == 0
    rows_per_host = cfg.global_batch // host_count
    row0 = host_index * rows_per_host
    rows = np.arange(row0, row0 + rows_per_host, dtype=np.uint64)
    t = np.arange(cfg.seq, dtype=np.uint64)
    counters = ((np.uint64(step) << np.uint64(40))
                ^ (rows[:, None] << np.uint64(20)) ^ t[None, :])
    h = _philox_like(counters, cfg.seed)
    raw = (h % np.uint32(cfg.vocab)).astype(np.int64)
    gate = (h >> np.uint32(8)) % np.uint32(4)
    toks = raw.copy()
    for col in range(1, cfg.seq):
        prev = toks[:, col - 1]
        structured = (prev * 31 + 7) % cfg.vocab
        toks[:, col] = np.where(gate[:, col] > 0, structured, raw[:, col])
    return {"tokens": toks.astype(np.int32)}


def encdec_batch_for_step(cfg: DataConfig, d_model: int, enc_seq: int,
                          step: int, host_index: int = 0,
                          host_count: int = 1) -> dict:
    """Whisper-style batch: the tokens of :func:`batch_for_step` and
    precomputed frame embeddings (the reference's stub frontend),
    "enc_input" (rows, enc_seq, d_model) float32, 0.02 times standard
    normals from numpy's generator seeded by the step and host."""
    base = batch_for_step(cfg, step, host_index, host_count)
    rows = cfg.global_batch // host_count
    rng = np.random.default_rng((cfg.seed << 20) ^ step ^ (host_index << 10))
    enc = rng.standard_normal((rows, enc_seq, d_model), np.float32) * 0.02
    base["enc_input"] = enc.astype(np.float32)
    return base
