"""Atomic checkpoints of tensor trees — the port of the JAX package's
``ckpt/checkpoint.py``, in its on-disk layout.

* **Layout**: one ``.npy`` per leaf plus a JSON manifest in
  ``step_<N:08d>/``.  A tree is nested dicts (keys in sorted order),
  named tuples (fields in order, named ``.field``), lists and tuples (by
  index) over leaves (tensors, numpy arrays, scalars, or anything with
  ``shape`` and ``__array__``); a leaf is named by the ``/``-joined keys,
  fields and indices on its path, as JAX's ``tree_flatten_with_path``
  names it, so either package restores what the other wrote.  A bf16
  leaf is written as JAX writes one: its raw 2-byte values (numpy dtype
  ``V2``) with dtype "bfloat16" in the manifest, which the restore reads
  back as bf16.
* **Atomic**: writes go to ``step_N.tmp/`` and are renamed into place
  after the manifest is fsynced; a crash mid-save never corrupts the
  latest checkpoint (restore scans for the newest *complete* manifest).
* **Restore by name**: leaves come back by logical path, onto the device
  and dtype of the matching ``like_tree`` leaf; a ``like_tree`` leaf with
  a ``restore(array)`` method takes the array itself (in place) and stays
  in the tree.  One card has no mesh, so there is no ``shardings``
  argument.

The training loop reaches these functions through
:class:`DirectoryCheckpoints`.

``telemetry=`` on save and restore (any object with ``enabled``,
``counters.bump`` and ``emit``) charges the §15 counters and emits a
``ckpt`` trace event — accounting only, no behavioral change.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch


def _flatten(tree, path=()):
    """[(path, leaf)] in JAX's order: dict keys sorted, sequences by
    index; None holds no leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in _flatten(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _name(path) -> str:
    return "/".join(str(k) for k in path)


BF16_RAW = np.dtype("V2")      # how numpy holds JAX's bf16 on disk


def host_array(leaf) -> np.ndarray:
    """A leaf as the array its ``.npy`` holds (a bf16 tensor as its raw
    2-byte values)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view(BF16_RAW)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_RAW else str(arr.dtype)


def _on(telemetry) -> bool:
    return telemetry is not None and getattr(telemetry, "enabled", False)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    telemetry=None) -> str:
    """Atomically persist a tree.  Returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "time": time.time()}
    nbytes = 0
    for path, leaf in _flatten(tree):
        name = _name(path)
        arr = host_array(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        nbytes += int(arr.nbytes)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": _dtype_name(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if _on(telemetry):
        telemetry.counters.bump("ckpt.saves")
        telemetry.counters.bump("ckpt.bytes_written", nbytes)
        telemetry.emit("ckpt", "save", step=step,
                       n_leaves=len(manifest["leaves"]), bytes=nbytes)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete manifest (ignores torn .tmp saves)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            manifest = os.path.join(ckpt_dir, d, "manifest.json")
            if os.path.exists(manifest):
                steps.append(int(d[5:]))
    return max(steps) if steps else None


def read_extra(ckpt_dir: str, step: int) -> dict:
    """The manifest's ``extra`` dict alone, no leaves materialized."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)["extra"]


def _restore_leaf(arr: np.ndarray, like):
    if arr.dtype == BF16_RAW:                 # a bf16 leaf's raw values
        arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if hasattr(like, "restore"):
        like.restore(arr)
        return like
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return arr.astype(np.asarray(like).dtype)


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, telemetry=None):
    """Restore into the structure of ``like_tree``; returns ``(tree,
    extra)``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {l["name"]: l for l in manifest["leaves"]}

    out = []
    for path, leaf in _flatten(like_tree):
        name = _name(path)
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(d, by_name[name]["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape drift for {name}: ckpt {arr.shape} vs "
                             f"model {tuple(leaf.shape)}")
        out.append(_restore_leaf(arr, leaf))
    if _on(telemetry):
        telemetry.counters.bump("ckpt.restores")
        telemetry.emit("ckpt", "restore_tree", step=step, n_leaves=len(out))
    return _unflatten(like_tree, iter(out)), manifest["extra"]


def prune_old(ckpt_dir: str, keep: int = 3):
    """Delete every complete checkpoint but the newest ``keep``."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d[5:]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class DirectoryCheckpoints:
    """The functions above on one directory: the training loop's store."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir

    def save(self, step: int, tree, extra: dict | None = None):
        return save_checkpoint(self.ckpt_dir, step, tree, extra=extra)

    def latest_step(self):
        return latest_step(self.ckpt_dir)

    def restore(self, step: int, like_tree):
        return restore_checkpoint(self.ckpt_dir, step, like_tree)

    def prune(self, keep: int):
        prune_old(self.ckpt_dir, keep)
