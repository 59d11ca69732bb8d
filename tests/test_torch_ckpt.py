"""The port's checkpoints against the JAX package's ``ckpt/checkpoint.py``.

Both packages write the same layout (``step_<N>/`` with one ``.npy`` per
leaf and a JSON manifest, leaves named by their dict keys and sequence
indices), so a checkpoint written by either restores in the other; and
the port keeps the reference's contracts: atomic rename, torn-save
immunity, keep-N pruning, restore onto the ``like_tree`` leaf's dtype and
device, the errors for shape drift and missing leaves.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.ckpt import checkpoint as jck
from repro.obs import Telemetry

from repro_torch.ckpt.checkpoint import (
    latest_step,
    prune_old,
    read_extra,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)


def _tree(seed=0):
    """A funnel stage state of mixed dtypes, nested, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.normal(size=(4, 8, 8)).astype(np.float32),
        "fidx": np.arange(4, dtype=np.int32),
        "valid": np.array([True, False, True, True]),
        "packed": rng.integers(-128, 128, (3, 16)).astype(np.int8),
        "nested": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                   "pair": [np.arange(2, dtype=np.int32),
                            np.float32(rng.normal())]},
        "skip": None,
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.asarray(tree))


def _flat(tree, path=""):
    """{name: numpy leaf} of a tree of tensors, jax or numpy arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}{i}/"))
        return out
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {path[:-1]: tree.numpy()}
    return {path[:-1]: np.asarray(tree)}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


def test_same_files_as_jax(tmp_path):
    """Leaf names, file names, shapes and dtypes, and each leaf's bytes,
    as JAX's save writes them."""
    tree = _tree(1)
    a = save_checkpoint(str(tmp_path / "t"), 3, _torch_tree(tree),
                        extra={"stage": "gather", "seq": 7})
    b = jck.save_checkpoint(str(tmp_path / "j"), 3, tree,
                            extra={"stage": "gather", "seq": 7})
    assert os.path.basename(a) == os.path.basename(b) == "step_00000003"
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    assert ma["leaves"] == mb["leaves"]
    assert (ma["step"], ma["extra"]) == (mb["step"], mb["extra"])
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for leaf in ma["leaves"]:
        assert np.load(os.path.join(a, leaf["file"])).tobytes() == \
            np.load(os.path.join(b, leaf["file"])).tobytes()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_cross_restore(tmp_path, writer):
    """A checkpoint either package wrote restores in the other, leaf for
    leaf, with the manifest's extra."""
    tree = _tree(2)
    extra = {"stage": "nn", "seq": 3}
    if writer == "torch":
        save_checkpoint(str(tmp_path), 5, _torch_tree(tree), extra=extra)
    else:
        jck.save_checkpoint(str(tmp_path), 5, tree, extra=extra)
    got, got_extra = restore_checkpoint(str(tmp_path), 5, _torch_tree(tree))
    assert got_extra == extra and got["skip"] is None
    assert isinstance(got["nested"]["pair"], list)
    _assert_trees_equal(got, tree)
    jgot, jextra = jck.restore_checkpoint(str(tmp_path), 5, tree)
    assert jextra == extra
    _assert_trees_equal(jgot, tree)
    assert read_extra(str(tmp_path), 5) == jck.read_extra(str(tmp_path), 5)


def test_restore_onto_the_like_trees_dtype_and_device(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.arange(6.0),
                                       "n": np.arange(3, dtype=np.int32)})
    like = {"x": torch.zeros(6, dtype=torch.float64),
            "n": np.zeros(3, np.int64)}
    got, _ = restore_checkpoint(str(tmp_path), 0, like)
    assert got["x"].dtype == torch.float64 and got["x"].device == \
        like["x"].device
    assert torch.equal(got["x"], torch.arange(6.0, dtype=torch.float64))
    assert got["n"].dtype == np.int64 and list(got["n"]) == [0, 1, 2]
    jgot, _ = jck.restore_checkpoint(str(tmp_path), 0,
                                     {"x": jnp.zeros(6), "n": np.zeros(3)})
    assert np.array_equal(np.asarray(jgot["x"]), np.arange(6.0))


def test_errors_equal_jax(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape drift") as te:
        restore_checkpoint(str(tmp_path), 0, {"x": torch.zeros(5)})
    with pytest.raises(ValueError) as je:
        jck.restore_checkpoint(str(tmp_path), 0, {"x": np.zeros((5,))})
    assert str(te.value) == str(je.value)
    like = {"x": torch.zeros(4), "y": torch.zeros(2)}
    with pytest.raises(KeyError, match="missing leaf y"):
        restore_checkpoint(str(tmp_path), 0, like)


def test_latest_step_and_torn_saves(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "nope")) is None
    for s in (1, 4, 2):
        save_checkpoint(d, s, _torch_tree(_tree(s)))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # crash mid-save
    os.makedirs(os.path.join(d, "step_00000007"))       # no manifest
    assert latest_step(d) == jck.latest_step(d) == 4


@pytest.mark.parametrize("keep", [1, 2, 4])
def test_prune_equal_jax(tmp_path, keep):
    for pkg in ("t", "j"):
        d = str(tmp_path / pkg)
        for s in range(6):
            save_checkpoint(d, s, {"x": torch.full((2,), float(s))})
        os.makedirs(os.path.join(d, "step_00000007.tmp"))
        (prune_old if pkg == "t" else jck.prune_old)(d, keep=keep)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    got, _ = restore_checkpoint(str(tmp_path / "t"), 5,
                                {"x": torch.zeros(2)})
    assert torch.equal(got["x"], torch.full((2,), 5.0))
    prune_old(str(tmp_path / "never"), keep=3)


def test_resave_replaces_atomically(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(2)})
    save_checkpoint(str(tmp_path), 0, {"x": torch.ones(2)})
    got, _ = restore_checkpoint(str(tmp_path), 0, {"x": torch.zeros(2)})
    assert torch.equal(got["x"], torch.ones(2))
    assert os.listdir(tmp_path) == ["step_00000000"]


def test_telemetry_counts_as_jax(tmp_path):
    """One JAX ``Telemetry`` handed to each package's save and restore
    counts the same saves, bytes and restores, and the same events."""
    tels = {}
    for pkg, mod, tree in (("t", None, _torch_tree(_tree(4))),
                           ("j", jck, _tree(4))):
        tel = Telemetry(enabled=True)
        d = str(tmp_path / pkg)
        save = save_checkpoint if mod is None else mod.save_checkpoint
        restore = restore_checkpoint if mod is None else \
            mod.restore_checkpoint
        save(d, 1, tree, telemetry=tel)
        restore(d, 1, tree, telemetry=tel)
        tels[pkg] = tel
    assert tels["t"].counters.totals() == tels["j"].counters.totals()
    assert [(r.kind, r.name, r.args) for r in tels["t"].trace.records()] == \
        [(r.kind, r.name, r.args) for r in tels["j"].trace.records()]
    off = Telemetry(enabled=False)
    save_checkpoint(str(tmp_path / "off"), 0, {"x": torch.zeros(1)},
                    telemetry=off)
    assert off.counters.totals() == {}


def test_named_tuples_are_named_as_jax_names_them(tmp_path):
    """A named tuple's fields are ``.field`` path parts in both packages,
    so the training loop's ``(params, OptState)`` tree keeps one name per
    leaf across them."""
    from repro.train.optimizer import OptState as JaxOptState

    from repro_torch.train.optimizer import OptState

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtree = ({"w": jnp.asarray(w)}, JaxOptState(
        step=jnp.int32(3), master={"w": jnp.asarray(w)},
        mu={"w": jnp.zeros((2, 3))}, nu={"w": jnp.ones((2, 3))}))
    ptree = ({"w": torch.tensor(w)}, OptState(
        step=torch.tensor(3, dtype=torch.int32), master={"w": torch.tensor(w)},
        mu={"w": torch.zeros((2, 3))}, nu={"w": torch.ones((2, 3))}))
    save_checkpoint(str(tmp_path / "p"), 1, ptree)
    jck.save_checkpoint(str(tmp_path / "j"), 1, jtree)

    def names(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            return sorted(x["name"] for x in json.load(f)["leaves"])

    assert names(tmp_path / "p") == names(tmp_path / "j")
    got, _ = restore_checkpoint(str(tmp_path / "j"), 1, ptree)
    assert isinstance(got[1], OptState) and int(got[1].step) == 3
    assert torch.equal(got[1].nu["w"], torch.ones((2, 3)))
    jgot, _ = jck.restore_checkpoint(str(tmp_path / "p"), 1, jtree)
    np.testing.assert_array_equal(np.asarray(jgot[1].master["w"]), w)


def test_bf16_leaves_are_written_as_jax_writes_them(tmp_path):
    """A bf16 leaf goes to disk as its raw 2-byte values with dtype
    "bfloat16" in the manifest, the bytes JAX writes; the port restores
    either package's as bf16."""
    vals = np.array([0.0, 1.5, -3.25, 1e-3, 6e4], np.float32)
    save_checkpoint(str(tmp_path / "p"), 1,
                    {"a": torch.tensor(vals).to(torch.bfloat16)})
    jck.save_checkpoint(str(tmp_path / "j"), 1,
                        {"a": jnp.asarray(vals, jnp.bfloat16)})
    raw = [np.load(str(tmp_path / d / "step_00000001" / "a.npy"))
           for d in ("p", "j")]
    assert raw[0].dtype == raw[1].dtype and raw[0].tobytes() == raw[1].tobytes()
    like = {"a": torch.zeros(5, dtype=torch.bfloat16)}
    for d in ("p", "j"):
        got, _ = restore_checkpoint(str(tmp_path / d), 1, like)
        assert got["a"].dtype == torch.bfloat16
        assert torch.equal(got["a"], torch.tensor(vals).to(torch.bfloat16))


def test_memory_checkpoints_hold_what_a_directory_holds(tmp_path):
    """chip_smoke.py's host-memory store keeps what the package's on-disk
    store keeps of the latest checkpoint; it holds that one alone (a
    full-width checkpoint is up to 40.7 GB of host memory), where the
    directory keeps the last ``keep``."""
    from chip_smoke import MemoryCheckpoints
    from repro_torch.ckpt.checkpoint import DirectoryCheckpoints

    tree = {"x": torch.arange(6.0), "h": torch.ones(3, dtype=torch.bfloat16),
            "n": [np.int32(4)]}
    like = {"x": torch.zeros(6), "h": torch.zeros(3, dtype=torch.bfloat16),
            "n": [np.int32(0)]}
    stores = [MemoryCheckpoints(), DirectoryCheckpoints(str(tmp_path))]
    for store in stores:
        for step in (2, 4, 6):
            store.save(step, tree, extra={"next_step": step})
            tree["x"] += 1          # a save is a copy, not a view
        store.prune(2)
        tree["x"] -= 3
        assert store.latest_step() == 6
        got, extra = store.restore(6, like)
        assert extra == {"next_step": 6}
        assert torch.equal(got["x"], torch.arange(6.0) + 2)
        assert got["h"].dtype == torch.bfloat16 and int(got["n"][0]) == 4
    got, _extra = stores[1].restore(4, like)
    assert torch.equal(got["x"], torch.arange(6.0) + 1)
    for step in (2, 4):
        with pytest.raises(KeyError):
            stores[0].restore(step, like)
