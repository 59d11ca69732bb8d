"""Export the JAX encoder-decoder (whisper) reference for the PyTorch port.

Runs the JAX ``Model`` on the CPU in float32 on a reduced whisper-medium:
its head shape kept (d_head 64, plain MHA with 4 heads), d_model 256,
d_ff 512, vocab 512, 2 encoder and 2 decoder layers, 150 frames, with
weights from ``repro_torch.bridge.numpy_lm_params(cfg, seed=0)`` (the same
tree the port loads with ``lm_params_from``), and writes
``src/repro_torch/assets/lm_encdec_reference.npz``.

Serving: 4 prompts of 650 tokens (ragged against the port's 64-row flash
tiles) and 16 more tokens, uniform ids from numpy's generator seeded with
1, each prompt with 150 x 256 standard normal frames from numpy's
generator seeded with 2 (``bridge.encdec_record_frames``).  The jitted
``encode`` gives the encoder output; it stores the prefill's last-token
logits, the logits of 16 teacher-forced ``decode_step``s on the extra
tokens (the cross keys and values read from the cache that ``prefill``
filled), and ``generate``'s 16 greedy tokens from the prompts with the gap
between the top two logits and the largest |logit| at each step.  E, the
one-ulp sensitivity of those logits, is the largest move relative to each
step's largest |logit|: ULP_MARGIN times its largest over SERVE_ULP_SEEDS
draws that move every weight by one ulp up or down at random, plus the
move when the reference's
sinusoidal table is replaced by the port's (``repro_torch.models.layers.
sinusoidal_positions``: XLA's float32 exp rounds some frequencies an ulp
from it, which moves row p of the table by up to about p 2^-24).  The
port lies within the first of JAX with the port's table, by the second
from JAX itself, so the sum bounds it; the margin covers the port's
other roundings (every operation, not only the weights).  The swap rebinds the name in this
process only (``port_table``); the JAX package is not edited.

Training: one jitted ``make_train_step`` with ``AdamWConfig(warmup_steps=1)``
on ``encdec_batch_for_step(DataConfig(512, seq=650, global_batch=4,
seed=0), 256, 150, step=0)``: the loss, ce, global gradient norm and
learning rate, and per gradient leaf (``enc_stack`` and ``cross``
included) the float64 sums of g^2 and of g * p, p from
``bridge.lm_train_probe``; with each quantity's one-ulp E over
TRAIN_ULP_SEEDS draws, as ``torch_export_lm_train_reference.py`` defines
them but per leaf for a leaf's norm and probe, with the same margin and
each quantity's move under the port's table added.

These random-weight models are chaotic: the reference's init draws a
stacked leaf with its fan-in taken from the stacked axis (2 here), so the
attention logits are large and the softmax nearly one-hot, and one ulp of
every weight moves the logits by about 0.7% of their largest (E).

Only outputs and E are stored: ``numpy_lm_params`` rebuilds the weights,
the seeds the tokens and frames.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_encdec_reference.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np

from benchmarks.torch_export_lm_train_reference import one_ulp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "lm_encdec_reference.npz")

SEED = 0                   # numpy_lm_params
DATA_SEED = 1              # prompts and teacher tokens
FRAME_SEED = 2             # the serving frames
N_PROMPTS, PROMPT_LEN, N_STEPS = 4, 650, 16
DESC = {"arch": "whisper-medium", "smoke": False,
        "overrides": {"n_layers": 2, "enc_layers": 2, "enc_seq": 150,
                      "d_model": 256, "n_heads": 4, "n_kv": 4, "d_head": 64,
                      "d_ff": 512, "vocab": 512},
        "n_prompts": N_PROMPTS, "frame_seed": FRAME_SEED}
TRAIN_SEQ, TRAIN_BATCH, TRAIN_DATA_SEED = 650, 4, 0
OPT = {"warmup_steps": 1}
SERVE_ULP_SEEDS = tuple(range(5, 29))
TRAIN_ULP_SEEDS = tuple(range(5, 29))
# E is ULP_MARGIN times the largest one-ulp move plus the table's move: the
# port rounds every operation its own way (summation orders, exp, tanh),
# not only the weights, and one draw's move varies severalfold
ULP_MARGIN = 2


def configs():
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config
    from repro_torch.configs import registry as port_registry

    cfg = dataclasses.replace(get_config(DESC["arch"]),
                              param_dtype=jnp.float32, **DESC["overrides"])
    port_cfg = dataclasses.replace(port_registry.get_config(DESC["arch"]),
                                   param_dtype=torch.float32,
                                   **DESC["overrides"])
    return cfg, port_cfg


@contextlib.contextmanager
def port_table():
    """The reference's encoder with the port's sinusoidal table: the name
    ``sinusoidal_positions`` of ``repro.models.transformer`` rebound in
    this process while the block runs.  Jit a new ``Model``'s methods
    inside the block: a trace holds the table it was traced with."""
    import jax.numpy as jnp

    import repro.models.transformer as jax_transformer
    from repro_torch.models.layers import sinusoidal_positions

    def table(seq, d_model):
        return jnp.asarray(sinusoidal_positions(seq, d_model,
                                                device="cpu").numpy())

    kept = jax_transformer.sinusoidal_positions
    jax_transformer.sinusoidal_positions = table
    try:
        yield
    finally:
        jax_transformer.sinusoidal_positions = kept


def serve_fns(model):
    import jax
    return (jax.jit(model.encode), jax.jit(model.prefill),
            jax.jit(model.decode_step))


def teacher_forced(model, fns, params, frames, prompts, teacher):
    """(b, 1 + n, vocab): the prefill's logits, then one per decode step."""
    import jax.numpy as jnp

    encode, prefill, step = fns
    enc_out = encode(params, jnp.asarray(frames))
    logits, cache = prefill(params, jnp.asarray(prompts), enc_out)
    cache = model.pad_cache(cache, teacher.shape[1])
    out = [np.asarray(logits, np.float32)]
    for i in range(teacher.shape[1]):
        lg, cache = step(params, jnp.asarray(teacher[:, i:i + 1]), cache,
                         jnp.int32(prompts.shape[1] + i))
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, axis=1)


def serve_record(cfg, tree):
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import Model
    from repro.serve.engine import generate
    from repro_torch.bridge import encdec_record_frames

    model = Model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = np.random.default_rng(DATA_SEED).integers(
        0, cfg.vocab, (N_PROMPTS, PROMPT_LEN + N_STEPS)).astype(np.int32)
    prompts, teacher = toks[:, :PROMPT_LEN], toks[:, PROMPT_LEN:]
    frames = encdec_record_frames(DESC)
    fns = serve_fns(model)

    forced = teacher_forced(model, fns, params, frames, prompts, teacher)
    top = np.abs(forced).max(-1)

    def move(moved):
        return float((np.abs(moved - forced).max(-1) / top).max())

    e_ulp = max(move(teacher_forced(
        model, fns, jax.tree_util.tree_map(jnp.asarray, one_ulp(tree, s)),
        frames, prompts, teacher)) for s in SERVE_ULP_SEEDS)
    with port_table():
        other = Model(cfg)
        e_table = move(teacher_forced(other, serve_fns(other), params, frames,
                                      prompts, teacher))
    out = {"prompts": prompts, "teacher": teacher,
           "prefill_logits": forced[:, 0], "decode_logits": forced[:, 1:],
           "sensitivity": np.float32(ULP_MARGIN * e_ulp + e_table)}
    parts = {"ulp": e_ulp, "table": e_table}

    enc_out = fns[0](params, jnp.asarray(frames))
    greedy = np.asarray(generate(model, params, jnp.asarray(prompts),
                                 N_STEPS, enc_out=enc_out), np.int32)
    # the logits along the greedy path, for the near-tie rule
    lg, cache = fns[1](params, jnp.asarray(prompts), enc_out)
    cache = model.pad_cache(cache, N_STEPS)
    gaps, tops = [], []
    for i in range(N_STEPS):
        lg = np.asarray(lg, np.float32)
        if not np.array_equal(lg.argmax(-1), greedy[:, i]):
            raise AssertionError(f"step {i}: generate disagrees with argmax")
        srt = np.sort(lg, axis=-1)
        gaps.append(srt[:, -1] - srt[:, -2])
        tops.append(np.abs(lg).max(axis=-1))
        nxt, cache = fns[2](params, jnp.asarray(greedy[:, i:i + 1]), cache,
                            jnp.int32(PROMPT_LEN + i))
        lg = nxt[:, 0]
    out.update(greedy=greedy, greedy_gap=np.stack(gaps, 1),
               greedy_max=np.stack(tops, 1))
    return out, parts


def train_run(model, fns, tree, batch):
    """(step metrics, leaf names, per-leaf float64 sums of g^2 and
    g * probe) of one jitted JAX train step from ``tree``."""
    import jax
    import jax.numpy as jnp

    from repro.train.optimizer import init_opt_state
    from repro_torch.bridge import lm_train_probe

    grad_fn, step = fns
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (_l, _m), grads = grad_fn(params, batch)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    names = ["/".join(str(k.key) for k in path) for path, _g in flat]
    g = [np.asarray(x, np.float64) for _p, x in flat]
    g_sq = np.array([np.sum(x * x) for x in g])
    g_probe = np.array([np.sum(x * lm_train_probe(x.shape)) for x in g])
    _params, _opt, met = step(params, init_opt_state(params), batch)
    arrays = {k: np.array([np.float32(met[k])], np.float32)
              for k in ("loss", "ce", "grad_norm", "lr")}
    return arrays, names, g_sq, g_probe


def train_fns(model):
    import jax

    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step

    return (jax.jit(jax.value_and_grad(model.loss, has_aux=True)),
            jax.jit(make_train_step(model, AdamWConfig(**OPT))))


def train_record(cfg, tree):
    import jax.numpy as jnp

    from repro.data.pipeline import DataConfig, encdec_batch_for_step
    from repro.models.transformer import Model
    from repro_torch.bridge import lm_train_probe

    model = Model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=TRAIN_DATA_SEED)
    batch = {k: jnp.asarray(v) for k, v in encdec_batch_for_step(
        data, cfg.d_model, cfg.enc_seq, 0).items()}
    fns = train_fns(model)
    base = train_run(model, fns, tree, batch)
    moved = [train_run(model, fns, one_ulp(tree, s), batch)
             for s in TRAIN_ULP_SEEDS]
    with port_table():
        other = Model(cfg)
        tabled = train_run(other, train_fns(other), tree, batch)
    arrays, names, g_sq, g_probe = base
    shapes = dict(_leaf_shapes(tree))
    probe_norms = np.array([np.sqrt(np.sum(lm_train_probe(shapes[n]) ** 2))
                            for n in names])
    e_ulp = sensitivity(base, moved, probe_norms)
    e_table = sensitivity(base, [tabled], probe_norms)
    e = {k: (ULP_MARGIN * np.asarray(e_ulp[k])
             + np.asarray(e_table[k])).tolist() for k in e_ulp}
    meta = {"data": {"vocab": cfg.vocab, "seq": TRAIN_SEQ,
                     "global_batch": TRAIN_BATCH, "seed": TRAIN_DATA_SEED},
            "steps": 1, "opt": OPT, "leaves": names, "train_sensitivity": e,
            "train_sensitivity_parts": {"ulp": e_ulp, "table": e_table}}
    return meta, dict(arrays, g_sq=g_sq, g_probe=g_probe)


def sensitivity(base, moved_runs, probe_norms):
    """One-ulp E of each quantity: the loss, ce and grad norm relative to
    their size (a list with one entry, the step); per leaf, its |g|
    relative to |g| and its g . p relative to |g| |p| (a list over the
    leaves: a gradient that is zero in exact arithmetic, as the key bias's
    under a softmax, is rounding noise, which moves by its own size);
    each the largest over the draws."""
    arrays, _names, g_sq, g_probe = base
    norm = np.sqrt(g_sq)
    e = {"loss": 0.0, "ce": 0.0, "grad_norm": 0.0,
         "g_norm": np.zeros(len(norm)), "g_probe": np.zeros(len(norm))}
    for m_arrays, _n, m_sq, m_probe in moved_runs:
        for k in ("loss", "ce", "grad_norm"):
            e[k] = max(e[k], float(abs(np.float64(m_arrays[k][0])
                                       - arrays[k][0]) / abs(arrays[k][0])))
        e["g_norm"] = np.maximum(e["g_norm"], np.abs(np.sqrt(m_sq) - norm)
                                 / norm)
        e["g_probe"] = np.maximum(e["g_probe"], np.abs(m_probe - g_probe)
                                  / (norm * probe_norms))
    return {k: v.tolist() if isinstance(v, np.ndarray) else [v]
            for k, v in e.items()}


def _leaf_shapes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_shapes(tree[k], path + (k,))
    else:
        yield "/".join(path), np.shape(tree)


def main(out=OUT):
    from repro_torch.bridge import numpy_lm_params

    t0 = time.perf_counter()
    cfg, port_cfg = configs()
    tree = numpy_lm_params(port_cfg, SEED)
    serve, parts = serve_record(cfg, tree)
    meta, train = train_record(cfg, tree)
    meta["serve_sensitivity_parts"] = parts
    arrays = {"seed": np.int64(SEED),
              "config": np.array(json.dumps(dict(DESC, **meta)))}
    arrays.update(serve)
    arrays.update(train)
    gap = serve["greedy_gap"] / serve["greedy_max"]
    e = meta["train_sensitivity"]
    print(f"whisper: {time.perf_counter() - t0:.1f} s; serving E "
          f"{float(serve['sensitivity']):.3g} (one ulp {parts['ulp']:.3g}, "
          f"the port's table {parts['table']:.3g}); smallest top-2 gap "
          f"{gap.min():.3g} of max |logit|; step-0 loss "
          f"{float(train['loss'][0])!r}, grad norm "
          f"{float(train['grad_norm'][0])!r}; training E: loss "
          f"{e['loss'][0]:.3g}, grad norm {e['grad_norm'][0]:.3g}, leaf "
          f"norms {min(e['g_norm']):.3g} to {max(e['g_norm']):.3g}, probes "
          f"{min(e['g_probe']):.3g} to {max(e['g_probe']):.3g}", flush=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
