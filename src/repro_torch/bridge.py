"""Carry trained parameters and JAX records into the port.

The port's main path runs on parameters trained by the JAX package (the
port trains its own with ``camera.viola_jones.train_cascade`` and
``camera.face_nn.train_face_nn``, held to these).  These functions take
them duck-typed — objects with the reference's field names (``Cascade``:
``feats`` of ``HaarFeature``-like objects or (kind, y, x, h, w) rows,
``thresholds``, ``polarity``, ``alphas``, ``stage_sizes``,
``stage_thresholds``; ``FaceNN``: ``w1``, ``b1``, ``w2``, ``b2``), with
any array type numpy can read — and build the port's own ``Cascade`` /
``FaceNN``.

:func:`load_fa_reference` reads ``assets/fa_reference.npz``: the
full-width §III workload's trained parameters, scan and calibrated
capacities, and the JAX executor's outputs on ``security_video()``
(written by ``benchmarks/torch_export_fa_reference.py``).
:func:`load_offload_reference` reads ``assets/offload_reference.npz``: the
JAX split executor's wire bytes, payload hashes and counts on the same
workload at every cut and codec width (written by
``benchmarks/torch_export_offload_reference.py``).
:func:`load_vr_reference` reads ``assets/vr_reference.npz``: the JAX VR
rig executor's rough disparities, depth, panorama samples and split
executor wire bytes on the §IV rig at the working size (8 pairs of
270x480) and at full width (8 pairs of 2160x3840), with the parameters it
ran (written by ``benchmarks/torch_export_vr_reference.py``).

:func:`load_resilience_reference` reads
``assets/resilience_reference.npz``: the JAX offload session's payload
CRCs, delivery records, ladder metrics, brownout and congestion numbers on
the full-width §III workload, with every cell's injector parameters
(written by ``benchmarks/torch_export_resilience_reference.py``).

:func:`load_serving_reference` reads ``assets/serving_reference.npz``: the
JAX ``StreamingServer`` on the full-width §III workload over an 8-stream
fleet (local, sensor-8, motion-8, vj-8), clean and under a Gilbert-Elliott
chaos spec: every tick report and completion, with the fleet, its videos,
the enqueue script and the config it ran (written by
``benchmarks/torch_export_serving_reference.py``).

:func:`load_train_reference` reads ``assets/train_reference.npz``: the
initial weights and the batch-index schedule from which JAX trained the
NN of ``fa_reference.npz``, JAX's classification error of that NN on its
training windows, and JAX's ``cascade_apply`` of the asset's cascade on
the cascade's training windows (written by
``benchmarks/torch_export_train_reference.py``).

The LM stack has no trained weights: :func:`numpy_lm_params` draws a
parameter tree in the JAX ``Model.init`` layout from numpy's generator, so
the same weights can go to the JAX model and, through
:func:`lm_params_from`, to the port's.  :func:`load_lm_reference` reads
``assets/lm_reference.npz``: the JAX model's logits and greedy tokens on
two reduced float32 configs with those weights (written by
``benchmarks/torch_export_lm_reference.py``).
:func:`load_lm_encdec_reference` reads ``assets/lm_encdec_reference.npz``:
the same for a reduced float32 whisper (encoder-decoder) with its frames,
and one JAX training step on it (written by
``benchmarks/torch_export_lm_encdec_reference.py``).
:func:`load_lm_moe_reference`, :func:`load_lm_mla_reference` and
:func:`load_lm_hybrid_reference` read the MoE records (mixtral's,
deepseek's and jamba's reduced float32 configs, written by
``benchmarks/torch_export_lm_moe_reference.py``,
``torch_export_lm_mla_reference.py`` and
``torch_export_lm_hybrid_reference.py``).

Training trees: :func:`to_jax_tree` and :func:`from_jax_tree` carry the
port's per-layer parameters, gradients or optimizer moments (dicts keyed
by parameter name) to and from the JAX tree layout (a dense prefix's
layers in the list ``prefix``, ``stack/sub{j}`` leaves with a leading
period axis, ``enc_stack`` leaves with a leading encoder-layer axis),
and :func:`train_state_tree` is the
``(params, OptState)`` tree that JAX's ``train`` checkpoints, with leaves
that stack on the host when saved and restore in place, so a loop
checkpoint written by either package resumes in the other.
:func:`load_lm_train_reference` reads ``assets/lm_train_reference.npz``:
the JAX train step's losses, gradient norms, learning rates and per-leaf
gradient probes on the two configs of ``lm_reference.npz`` (written by
``benchmarks/torch_export_lm_train_reference.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.camera.face_nn import FaceNN
from repro_torch.camera.viola_jones import Cascade, HaarFeature
from repro_torch.ckpt.checkpoint import host_array
from repro_torch.configs.lm_archs import MambaConfig, MLAConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device, to_numpy
from repro_torch.models.layers import numpy_leaf, tree_map
from repro_torch.models.transformer import STACKED, Model, model_specs

ASSET = Path(__file__).resolve().parent / "assets" / "fa_reference.npz"
OFFLOAD_ASSET = ASSET.parent / "offload_reference.npz"
VR_ASSET = ASSET.parent / "vr_reference.npz"
LM_ASSET = ASSET.parent / "lm_reference.npz"
RESILIENCE_ASSET = ASSET.parent / "resilience_reference.npz"
SERVING_ASSET = ASSET.parent / "serving_reference.npz"
TRAIN_ASSET = ASSET.parent / "train_reference.npz"
LM_TRAIN_ASSET = ASSET.parent / "lm_train_reference.npz"
LM_ENCDEC_ASSET = ASSET.parent / "lm_encdec_reference.npz"
LM_MOE_ASSET = ASSET.parent / "lm_moe_reference.npz"
LM_MLA_ASSET = ASSET.parent / "lm_mla_reference.npz"
LM_HYBRID_ASSET = ASSET.parent / "lm_hybrid_reference.npz"
LM_MOE_TRAIN_ASSET = ASSET.parent / "lm_moe_train_reference.npz"
LM_MLA_TRAIN_ASSET = ASSET.parent / "lm_mla_train_reference.npz"
LM_HYBRID_TRAIN_ASSET = ASSET.parent / "lm_hybrid_train_reference.npz"
LM_COMPRESSED_TRAIN_ASSET = (ASSET.parent
                             / "lm_compressed_train_reference.npz")


def _feature(f) -> HaarFeature:
    if hasattr(f, "kind"):
        return HaarFeature(int(f.kind), int(f.y), int(f.x), int(f.h),
                           int(f.w))
    kind, y, x, h, w = (int(v) for v in f)
    return HaarFeature(kind, y, x, h, w)


def cascade_from(ref) -> Cascade:
    """The port's ``Cascade`` from a reference ``Cascade`` (or anything with
    its fields)."""
    return Cascade(
        feats=[_feature(f) for f in ref.feats],
        thresholds=to_numpy(ref.thresholds),
        polarity=to_numpy(ref.polarity),
        alphas=to_numpy(ref.alphas),
        stage_sizes=[int(s) for s in ref.stage_sizes],
        stage_thresholds=to_numpy(ref.stage_thresholds))


def face_nn_from(ref, device=None) -> FaceNN:
    """The port's ``FaceNN`` (float32 tensors on ``device``, the card when
    None) from a reference ``FaceNN`` (or anything with its fields)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(to_numpy(a).astype(np.float32), device=dev)

    return FaceNN(w1=t(ref.w1), b1=t(ref.b1), w2=t(ref.w2), b2=t(ref.b2))


@dataclasses.dataclass(frozen=True)
class FAReference:
    """The full-width §III workload and the JAX executor's answer on it."""

    cascade: Cascade
    nn: FaceNN
    scan: dict                    # scale_factor, step, adaptive
    video: dict                   # security_video() arguments
    frame_capacity: int
    window_capacity: int
    cascade_capacities: list
    outputs: dict                 # FAExecResult fields as numpy arrays


def load_fa_reference(path=None, device=None) -> FAReference:
    """Load the exported reference; the NN goes to ``device`` (the card
    when None)."""
    with np.load(ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}

    ref = SimpleNamespace(**{k: z[k] for k in (
        "feats", "thresholds", "polarity", "alphas", "stage_sizes",
        "stage_thresholds")})
    nn = SimpleNamespace(**{k: z[k] for k in ("w1", "b1", "w2", "b2")})
    sf, st, ad = (float(v) for v in z["scan"])
    n_frames, h, w, motion_frames, seed = (int(v) for v in z["video"])
    return FAReference(
        cascade=cascade_from(ref),
        nn=face_nn_from(nn, device),
        scan=dict(scale_factor=sf, step=st, adaptive=bool(ad)),
        video=dict(n_frames=n_frames, h=h, w=w, motion_frames=motion_frames,
                   faces_in_motion=float(z["video_faces_in_motion"]),
                   seed=seed),
        frame_capacity=int(z["frame_capacity"]),
        window_capacity=int(z["window_capacity"]),
        cascade_capacities=[int(c) for c in z["cascade_capacities"]],
        outputs={k: z[k] for k in ("motion", "n_windows", "n_auth",
                                   "window_id", "window_valid", "scores",
                                   "total_dropped")})


@dataclasses.dataclass(frozen=True)
class TrainReference:
    """What JAX trained the §III NN from, and its training outcomes."""

    init: FaceNN                  # init_face_nn(PRNGKey(0), 400, 8)
    batches: torch.Tensor         # (1500, 128) int64 batch indices
    classification_error: float   # the trained NN, float path, 800 windows
    accepted: np.ndarray          # (2300,) cascade_apply of the asset's
    stage_evals: np.ndarray       # (2300,) cascade on its training windows
    n_per_class: int              # face_dataset(n_per_class, seed)
    data_seed: int
    n_negatives: int              # hard negatives from security_video()


def load_train_reference(path=None, device=None) -> TrainReference:
    """Load the exported training inputs; the weights and the schedule go
    to ``device`` (the card when None)."""
    with np.load(TRAIN_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    n_per_class, seed, n_neg = (int(v) for v in z["dataset"])
    return TrainReference(
        init=face_nn_from(SimpleNamespace(**{k: z[k] for k in (
            "w1", "b1", "w2", "b2")}), device),
        batches=torch.as_tensor(z["batches"].astype(np.int64),
                                device=resolve_device(device)),
        classification_error=float(z["classification_error"]),
        accepted=z["accepted"], stage_evals=z["stage_evals"],
        n_per_class=n_per_class, data_seed=seed, n_negatives=n_neg)

@dataclasses.dataclass(frozen=True)
class OffloadReference:
    """The JAX split executor on the full-width §III workload.  Dicts are
    keyed by (cut, bits), bits None for the raw f32 payload."""

    nbytes: dict                  # measured wire bytes of the payload
    capacity_bytes: dict          # padded wire bytes of the payload
    n_windows: dict               # total windows of the result
    n_auth: dict                  # total auths of the result
    packed_sha256: dict           # sensor/motion cuts at 16, 8, 4 bits
    scales_sha256: dict
    stats: dict                   # FAWorkloadStats fields of the fused run
    analytic_bytes: dict          # cut -> fa_pipeline bytes per frame
    calibration: dict             # calibrate_fa constants


def load_offload_reference(path=None) -> OffloadReference:
    with np.load(OFFLOAD_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    cuts = [str(c) for c in z["cuts"]]
    bits = [None if int(b) == 0 else int(b) for b in z["bits"]]

    def grid(a, cast):
        return {(c, b): cast(a[i, j]) for i, c in enumerate(cuts)
                for j, b in enumerate(bits)}

    hashed = [(str(c), int(b)) for c in z["hash_cuts"]
              for b in z["hash_bits"]]
    return OffloadReference(
        nbytes=grid(z["nbytes"], float),
        capacity_bytes=grid(z["capacity_bytes"], float),
        n_windows=grid(z["n_windows"], int),
        n_auth=grid(z["n_auth"], int),
        packed_sha256=dict(zip(hashed, (str(h) for h in
                                        z["packed_sha256"].reshape(-1)))),
        scales_sha256=dict(zip(hashed, (str(h) for h in
                                        z["scales_sha256"].reshape(-1)))),
        stats=dict(zip(("n_frames", "motion_frames", "windows_to_nn"),
                       (int(v) for v in z["stats"]))),
        analytic_bytes=dict(zip(cuts, (float(v) for v in
                                       z["analytic_bytes"]))),
        calibration=dict(zip(("rf_joules_per_byte", "nn_effective_w",
                              "base_compute_w"),
                             (float(v) for v in z["calibration"]))))


@dataclasses.dataclass(frozen=True)
class VRReference:
    """The JAX VR rig on ``stereo_pair(h, w, seed=s)``, s < n_pairs, at the
    working size and at full width.  Wire-byte dicts are keyed by
    (cut, bits), bits None for the raw f32 payload.  ``e_jax`` values are
    the largest |SAD32 - SAD64| of the JAX cost volume over a region's
    pixels and all hypotheses (the near-tie rule's rounding error)."""

    params: dict                  # n_pairs, sigma_spatial, max_disp, ...
    work_hw: tuple
    work_rough: np.ndarray        # (n_pairs, h, w) uint8
    work_e_jax: np.ndarray        # (n_pairs,) per whole pair
    work_depth0: np.ndarray       # (h, w) f32, pair 0
    work_lpano: np.ndarray        # left panorama [::work_pano_stride] x2
    work_wire_b: dict
    full_hw: tuple
    full_hist: np.ndarray         # (n_pairs, max_disp + 1) rough histogram
    full_crop_origins: np.ndarray  # (4, 2) top-left corners (y, x)
    full_crops: np.ndarray        # (4, crop, crop) uint8, pair 0
    full_e_jax: np.ndarray        # (4,) per crop
    full_depth0: np.ndarray       # pair 0 depth [::full_stride] x2
    full_lpano: np.ndarray        # left panorama [::full_pano_stride] x2
    full_pano_shape: tuple
    full_wire_b: dict
    capture_sha256: dict          # (bits, field) -> hex, full width


def load_vr_reference(path=None) -> VRReference:
    with np.load(VR_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    cuts = [str(c) for c in z["cuts"]]
    bits = [None if int(b) == 0 else int(b) for b in z["bits"]]

    def grid(a):
        return {(c, b): float(a[i, j]) for i, c in enumerate(cuts)
                for j, b in enumerate(bits)}

    fields = ("lefts", "lefts_scales", "rights", "rights_scales")
    sha = {(int(b), f): str(z["full_capture_sha256"][j, k])
           for j, b in enumerate(z["hash_bits"])
           for k, f in enumerate(fields)}
    params = {k: z[k].item() for k in (
        "n_pairs", "sigma_spatial", "max_disp", "n_iters", "ipd_px",
        "patch", "crop", "work_pano_stride", "full_stride",
        "full_pano_stride")}
    params["seeds"] = [int(s) for s in z["seeds"]]
    return VRReference(
        params=params, work_hw=tuple(int(v) for v in z["work_hw"]),
        work_rough=z["work_rough"], work_e_jax=z["work_e_jax"],
        work_depth0=z["work_depth0"], work_lpano=z["work_lpano"],
        work_wire_b=grid(z["work_wire_b"]),
        full_hw=tuple(int(v) for v in z["full_hw"]),
        full_hist=z["full_hist"], full_crop_origins=z["full_crop_origins"],
        full_crops=z["full_crops"], full_e_jax=z["full_e_jax"],
        full_depth0=z["full_depth0"], full_lpano=z["full_lpano"],
        full_pano_shape=tuple(int(v) for v in z["full_pano_shape"]),
        full_wire_b=grid(z["full_wire_b"]), capture_sha256=sha)


@dataclasses.dataclass(frozen=True)
class ResilienceReference:
    """The JAX offload sessions on the full-width §III workload.  Records
    are ``dataclasses.astuple`` of ``DeliveryRecord``, per send; cells
    carry their injector's arguments, ladder cut and number of sends."""

    crc: dict                     # (cut, bits) -> zero-fault payload CRC
    cells: dict                   # name -> injector args, cut, sends
    records: dict                 # name -> [DeliveryRecord tuple, ...]
    metrics: dict                 # name -> flip, retx_overhead, ...
    brownout: dict                # stage counters and the run's params
    congestion: dict              # p99_clean_s, p99_congested_s, ...


def load_resilience_reference(path=None) -> ResilienceReference:
    import json

    with np.load(RESILIENCE_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    cuts = [str(c) for c in z["record_cuts"]]

    def record(row):
        ints = [int(v) for v in row]
        return (ints[0], cuts[ints[1]], ints[2] or None, bool(ints[3]),
                bool(ints[4]), ints[5], ints[6], ints[7], float(row[8]),
                float(row[9]), float(row[10]), float(row[11]),
                float(row[12]), ints[13], ints[14], float(row[15]))

    crc = {(str(c), None if int(b) == 0 else int(b)): int(z["crc"][i, j])
           for i, c in enumerate(z["crc_cuts"])
           for j, b in enumerate(z["crc_bits"])}
    metrics = json.loads(str(z["metrics"]))
    for m in metrics.values():
        m["final_rung"] = tuple(m["final_rung"])
    return ResilienceReference(
        crc=crc, cells=json.loads(str(z["cells"])),
        records={k[len("records_"):]: [record(r) for r in v]
                 for k, v in z.items() if k.startswith("records_")},
        metrics=metrics, brownout=json.loads(str(z["brownout"])),
        congestion=json.loads(str(z["congestion"])))


@dataclasses.dataclass(frozen=True)
class ServingReference:
    """The JAX streaming server on the full-width §III workload.  A run's
    ``reports`` are its tick reports as dicts (the wall clock aside), each
    with its completions' fields; ``results[run][field]`` concatenates the
    completions' result arrays along the frame axis (``motion_dropped``:
    one entry per completion)."""

    config: dict                  # ServeConfig keyword arguments
    ticks: int
    frames_per_tick: int          # each stream's feed, also its fps
    streams: list                 # [(sid, cut, bits, video index)]
    videos: list                  # security_video() arguments per video
    video_sha256: list
    script: list                  # [(tick, stream, video, frame, t)]
    chaos: dict                   # GilbertElliott args, max_retries, seed
    reports: dict                 # run -> [tick report dict]
    results: dict                 # run -> field -> array
    audits: dict                  # run -> seq_audit() at the end


def load_serving_reference(path=None) -> ServingReference:
    import json

    with np.load(SERVING_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    meta = json.loads(str(z["meta"]))
    runs = [k[:-len("_reports")] for k in z if k.endswith("_reports")]
    script = [(int(a), int(b), int(c), int(d), float(t))
              for (a, b, c, d), t in zip(z["script"], z["script_t"])]
    return ServingReference(
        config=meta["config"], ticks=int(meta["ticks"]),
        frames_per_tick=int(meta["frames_per_tick"]),
        streams=[(s, c, b, int(v)) for s, c, b, v in meta["streams"]],
        videos=meta["videos"], video_sha256=meta["video_sha256"],
        script=script, chaos=meta["chaos"],
        reports={r: json.loads(str(z[f"{r}_reports"])) for r in runs},
        results={r: {k[len(r) + 1:]: v for k, v in z.items()
                     if k.startswith(r + "_")
                     and k not in (f"{r}_reports", f"{r}_audit")}
                 for r in runs},
        audits={r: json.loads(str(z[f"{r}_audit"])) for r in runs})


def numpy_lm_params(cfg, seed: int) -> dict:
    """A parameter tree for ``cfg`` laid out as the JAX ``Model(cfg).init``
    tree (a dense prefix's layers unstacked in the list ``prefix``,
    ``stack/sub{j}`` leaves with a leading period axis, an
    encoder-decoder's ``enc_stack`` leaves with a leading layer axis),
    float32,
    each leaf drawn from its spec's distribution with numpy's generator
    seeded with ``seed``, leaves in the reference's flatten order."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: numpy_leaf(s, rng), model_specs(cfg))


def lm_params_from(params_np: dict, cfg, device=None) -> Model:
    """The port's ``Model`` for ``cfg`` on ``device`` (the card when None)
    holding a parameter tree in the JAX layout (numpy arrays, or anything
    numpy reads as float32): ``prefix[i]`` goes to layer i,
    ``stack/sub{j}[i]`` to layer ``first_dense + i * period + j``,
    ``enc_stack[i]`` to encoder layer i, each leaf cast to its spec's
    dtype."""
    return Model(cfg, device).load_tree(params_np)


@dataclasses.dataclass(frozen=True)
class LMRecord:
    """The JAX model on one reduced float32 config with
    ``numpy_lm_params(cfg, seed)`` weights.  Prompts run through
    ``prefill``; ``teacher`` tokens are then fed one ``decode_step`` at a
    time; ``greedy`` is ``generate``'s output from the prompts, with the
    gap between the top two logits and the largest |logit| of each step.
    ``sensitivity`` is how far the JAX logits move, relative to a step's
    largest |logit|, when every weight moves by one ulp."""

    cfg: object
    seed: int
    sensitivity: float
    prompts: np.ndarray           # (b, s) int32
    teacher: np.ndarray           # (b, n) int32
    prefill_logits: np.ndarray    # (b, vocab) f32
    decode_logits: np.ndarray     # (b, n, vocab) f32
    greedy: np.ndarray            # (b, n) int32
    greedy_gap: np.ndarray        # (b, n) f32
    greedy_max: np.ndarray        # (b, n) f32
    frames: np.ndarray | None = None


def load_lm_reference(path=None) -> dict:
    """name -> :class:`LMRecord` (names: "yi", "rwkv")."""
    import json

    with np.load(LM_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    out = {}
    for name in (str(n) for n in z["names"]):
        desc = json.loads(str(z[f"{name}_config"]))
        cfg = dataclasses.replace(
            get_config(desc["arch"], smoke=desc["smoke"]),
            param_dtype=torch.float32, **desc["overrides"])
        out[name] = LMRecord(
            cfg=cfg, seed=int(z["seed"]),
            sensitivity=float(z[f"{name}_sensitivity"]), **{
            f: z[f"{name}_{f}"] for f in (
                "prompts", "teacher", "prefill_logits", "decode_logits",
                "greedy", "greedy_gap", "greedy_max")})
    return out


def record_overrides(desc: dict) -> dict:
    """A record's config overrides as ``dataclasses.replace`` takes them:
    an "mla" or "mamba" entry (a dict of fields) as an ``MLAConfig`` or a
    ``MambaConfig``."""
    over = dict(desc["overrides"])
    for key, kind in (("mla", MLAConfig), ("mamba", MambaConfig)):
        if key in over:
            over[key] = kind(**over[key])
    return over


def load_lm_mla_reference(path=None):
    """:func:`load_lm_moe_reference` of the JAX MLA record
    (``assets/lm_mla_reference.npz``: deepseek's smoke config in float32 at
    the flash kernel's MLA widths, capacity factor 1.25)."""
    return load_lm_moe_reference(LM_MLA_ASSET if path is None else path)


def load_lm_hybrid_reference(path=None):
    """:func:`load_lm_moe_reference` of the JAX hybrid record
    (``assets/lm_hybrid_reference.npz``: jamba's smoke config in float32,
    Mamba layers with attention at layers 2 and 6 and MoE on odd layers,
    at the flash kernel's d_head of 128 and the published d_state of 16,
    capacity factor 1.25)."""
    return load_lm_moe_reference(LM_HYBRID_ASSET if path is None else path)


def load_lm_moe_reference(path=None):
    """(:class:`LMRecord`, extras) of the JAX MoE record (mixtral's smoke
    config in float32 at capacity factor 1.25): the record's served
    logits and greedy tokens with E of the served logits as its
    ``sensitivity``, and ``extras`` with the full forward's "logits",
    "loss", "ce", "aux", each layer's dropped assignments ("forward_drops"
    and "prefill_drops" (layers,), "decode_drops" (steps, layers)), and
    "sensitivity": E for each of "logits", "served", "loss", "ce", "aux"."""
    import json

    with np.load(LM_MOE_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    desc = json.loads(str(z["config"]))
    cfg = dataclasses.replace(
        get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **record_overrides(desc))
    sens = json.loads(str(z["sensitivity"]))
    rec = LMRecord(cfg=cfg, seed=int(z["seed"]),
                   sensitivity=float(sens["served"]), **{
                       f: z[f] for f in (
                           "prompts", "teacher", "prefill_logits",
                           "decode_logits", "greedy", "greedy_gap",
                           "greedy_max")})
    extras = {k: z[k] for k in ("logits", "loss", "ce", "aux",
                                "forward_drops", "prefill_drops",
                                "decode_drops")}
    extras["sensitivity"] = sens
    return rec, extras


# -- training trees -----------------------------------------------------------


def leaf_layout(model) -> list:
    """[(JAX path, port parameter names)] in the reference's leaf order; a
    stacked leaf (``stack/...``) lists its slices in layer order; a path
    through the dense prefix holds the layer's index in ``prefix``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(path, [names[id(t)] for t in tensors])
            for path, _s, tensors in model._leaves()]


def _put(tree: dict, path, leaf):
    """Set ``leaf`` at ``path``, making dicts, and lists where the next
    key is an index (the prefix's layers, put in order)."""
    for k, nxt in zip(path[:-1], path[1:]):
        new = [] if isinstance(nxt, int) else {}
        if isinstance(tree, list):
            if k == len(tree):
                tree.append(new)
            tree = tree[k]
        else:
            tree = tree.setdefault(k, new)
    if isinstance(tree, list):
        tree.append(leaf)
    else:
        tree[path[-1]] = leaf


def to_jax_tree(model, named: dict) -> dict:
    """A dict keyed by parameter name (parameters, gradients, moments) as
    the JAX tree: stacked leaves stacked along a leading period axis."""
    out = {}
    for path, names in leaf_layout(model):
        leaf = (torch.stack([named[n] for n in names])
                if path[0] in STACKED else named[names[0]])
        _put(out, path, leaf)
    return out


def from_jax_tree(model, tree, device=None, dtype=None) -> dict:
    """The inverse of :func:`to_jax_tree` for a tree of anything numpy
    reads: name -> tensor on ``device`` (the model's when None), in
    ``dtype`` (float32 when None)."""
    device = model.device if device is None else device
    out = {}
    for path, names in leaf_layout(model):
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a, dtype=np.float32)
        if path[0] not in STACKED:
            a = a[None]
        for i, n in enumerate(names):
            out[n] = torch.tensor(a[i], dtype=dtype or torch.float32,
                                  device=device)
    return out


def ef_from_jax_tree(model, tree, device=None) -> dict:
    """The reference's error-feedback residual tree (``init_ef_states``'s
    layout: the parameters' tree, anything numpy reads) as the port's
    residuals (``train.step.init_ef_states``'s dict: JAX path joined by
    "/" -> float32 tensor of the leaf's shape, a stacked leaf whole), on
    ``device`` (the model's when None)."""
    device = model.device if device is None else device
    out = {}
    for path, _names in leaf_layout(model):
        a = tree
        for k in path:
            a = a[k]
        out["/".join(str(k) for k in path)] = torch.tensor(
            np.asarray(a, dtype=np.float32), device=device)
    return out


class StackedLeaf:
    """One leaf of a checkpoint tree over the port's per-layer tensors:
    stacked on the host only when saved (bf16 as its raw 2-byte values, as
    JAX writes it), and copied back into those tensors in place when
    restored, so a full-width state never holds a second copy on the
    card."""

    def __init__(self, tensors, stacked: bool):
        self.tensors, self.stacked = tensors, stacked
        first = tensors[0]
        self.shape = ((len(tensors),) + tuple(first.shape) if stacked
                      else tuple(first.shape))

    def __array__(self, dtype=None, copy=None):
        host = [host_array(t) for t in self.tensors]
        a = np.stack(host) if self.stacked else host[0]
        return a if dtype is None else a.astype(dtype)

    @torch.no_grad()
    def restore(self, arr):
        """Copy a restored leaf (numpy, or a bf16 tensor on the host) into
        the tensors, cast to their dtype."""
        parts = arr if self.stacked else arr[None]
        for t, a in zip(self.tensors, parts):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            t.copy_(a)


def train_state_tree(model, opt_state):
    """``(params, OptState(step, master, mu, nu))`` in the JAX layout, the
    tree JAX's ``train`` checkpoints, with :class:`StackedLeaf` leaves over
    the model's parameters and the state's tensors.  ``step`` is the
    state's own tensor: a restore returns a new one in the tree."""
    from repro_torch.train.optimizer import OptState

    def tree(named):
        out = {}
        for path, names in leaf_layout(model):
            _put(out, path, StackedLeaf([named[n] for n in names],
                                        path[0] in STACKED))
        return out

    return (tree(model.named_leaves()),
            OptState(step=opt_state.step, master=tree(opt_state.master),
                     mu=tree(opt_state.mu), nu=tree(opt_state.nu)))


@dataclasses.dataclass(frozen=True)
class LMTrainRecord:
    """The JAX train step on one reduced float32 config with
    ``numpy_lm_params(cfg, seed)`` weights: per step the loss, ce, global
    gradient norm and learning rate; at step 0, per leaf (JAX paths joined
    by "/"), the float64 sums of g^2 and of g * probe, the probe drawn by
    :func:`lm_train_probe`; and each quantity's one-ulp sensitivity E (its
    move, relative to its size, when every weight moves by one ulp): a list
    per step for "loss", "ce" and "grad_norm", one number for "g_norm" (a
    leaf's |g|) and "g_probe" (a leaf's g . p relative to |g| |p|).  A MoE
    record also holds each step's aux loss (with its E under "aux") and
    the assignments each MoE layer drops in the step's forward."""

    cfg: object
    seed: int
    data: dict                    # DataConfig fields
    steps: int
    opt: dict                     # AdamWConfig fields
    loss: np.ndarray              # (steps,)
    ce: np.ndarray
    grad_norm: np.ndarray
    lr: np.ndarray
    leaf_names: list
    g_sq: np.ndarray              # (leaves,) float64
    g_probe: np.ndarray           # (leaves,) float64
    sensitivity: dict             # quantity -> E
    aux: np.ndarray | None = None     # (steps,)
    drops: np.ndarray | None = None   # (steps, MoE layers) int


PROBE_SEED = 7


def lm_train_probe(shape) -> np.ndarray:
    """The probe vector of one gradient leaf: standard normals from numpy's
    generator seeded with PROBE_SEED, float64."""
    return np.random.default_rng(PROBE_SEED).standard_normal(shape)


def load_lm_train_reference(path=None) -> dict:
    """name -> :class:`LMTrainRecord` (names: "yi", "rwkv")."""
    import json

    with np.load(LM_TRAIN_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    out = {}
    for name in (str(n) for n in z["names"]):
        desc = json.loads(str(z[f"{name}_config"]))
        cfg = dataclasses.replace(
            get_config(desc["arch"], smoke=desc["smoke"]),
            param_dtype=torch.float32, **desc["overrides"])
        out[name] = LMTrainRecord(
            cfg=cfg, seed=int(z["seed"]), data=desc["data"],
            steps=int(desc["steps"]), opt=desc["opt"],
            leaf_names=list(desc["leaves"]),
            sensitivity=desc["sensitivity"], **{
                f: z[f"{name}_{f}"] for f in (
                    "loss", "ce", "grad_norm", "lr", "g_sq", "g_probe")})
    return out


def load_lm_moe_train_reference(path=None) -> LMTrainRecord:
    """The JAX MoE training record (``assets/lm_moe_train_reference.npz``:
    mixtral's smoke config in float32 at the flash kernel's d_head of 128,
    capacity factor 1.25), with each step's aux loss and drops."""
    import json

    with np.load(LM_MOE_TRAIN_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    desc = json.loads(str(z["config"]))
    cfg = dataclasses.replace(
        get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **record_overrides(desc))
    return LMTrainRecord(
        cfg=cfg, seed=int(z["seed"]), data=desc["data"],
        steps=int(desc["steps"]), opt=desc["opt"],
        leaf_names=list(desc["leaves"]), sensitivity=desc["sensitivity"],
        **{f: z[f] for f in ("loss", "ce", "grad_norm", "lr", "g_sq",
                             "g_probe", "aux", "drops")})


def load_lm_mla_train_reference(path=None) -> LMTrainRecord:
    """:func:`load_lm_moe_train_reference` of the JAX MLA training record
    (``assets/lm_mla_train_reference.npz``: deepseek's smoke config in
    float32 at the flash kernels' MLA widths, 192 / 128, capacity factor
    1.25)."""
    return load_lm_moe_train_reference(LM_MLA_TRAIN_ASSET if path is None
                                       else path)


def load_lm_hybrid_train_reference(path=None) -> LMTrainRecord:
    """:func:`load_lm_moe_train_reference` of the JAX hybrid training
    record (``assets/lm_hybrid_train_reference.npz``: jamba's smoke config
    in float32 with attention at the flash kernels' (128, 128), d_state
    16, capacity factor 1.25)."""
    return load_lm_moe_train_reference(LM_HYBRID_TRAIN_ASSET if path is None
                                       else path)


@dataclasses.dataclass(frozen=True)
class LMCompressedTrainRecord:
    """The JAX compressed train step (int8 + error-feedback exchange over
    the pod axis) on one reduced float32 config with ``numpy_lm_params(cfg,
    seed)`` weights, at each pod count of ``runs``: per step the loss, ce,
    global gradient norm, learning rate and, after the step, the norm of
    all error-feedback residuals ("res_norm") and of each leaf's
    ("res_leaf", (steps, leaves), leaves as ``leaf_names``: JAX paths
    joined by "/"); ``sensitivity`` holds each quantity's one-ulp E a step
    ("res_leaf": a step and leaf), per pod count."""

    cfg: object
    seed: int
    data: dict                    # DataConfig fields
    steps: int
    opt: dict                     # AdamWConfig fields
    leaf_names: list
    runs: dict                    # pods -> quantity -> array
    sensitivity: dict             # pods -> quantity -> array


def load_lm_compressed_train_reference(path=None) -> LMCompressedTrainRecord:
    """The JAX compressed-training record
    (``assets/lm_compressed_train_reference.npz``: yi-9b's smoke config in
    float32 at the flash kernels' d_head of 64, at 1 and 2 pods)."""
    import json

    with np.load(LM_COMPRESSED_TRAIN_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    desc = json.loads(str(z["config"]))
    cfg = dataclasses.replace(
        get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **record_overrides(desc))
    runs, sens = {}, {}
    for npods in (int(p) for p in z["pods"]):
        runs[npods] = {k: z[f"pods{npods}_{k}"] for k in (
            "loss", "ce", "grad_norm", "lr", "res_norm", "res_leaf")}
        sens[npods] = {k: np.asarray(v) for k, v in
                       desc["sensitivity"][str(npods)].items()}
        sens[npods]["res_leaf"] = z[f"pods{npods}_e_res_leaf"]
    return LMCompressedTrainRecord(
        cfg=cfg, seed=int(z["seed"]), data=desc["data"],
        steps=int(desc["steps"]), opt=desc["opt"],
        leaf_names=list(desc["leaves"]), runs=runs, sensitivity=sens)


def encdec_record_frames(desc: dict) -> np.ndarray:
    """The frames of the encoder-decoder record: standard normals from
    numpy's generator seeded with ``desc["frame_seed"]``, float32, one
    (enc_seq, d_model) block a prompt."""
    o = desc["overrides"]
    return np.random.default_rng(desc["frame_seed"]).standard_normal(
        (desc["n_prompts"], o["enc_seq"], o["d_model"]), np.float32)


def load_lm_encdec_reference(path=None):
    """(:class:`LMRecord`, :class:`LMTrainRecord`) of the reduced float32
    whisper: the serving record with its frames, and one training step on
    ``encdec_batch_for_step`` batches (one entry a step; the gradient
    probes of every leaf, ``enc_stack`` and ``cross`` included)."""
    import json

    with np.load(LM_ENCDEC_ASSET if path is None else path) as z:
        z = {k: z[k] for k in z.files}
    desc = json.loads(str(z["config"]))
    cfg = dataclasses.replace(
        get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **desc["overrides"])
    seed = int(z["seed"])
    serve = LMRecord(cfg=cfg, seed=seed,
                     sensitivity=float(z["sensitivity"]),
                     frames=encdec_record_frames(desc), **{
                         f: z[f] for f in (
                             "prompts", "teacher", "prefill_logits",
                             "decode_logits", "greedy", "greedy_gap",
                             "greedy_max")})
    train = LMTrainRecord(
        cfg=cfg, seed=seed, data=desc["data"], steps=int(desc["steps"]),
        opt=desc["opt"], leaf_names=list(desc["leaves"]),
        sensitivity=desc["train_sensitivity"], **{
            f: z[f] for f in ("loss", "ce", "grad_norm", "lr", "g_sq",
                              "g_probe")})
    return serve, train
