"""Cut-point split executors: node half, wire payload, cloud half (the
port of the JAX package's ``FaceAuthOffloadExecutor`` and
``VROffloadExecutor``).

:class:`FaceAuthOffloadExecutor` splits the funnel at any of its four
block boundaries.  Both halves compose the same stage functions the fused
:class:`~repro_torch.camera.pipelines.FaceAuthExecutor` runs
(``FunnelStages``), so the split can never drift from the on-node math.
The port's stages close over their constants and take a leading stream
axis.  Both halves run on a leading slot axis (:meth:`encode_slots`,
:meth:`decode_slots`: the serving runtime's micro-batch, where the
reference vmaps ``_node_fn`` / ``_cloud_fn``); every codec field is
encoded slot by slot, each slot's values padded to whole blocks of its
own, so a slot's packed bytes, scales and wire bytes are those of the
same frames sent alone.  ``encode`` / ``decode_run`` are the one-stream
case, whose payload tensors carry no slot axis, as the reference's do.

The wire payload between the halves is typed (``payloads.WirePayload``)
and optionally compressed by the wire codec (``kernels/wire_codec``: the
CUDA kernels on the card) at 16/8/4 bits; ``bits=None`` ships the raw f32
runtime representation, the uncompressed baseline.  Measured wire bytes
are computed on the device for valid payload elements only, with the
reference's float32 arithmetic step for step.

:class:`VROffloadExecutor` splits the §IV rig pipeline (raw views /
depth maps / panorama) around :class:`~repro_torch.camera.pipelines.VRRigExecutor`'s
per-rig depth and stitch functions.

Cut payload contracts (DESIGN.md §10):

  face_auth
    sensor  frames (B,h,w)            [codec]
    motion  mframes (M,h,w)           [codec] + fidx/motion/drop sideband
    vj      patches (M,W,20,20)       [codec] + wsel/counts sideband
    nn      scores (M,W)              [codec] + auth bits + counts sideband
  vr_video
    capture lefts,rights (P,h,w)      [codec]
    depth   depths (P,h,w) + views    [codec]  (stitch needs full-res views,
                                      so the mid cut ships more than raw)
    stitch  left/right panoramas      [codec]
"""

from __future__ import annotations

import math

import torch

from repro_torch.camera.offload.payloads import (
    SESSION_SIDEBAND_NAMES,
    PayloadSchema,
    WirePayload,
)
from repro_torch.camera.pipelines import FAExecResult
from repro_torch.kernels.wire_codec.ops import (
    wire_bytes,
    wire_bytes_dynamic,
    wire_decode,
    wire_encode,
)

_I32_B = 4.0          # index / count sideband bytes per valid entry
_BOOL_B = 1.0 / 8.0   # booleans ship bit-packed


def _run_node(ex, state: dict) -> WirePayload:
    """A split executor's node half: its stages in order over ``state``,
    then its encode."""
    for _name, fn in ex.node_stages():
        state.update(fn(state))
    arrays, wire_b, meta = ex.encode_state(state)
    return WirePayload(cut=ex.cut, bits=ex.bits, arrays=arrays, meta=meta,
                       wire_b=wire_b)


def _strip(d: dict) -> dict:
    """A one-slot dict without its slot axis."""
    return {k: v[0] for k, v in d.items()}


def _one_slot(d: dict) -> dict:
    """A dict of one stream's tensors with a slot axis of 1."""
    return {k: v[None] for k, v in d.items()}


class _Codec:
    """Static codec configuration of one split executor."""

    def __init__(self, bits, block):
        if bits not in (None, 4, 8, 16):
            raise ValueError(f"codec bits must be None/4/8/16, got {bits}")
        self.bits = bits
        self.block = int(block)

    def enc(self, arrays: dict, name: str, x: torch.Tensor):
        """Pack one stream's field ``x`` into ``arrays``."""
        slots: dict = {}
        self.enc_slots(slots, name, x[None])
        arrays.update(_strip(slots))

    def dec(self, arrays: dict, name: str, shape) -> torch.Tensor:
        """Unpack one stream's field ``name`` back to f32 of ``shape``."""
        keys = [k for k in (name, name + "_scales") if k in arrays]
        return self.dec_slots(_one_slot({k: arrays[k] for k in keys}),
                              name, shape)[0]

    def enc_slots(self, arrays: dict, name: str, x: torch.Tensor):
        """Pack field ``x`` (S, ...) into ``arrays``, slot by slot: each
        slot's values are zero-padded to whole blocks of its own, so no
        block holds two slots' values (packed (S, n_blocks, bytes),
        scales (S, n_blocks, 1))."""
        if self.bits is None:
            arrays[name] = x.to(torch.float32)
            return
        S = x.shape[0]
        flat = x.reshape(S, -1).to(torch.float32)
        pad = (-flat.shape[1]) % self.block
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        packed, scales = wire_encode(flat.reshape(-1, self.block),
                                     bits=self.bits, block=self.block)
        arrays[name] = packed.reshape(S, -1, packed.shape[-1])
        arrays[name + "_scales"] = scales.reshape(S, -1, 1)

    def dec_slots(self, arrays: dict, name: str, shape) -> torch.Tensor:
        """Unpack field ``name`` back to f32 of (S,) + ``shape``."""
        if self.bits is None:
            return arrays[name].reshape((-1,) + tuple(shape))
        packed, scales = arrays[name], arrays[name + "_scales"]
        S, nb = packed.shape[:2]
        x = wire_decode(packed.reshape(S * nb, -1),
                        scales.reshape(S * nb, 1), (S, nb * self.block),
                        bits=self.bits, block=self.block)
        return x[:, :math.prod(shape)].reshape((S,) + tuple(shape))

    def dyn_bytes(self, n_values: torch.Tensor) -> torch.Tensor:
        return wire_bytes_dynamic(n_values, self.bits, block=self.block)

    def static_bytes(self, n_values: int) -> float:
        return wire_bytes(n_values, self.bits, block=self.block)


class FaceAuthOffloadExecutor:
    """Split §III funnel: node-side prefix, wire payload, cloud-side suffix.

    Construct *after* ``base.calibrate(...)`` — the split reads the base
    executor's stage functions and capacities.  ``encode`` is the node
    half, ``decode_run`` the cloud half; ``__call__`` runs both and
    returns ``(FAExecResult, WirePayload)``.  With ``bits=None`` the result
    is equal to the fused executor's at every cut, field for field.
    """

    CUTS = ("sensor", "motion", "vj", "nn")

    PAYLOAD_SCHEMA = {
        "sensor": PayloadSchema(codec=("frames",),
                                session=SESSION_SIDEBAND_NAMES),
        "motion": PayloadSchema(codec=("mframes",),
                                i32=("fidx", "motion_dropped"),
                                bools=("motion",),
                                session=SESSION_SIDEBAND_NAMES),
        "vj": PayloadSchema(codec=("patches",),
                            i32=("wsel", "n_win", "win_dropped", "casc_drop",
                                 "fidx", "motion_dropped"),
                            bools=("motion",),
                            session=SESSION_SIDEBAND_NAMES),
        "nn": PayloadSchema(codec=("scores",),
                            i32=("wsel", "n_win", "win_dropped", "casc_drop",
                                 "fidx", "motion_dropped"),
                            bools=("motion", "auth"),
                            session=SESSION_SIDEBAND_NAMES),
    }

    def __init__(self, base, cut: str, *, bits: int | None = None,
                 block: int = 256):
        if cut not in self.CUTS:
            raise ValueError(f"cut {cut!r} not in {self.CUTS}")
        self.base = base
        self.cut = cut
        self.codec = _Codec(bits, block)
        self.bits = self.codec.bits
        self._st = base.stages
        self._h, self._w = base.det.grid.h, base.det.grid.w

    # -- node side -----------------------------------------------------------

    def node_inputs(self, frames) -> dict:
        """The node half's state at capture: ``{"frames": (B, h, w)}``."""
        return {"frames": self.base._frames(frames)}

    def slot_stages(self) -> tuple:
        """``(name, fn)`` of each funnel stage the node half runs at this
        cut, in order; ``fn(state)`` returns the entries it adds to the
        state, every tensor with a leading slot axis."""
        st, cut = self._st, self.cut

        def motion(s):
            mframes, fidx, fvalid, motion, mdrop = st.motion(s["frames"])
            return dict(mframes=mframes, fidx=fidx, fvalid=fvalid,
                        motion=motion, motion_dropped=mdrop)

        def detect(s):
            dmask, n_win, casc_drop = st.detect(s["mframes"], s["fvalid"])
            return dict(dmask=dmask, n_win=n_win, casc_drop=casc_drop)

        def gather(s):
            patches, wsel, wvalid, wdrop = st.gather(
                s["mframes"], s["dmask"], s["n_win"])
            return dict(patches=patches, wsel=wsel, wvalid=wvalid,
                        win_dropped=wdrop)

        def nn(s):
            scores, auth, n_auth = st.nn(s["patches"], s["wvalid"])
            return dict(scores=scores, auth=auth, n_auth=n_auth)

        stages = (("motion", motion), ("detect", detect),
                  ("gather", gather), ("nn", nn))
        return stages[:{"sensor": 0, "motion": 1, "vj": 3, "nn": 4}[cut]]

    def node_stages(self) -> tuple:
        """:meth:`slot_stages` for one stream: every tensor of the state
        without the slot axis."""
        def one(fn):
            return lambda s: _strip(fn(_one_slot(s)))

        return tuple((name, one(fn)) for name, fn in self.slot_stages())

    def encode_state(self, s: dict):
        """One stream's node state after :meth:`node_stages` -> (arrays,
        wire_b, meta): the cut's wire payload, its measured bytes and its
        decode contract."""
        arrays, wire_b = self.encode_slot_state(_one_slot(s))
        return (_strip(arrays), wire_b[0],
                {"frames_shape": tuple(s["frames"].shape)})

    def encode_slot_state(self, s: dict):
        """The node state after :meth:`slot_stages` -> (arrays, wire_b):
        the cut's wire payload with a leading slot axis and each slot's
        measured bytes, (S,) float32."""
        cdc, cut = self.codec, self.cut
        frames = s["frames"]
        S, B = frames.shape[:2]
        h, w = self._h, self._w
        arrays: dict = {}
        if cut == "sensor":
            cdc.enc_slots(arrays, "frames", frames)
            wire_b = torch.full((S,), cdc.static_bytes(B * h * w),
                                dtype=torch.float32, device=frames.device)
            return arrays, wire_b

        n_valid_f = s["fvalid"].sum(dim=1).to(torch.float32)
        side = _I32_B * n_valid_f + _BOOL_B * B + _I32_B  # fidx+motion+drop
        if cut == "motion":
            # zero the capacity-padding frames (fidx padding points at real
            # non-motion frames): a zero quantizes to zero exactly, so
            # padding cannot perturb the codec's block scales; the cloud
            # half masks everything by fvalid, so results are unchanged
            cdc.enc_slots(arrays, "mframes",
                          torch.where(s["fvalid"][..., None, None],
                                      s["mframes"], 0.0))
            arrays.update(fidx=s["fidx"].to(torch.int32), motion=s["motion"],
                          motion_dropped=s["motion_dropped"])
            wire_b = cdc.dyn_bytes(n_valid_f * (h * w)) + side
            return arrays, wire_b

        wvalid, patches = s["wvalid"], s["patches"]
        n_valid_w = wvalid.sum(dim=(1, 2)).to(torch.float32)
        # per processed valid frame: n_win + win_dropped + casc_drop counts
        side = side + _I32_B * 3 * n_valid_f
        common = dict(wsel=s["wsel"].to(torch.int32), n_win=s["n_win"],
                      win_dropped=s["win_dropped"],
                      casc_drop=s["casc_drop"],
                      fidx=s["fidx"].to(torch.int32), motion=s["motion"],
                      motion_dropped=s["motion_dropped"])
        if cut == "vj":
            # zero padding windows (wsel defaults to position 0) — the same
            # scale isolation as the motion cut above
            cdc.enc_slots(arrays, "patches",
                          torch.where(wvalid[..., None, None], patches, 0.0))
            arrays.update(common)
            wire_b = (cdc.dyn_bytes(n_valid_w * patches.shape[-1]
                                    * patches.shape[-2])
                      + _I32_B * n_valid_w + side)
            return arrays, wire_b

        cdc.enc_slots(arrays, "scores", s["scores"])
        arrays.update(common, auth=s["auth"])
        wire_b = (cdc.dyn_bytes(n_valid_w) + _BOOL_B * n_valid_w
                  + _I32_B * n_valid_w + side)
        return arrays, wire_b

    # -- cloud side ----------------------------------------------------------

    def decode_slots(self, arrays: dict, frames_shape) -> dict:
        """Cloud half over a slot axis: payload arrays with a leading slot
        axis and one slot's ``(B, h, w)`` -> result dict with a leading
        slot axis."""
        st, cdc = self._st, self.codec
        cut = self.cut
        h, w = self._h, self._w
        W = st.window_capacity
        if cut == "sensor":
            frames = cdc.dec_slots(arrays, "frames", frames_shape)
            mframes, fidx, fvalid, motion, motion_dropped = st.motion(frames)
        else:
            fidx = arrays["fidx"].long()
            motion = arrays["motion"]
            motion_dropped = arrays["motion_dropped"]
            fvalid = torch.gather(motion, 1, fidx)
        B = motion.shape[1]
        M = fidx.shape[1]

        if cut in ("sensor", "motion"):
            if cut == "motion":
                mframes = cdc.dec_slots(arrays, "mframes", (M, h, w))
            dmask, n_win_m, casc_drop_m = st.detect(mframes, fvalid)
            patches, wsel, wvalid, win_dropped_m = st.gather(
                mframes, dmask, n_win_m)
        else:
            wsel = arrays["wsel"]
            n_win_m = arrays["n_win"]
            win_dropped_m = arrays["win_dropped"]
            casc_drop_m = arrays["casc_drop"]
            wvalid = (torch.arange(W, dtype=torch.int32,
                                   device=wsel.device)[None, None, :]
                      < n_win_m.clamp(max=W)[..., None])

        if cut == "nn":
            s = torch.where(wvalid, cdc.dec_slots(arrays, "scores", (M, W)),
                            0.0)
            auth = arrays["auth"]
            n_auth_m = auth.sum(dim=-1).to(torch.int32)
        else:
            if cut == "vj":
                patches = cdc.dec_slots(arrays, "patches", (M, W, 20, 20))
            s, auth, n_auth_m = st.nn(patches, wvalid)

        return st.scatter(B, fidx, motion, motion_dropped, n_win_m,
                          casc_drop_m, wsel, wvalid, win_dropped_m, s, auth,
                          n_auth_m)

    def encode_slots(self, frames: torch.Tensor):
        """Node half over a slot axis: (S, B, h, w) frames on the base
        executor's device -> (arrays, wire_b (S,))."""
        state = {"frames": frames}
        for _name, fn in self.slot_stages():
            state.update(fn(state))
        return self.encode_slot_state(state)

    # -- execution -----------------------------------------------------------

    def encode(self, frames) -> WirePayload:
        """Node half: (B, h, w) frames -> wire payload."""
        return _run_node(self, self.node_inputs(frames))

    def decode_run(self, payload: WirePayload):
        """Cloud half: wire payload -> FAExecResult."""
        out = self.decode_slots(_one_slot(payload.arrays),
                                payload.meta["frames_shape"])
        return FAExecResult(**_strip(out))

    def __call__(self, frames):
        payload = self.encode(frames)
        return self.decode_run(payload), payload


# ---------------------------------------------------------------------------
# §IV VR rig
# ---------------------------------------------------------------------------


class VROffloadExecutor:
    """Split §IV rig pipeline around :class:`VRRigExecutor`'s stages.

    ``encode(lefts, rights)`` is the rig-side half, ``decode_run`` the
    cloud side; results are ``(left_pano, right_pano)``.  Depth runs over
    all camera pairs at once inside whichever half owns it, exactly as the
    fused executor runs it, so with ``bits=None`` the panoramas equal the
    fused executor's.  Every payload field is dense, so the wire bytes are
    static: the reference's Python-float sum, as a float32 scalar.
    """

    CUTS = ("capture", "depth", "stitch")

    PAYLOAD_SCHEMA = {
        "capture": PayloadSchema(codec=("lefts", "rights"),
                                 session=SESSION_SIDEBAND_NAMES),
        "depth": PayloadSchema(codec=("depths", "lefts", "rights"),
                               session=SESSION_SIDEBAND_NAMES),
        "stitch": PayloadSchema(codec=("left_pano", "right_pano"),
                                session=SESSION_SIDEBAND_NAMES),
    }

    def __init__(self, base, cut: str, *, bits: int | None = None,
                 block: int = 256):
        if cut not in self.CUTS:
            raise ValueError(f"cut {cut!r} not in {self.CUTS}")
        self.base = base
        self.cut = cut
        self.codec = _Codec(bits, block)
        self.bits = self.codec.bits
        self._depth = base.pair_depth
        self._pano = base.pano_fn

    def node_inputs(self, lefts, rights) -> dict:
        """The rig half's state at capture: ``{"lefts", "rights"}``, (P,
        h, w) each."""
        return {"lefts": self.base._views(lefts),
                "rights": self.base._views(rights)}

    def node_stages(self) -> tuple:
        """``(name, fn)`` of each stage the rig half runs at this cut."""
        def depth(s):
            return dict(depths=self._depth(s["lefts"], s["rights"]))

        def pano(s):
            lp, rp = self._pano(s["lefts"], s["rights"], s["depths"])
            return dict(left_pano=lp, right_pano=rp)

        stages = (("depth", depth), ("pano", pano))
        return stages[:self.CUTS.index(self.cut)]

    def encode_state(self, s: dict):
        """The rig state after :meth:`node_stages` -> (arrays, wire_b,
        meta)."""
        cdc = self.codec
        lefts = s["lefts"]
        n = lefts.numel()
        arrays: dict = {}
        pano_shapes = None
        if self.cut == "capture":
            cdc.enc(arrays, "lefts", lefts)
            cdc.enc(arrays, "rights", s["rights"])
            wire_b = 2 * cdc.static_bytes(n)
        elif self.cut == "depth":
            cdc.enc(arrays, "depths", s["depths"])
            cdc.enc(arrays, "lefts", lefts)
            cdc.enc(arrays, "rights", s["rights"])
            wire_b = 3 * cdc.static_bytes(n)
        else:                                      # stitch: full on-node
            lp, rp = s["left_pano"], s["right_pano"]
            cdc.enc(arrays, "left_pano", lp)
            cdc.enc(arrays, "right_pano", rp)
            wire_b = (cdc.static_bytes(lp.numel())
                      + cdc.static_bytes(rp.numel()))
            pano_shapes = (tuple(lp.shape), tuple(rp.shape))
        meta = {"view_shape": tuple(lefts.shape), "pano_shapes": pano_shapes}
        return arrays, torch.tensor(wire_b, dtype=torch.float32,
                                    device=lefts.device), meta

    def encode(self, lefts, rights) -> WirePayload:
        """Rig half: (P, h, w) views x2 -> wire payload."""
        return _run_node(self, self.node_inputs(lefts, rights))

    def decode_run(self, payload: WirePayload):
        """Cloud half: wire payload -> (left_pano, right_pano)."""
        cdc, arrays = self.codec, payload.arrays
        view_shape = payload.meta["view_shape"]
        if self.cut == "capture":
            lefts = cdc.dec(arrays, "lefts", view_shape)
            rights = cdc.dec(arrays, "rights", view_shape)
            return self._pano(lefts, rights, self._depth(lefts, rights))
        if self.cut == "depth":
            depths = cdc.dec(arrays, "depths", view_shape)
            lefts = cdc.dec(arrays, "lefts", view_shape)
            rights = cdc.dec(arrays, "rights", view_shape)
            return self._pano(lefts, rights, depths)
        left_shape, right_shape = payload.meta["pano_shapes"]
        return (cdc.dec(arrays, "left_pano", left_shape),
                cdc.dec(arrays, "right_pano", right_shape))

    def __call__(self, lefts, rights):
        payload = self.encode(lefts, rights)
        return self.decode_run(payload), payload
