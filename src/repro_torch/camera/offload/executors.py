"""Cut-point split executors: node half, wire payload, cloud half (the
port of the JAX package's ``FaceAuthOffloadExecutor`` and
``VROffloadExecutor``).

:class:`FaceAuthOffloadExecutor` splits the funnel at any of its four
block boundaries.  Both halves compose the same stage functions the fused
:class:`~repro_torch.camera.pipelines.FaceAuthExecutor` runs
(``FunnelStages``), so the split can never drift from the on-node math.
The port's stages close over their constants and take a leading stream
axis; the split executor runs one stream (S = 1) and its payload tensors
carry no stream axis, as the reference's do.

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


class _Codec:
    """Static codec configuration of one split executor."""

    def __init__(self, bits, block):
        if bits not in (None, 4, 8, 16):
            raise ValueError(f"codec bits must be None/4/8/16, got {bits}")
        self.bits = bits
        self.block = int(block)

    def enc(self, arrays: dict, name: str, x: torch.Tensor):
        """Pack field ``x`` into ``arrays``."""
        if self.bits is None:
            arrays[name] = x.to(torch.float32)
            return
        packed, scales = wire_encode(x, bits=self.bits, block=self.block)
        arrays[name] = packed
        arrays[name + "_scales"] = scales

    def dec(self, arrays: dict, name: str, shape) -> torch.Tensor:
        """Unpack field ``name`` back to f32 of ``shape``."""
        if self.bits is None:
            return arrays[name].reshape(shape)
        return wire_decode(arrays[name], arrays[name + "_scales"],
                           tuple(shape), bits=self.bits, block=self.block)

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

    def node_stages(self) -> tuple:
        """``(name, fn)`` of each funnel stage the node half runs at this
        cut, in order; ``fn(state)`` returns the entries it adds to the
        state, every tensor without the stream axis."""
        st, cut = self._st, self.cut

        def motion(s):
            mframes, fidx, fvalid, motion, mdrop = st.motion(
                s["frames"][None])
            return dict(mframes=mframes[0], fidx=fidx[0], fvalid=fvalid[0],
                        motion=motion[0], motion_dropped=mdrop[0])

        def detect(s):
            dmask, n_win, casc_drop = st.detect(s["mframes"][None],
                                                s["fvalid"][None])
            return dict(dmask=dmask[0], n_win=n_win[0],
                        casc_drop=casc_drop[0])

        def gather(s):
            patches, wsel, wvalid, wdrop = st.gather(
                s["mframes"][None], s["dmask"][None], s["n_win"][None])
            return dict(patches=patches[0], wsel=wsel[0], wvalid=wvalid[0],
                        win_dropped=wdrop[0])

        def nn(s):
            scores, auth, n_auth = st.nn(s["patches"][None],
                                         s["wvalid"][None])
            return dict(scores=scores[0], auth=auth[0], n_auth=n_auth[0])

        stages = (("motion", motion), ("detect", detect),
                  ("gather", gather), ("nn", nn))
        return stages[:{"sensor": 0, "motion": 1, "vj": 3, "nn": 4}[cut]]

    def encode_state(self, s: dict):
        """The node state after :meth:`node_stages` -> (arrays, wire_b,
        meta): the cut's wire payload, its measured bytes and its decode
        contract."""
        cdc, cut = self.codec, self.cut
        frames = s["frames"]
        B = frames.shape[0]
        h, w = self._h, self._w
        meta = {"frames_shape": tuple(frames.shape)}
        arrays: dict = {}
        if cut == "sensor":
            cdc.enc(arrays, "frames", frames)
            wire_b = torch.tensor(cdc.static_bytes(B * h * w),
                                  dtype=torch.float32, device=frames.device)
            return arrays, wire_b, meta

        n_valid_f = s["fvalid"].sum().to(torch.float32)
        side = _I32_B * n_valid_f + _BOOL_B * B + _I32_B  # fidx+motion+drop
        if cut == "motion":
            # zero the capacity-padding frames (fidx padding points at real
            # non-motion frames): a zero quantizes to zero exactly, so
            # padding cannot perturb the codec's block scales; the cloud
            # half masks everything by fvalid, so results are unchanged
            cdc.enc(arrays, "mframes",
                    torch.where(s["fvalid"][:, None, None], s["mframes"],
                                0.0))
            arrays.update(fidx=s["fidx"].to(torch.int32), motion=s["motion"],
                          motion_dropped=s["motion_dropped"])
            wire_b = cdc.dyn_bytes(n_valid_f * (h * w)) + side
            return arrays, wire_b, meta

        wvalid, patches = s["wvalid"], s["patches"]
        n_valid_w = wvalid.sum().to(torch.float32)
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
            cdc.enc(arrays, "patches",
                    torch.where(wvalid[:, :, None, None], patches, 0.0))
            arrays.update(common)
            wire_b = (cdc.dyn_bytes(n_valid_w * patches.shape[-1]
                                    * patches.shape[-2])
                      + _I32_B * n_valid_w + side)
            return arrays, wire_b, meta

        cdc.enc(arrays, "scores", s["scores"])
        arrays.update(common, auth=s["auth"])
        wire_b = (cdc.dyn_bytes(n_valid_w) + _BOOL_B * n_valid_w
                  + _I32_B * n_valid_w + side)
        return arrays, wire_b, meta

    # -- cloud side ----------------------------------------------------------

    def _cloud_fn(self, arrays: dict, frames_shape) -> dict:
        st, cdc = self._st, self.codec
        cut = self.cut
        h, w = self._h, self._w
        W = st.window_capacity
        if cut == "sensor":
            frames = cdc.dec(arrays, "frames", frames_shape)
            mframes, fidx, fvalid, motion, motion_dropped = st.motion(
                frames[None])
        else:
            fidx = arrays["fidx"].long()[None]
            motion = arrays["motion"][None]
            motion_dropped = arrays["motion_dropped"][None]
            fvalid = motion[:, fidx[0]]
        B = motion.shape[1]
        M = fidx.shape[1]

        if cut in ("sensor", "motion"):
            if cut == "motion":
                mframes = cdc.dec(arrays, "mframes", (M, h, w))[None]
            dmask, n_win_m, casc_drop_m = st.detect(mframes, fvalid)
            patches, wsel, wvalid, win_dropped_m = st.gather(
                mframes, dmask, n_win_m)
        else:
            wsel = arrays["wsel"][None]
            n_win_m = arrays["n_win"][None]
            win_dropped_m = arrays["win_dropped"][None]
            casc_drop_m = arrays["casc_drop"][None]
            wvalid = (torch.arange(W, dtype=torch.int32,
                                   device=wsel.device)[None, None, :]
                      < n_win_m.clamp(max=W)[..., None])

        if cut == "nn":
            s = torch.where(wvalid, cdc.dec(arrays, "scores", (M, W))[None],
                            0.0)
            auth = arrays["auth"][None]
            n_auth_m = auth.sum(dim=-1).to(torch.int32)
        else:
            if cut == "vj":
                patches = cdc.dec(arrays, "patches", (M, W, 20, 20))[None]
            s, auth, n_auth_m = st.nn(patches, wvalid)

        return st.scatter(B, fidx, motion, motion_dropped, n_win_m,
                          casc_drop_m, wsel, wvalid, win_dropped_m, s, auth,
                          n_auth_m)

    # -- execution -----------------------------------------------------------

    def encode(self, frames) -> WirePayload:
        """Node half: (B, h, w) frames -> wire payload."""
        return _run_node(self, self.node_inputs(frames))

    def decode_run(self, payload: WirePayload):
        """Cloud half: wire payload -> FAExecResult."""
        out = self._cloud_fn(payload.arrays, payload.meta["frames_shape"])
        return FAExecResult(**{k: v[0] for k, v in out.items()})

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
