"""Seeded synthetic workloads for the two camera case studies.

The port's own copy of the JAX package's ``camera/synthetic.py``, which is
numpy only: same generators, same seeds, array-equal output (held by
tests/test_torch_synthetic.py).  Frames and datasets are numpy arrays;
callers move them to a device.

* :func:`face_patch` / :func:`face_dataset` — parametric 20x20 "faces"
  and clutter for the 400-8-1 face-auth NN and the Haar cascade;
* :func:`security_video` — 176x144 @1 FPS scenes with walkers and faces,
  the §III funnel's workload;
* :func:`stereo_pair` — the VR rig stand-in with ground-truth disparity.
"""

from __future__ import annotations

import numpy as np


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Faces
# ---------------------------------------------------------------------------


def face_patch(rng, identity_vec, size: int = 20, jitter: float = 1.0,
               light: float = 0.0) -> np.ndarray:
    """Render one face-ish patch in [0,1].  identity_vec: (8,) in [-1,1]."""
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    iv = identity_vec

    def blob(cy, cx, sy, sx, amp):
        return amp * np.exp(-(((y - cy) / sy) ** 2 + ((x - cx) / sx) ** 2))

    jy, jx = rng.normal(0, jitter / size, 2)
    face = np.zeros((size, size))
    # head disc
    face += blob(0.5 + jy, 0.5 + jx, 0.42 + 0.05 * iv[0], 0.34 + 0.05 * iv[1], 0.8)
    # eyes (dark)
    eye_dy = 0.36 + 0.04 * iv[2]
    eye_dx = 0.20 + 0.03 * iv[3]
    face -= blob(eye_dy + jy, 0.5 - eye_dx + jx, 0.06, 0.07 + 0.02 * iv[4], 0.55)
    face -= blob(eye_dy + jy, 0.5 + eye_dx + jx, 0.06, 0.07 + 0.02 * iv[4], 0.55)
    # nose ridge (light)
    face += blob(0.55 + jy, 0.5 + jx, 0.16 + 0.03 * iv[5], 0.05, 0.25)
    # mouth (dark)
    face -= blob(0.76 + 0.03 * iv[6] + jy, 0.5 + jx, 0.05, 0.16 + 0.04 * iv[7], 0.45)
    face = face + light + rng.normal(0, 0.04, face.shape)
    return np.clip(face + 0.1, 0, 1)


def nonface_patch(rng, size: int = 20) -> np.ndarray:
    """Clutter with face-like first/second moments but no face geometry."""
    kind = rng.integers(0, 3)
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    if kind == 0:   # oriented stripes
        th = rng.uniform(0, np.pi)
        f = rng.uniform(2, 6)
        img = 0.5 + 0.3 * np.sin(2 * np.pi * f * (x * np.cos(th) + y * np.sin(th)))
    elif kind == 1:  # random blobs
        img = np.zeros((size, size))
        for _ in range(rng.integers(2, 6)):
            cy, cx = rng.uniform(0.1, 0.9, 2)
            s = rng.uniform(0.05, 0.3)
            img += rng.uniform(-0.5, 0.7) * np.exp(-(((y - cy) / s) ** 2 + ((x - cx) / s) ** 2))
        img = 0.5 + img
    else:            # smooth gradient
        g = rng.uniform(-0.5, 0.5, 2)
        img = 0.5 + g[0] * (x - 0.5) + g[1] * (y - 0.5)
    img = img + rng.normal(0, 0.05, img.shape)
    return np.clip(img, 0, 1)


def face_dataset(n_per_class: int = 600, n_identities: int = 24, size: int = 20,
                 target_identity: int = 0, seed: int = 0):
    """Face-authentication dataset: positives = target identity, negatives =
    other identities + clutter (the paper's FA task: match one reference).

    Returns (X (n, size*size) f32, y (n,) {0,1}, meta dict)."""
    rng = _rng(seed)
    ids = rng.uniform(-1, 1, (n_identities, 8))
    X, y = [], []
    for _ in range(n_per_class):
        X.append(face_patch(rng, ids[target_identity],
                            size=size,
                            jitter=rng.uniform(0.5, 1.6),
                            light=rng.uniform(-0.15, 0.15)))
        y.append(1)
    n_other = n_per_class // 2
    for _ in range(n_other):
        other = rng.integers(1, n_identities)
        X.append(face_patch(rng, ids[other], size=size,
                            jitter=rng.uniform(0.5, 1.6),
                            light=rng.uniform(-0.15, 0.15)))
        y.append(0)
    for _ in range(n_per_class - n_other):
        X.append(nonface_patch(rng, size=size))
        y.append(0)
    X = np.stack(X).reshape(len(X), -1).astype(np.float32)
    y = np.array(y, np.int32)
    perm = rng.permutation(len(X))
    return X[perm], y[perm], {"identities": ids, "target": target_identity}


# ---------------------------------------------------------------------------
# Security video (WISPCam workload, 176x144 @ 1 FPS)
# ---------------------------------------------------------------------------


def security_video(n_frames: int = 62, h: int = 144, w: int = 176,
                   motion_frames: int = 12, faces_in_motion: float = 0.66,
                   seed: int = 1):
    """Paper §III-D workload statistics: 62 frames, 12 pass motion detection,
    VJ then passes ~40 windows of which ~10% are false positives.

    Returns (frames (n, h, w) f32, truth dicts per frame)."""
    rng = _rng(seed)
    # frame 0 is always the static reference, so at most n_frames - 1 frames
    # can carry motion; clamp instead of letting rng.choice raise.
    motion_frames = max(0, min(motion_frames, n_frames - 1))
    yb, xb = np.mgrid[0:h, 0:w]
    background = (
        0.45
        + 0.1 * np.sin(xb / 17.0)
        + 0.08 * np.cos(yb / 23.0)
        + 0.05 * rng.standard_normal((h, w))
    )
    # a static "poster" face in the scene (the paper's FP source)
    poster = face_patch(rng, rng.uniform(-1, 1, 8), size=20)
    background[20:40, 140:160] = 0.7 * poster + 0.3 * background[20:40, 140:160]
    background = np.clip(background, 0, 1)

    ids = rng.uniform(-1, 1, (4, 8))
    frames = []
    truth = []
    move_set = set(rng.choice(np.arange(1, n_frames), motion_frames, replace=False))
    for t in range(n_frames):
        f = background.copy()
        info = {"moving": t in move_set, "faces": []}
        if t in move_set:
            # a walker: vertical bar + optional face at head
            px = int(rng.uniform(10, w - 30))
            py = int(rng.uniform(30, h - 60))
            f[py:py + 46, px:px + 14] *= 0.55
            if rng.uniform() < faces_in_motion:
                fp = face_patch(rng, ids[rng.integers(0, len(ids))], size=20,
                                jitter=rng.uniform(0.5, 1.2))
                f[py - 20:py, px - 3:px + 17] = fp
                info["faces"].append((py - 20, px - 3, 20))
        f = np.clip(f + rng.normal(0, 0.01, f.shape), 0, 1)
        frames.append(f.astype(np.float32))
        truth.append(info)
    return np.stack(frames), truth


# ---------------------------------------------------------------------------
# Stereo pairs (VR rig)
# ---------------------------------------------------------------------------


def stereo_pair(h: int = 256, w: int = 320, max_disp: int = 12, seed: int = 2):
    """A textured scene + piecewise-smooth disparity; right view = left
    shifted per-pixel by the disparity (with occlusion fill).

    Returns (left, right, disparity) float32 in [0,1] / pixels."""
    rng = _rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    # texture: multi-scale noise
    tex = np.zeros((h, w))
    for s_ in (4, 8, 16, 32):
        n = rng.standard_normal((h // s_ + 2, w // s_ + 2))
        up = np.kron(n, np.ones((s_, s_)))[:h, :w]
        tex += up / np.sqrt(s_)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)

    # disparity: background plane + 2 foreground boxes (depth edges)
    disp = 2.0 + 2.0 * (y / h)
    for _ in range(2):
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        hh, ww = rng.integers(h // 8, h // 4), rng.integers(w // 8, w // 4)
        d = rng.uniform(max_disp * 0.6, max_disp)
        disp[max(cy - hh, 0):cy + hh, max(cx - ww, 0):cx + ww] = d
    left = tex
    right = np.zeros_like(left)
    xs = np.clip(x - disp.astype(int), 0, w - 1)
    right = left[y, xs]
    return left.astype(np.float32), right.astype(np.float32), disp.astype(np.float32)
