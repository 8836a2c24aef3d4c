"""The traffic generator: hand-like event windows from a seed.

One general generator serves every traffic mix; a mix file
(``traffic/<mix>.json``) sets its parameters. A window is
``events_per_window`` events of a DAVIS346-sized sensor over
``window_ms`` milliseconds, timestamps sorted, in two hand-sized clusters
and a share of uniform noise:

* each hand is drawn at its ground-truth translation through the pinhole
  camera of the configuration (30 degree vertical field of view), kept on
  the sensor, scaled by its depth (clipped to 0.3-0.6 m) and turned by its
  roll: a palm ellipse and five finger ellipses
  spanning about ``hand_size_m`` (width, height) at 0.4 m;
* hand events lie on the parts' outlines with Gaussian jitter, as the
  edges of a moving hand give events; noise events are uniform over the
  sensor;
* labels are 1 (left), 2 (right) and 3 (noise); polarity is 0 or 1;
* each window's ground truth is seeded MANO parameters on the scale of
  the Ev2Hands-S stand-in (roll, pose, shape and translation spreads of
  ``pose_scale``, hands at x = -/+ ``hand_x_m``, z = ``hand_z_m``); with
  probability ``one_hand_share`` the left hand is absent, its slot a copy
  of the right one marked invalid, and its events go to the right hand.

Everything is drawn on the host with numpy from ``seed``: the same seed
gives the same windows, whatever the device.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# hand-local parts at 0.4 m, in pixels (x right, y up): centre, semi-axes,
# tilt from vertical in radians; palm first, thumb last
_FINGERS = ((-0.30, 75.0), (-0.10, 85.0), (0.10, 80.0), (0.30, 65.0))
_PALM = (0.0, -45.0, 42.0, 52.0, 0.0)
_THUMB = (-58.0, -20.0, 9.0, 32.0, 0.9)


def _parts() -> np.ndarray:
    parts = [_PALM]
    for tilt, length in _FINGERS:
        bx, by = 40.0 * math.sin(tilt * 2.0), 0.0
        cx, cy = bx + math.sin(tilt) * length / 2, by + math.cos(tilt) * length / 2
        parts.append((cx, cy, 8.0, length / 2, tilt))
    parts.append(_THUMB)
    return np.array(parts)


def make_windows(seed: int, count: int, mix: Dict, sensor=(346, 260),
                 yfov_deg: float = 30.0) -> Dict[str, np.ndarray]:
    """``count`` windows -> dict of 'x', 'y' (int64 pixels), 't' (int64
    ns, rising across windows), 'p', 'labels' [count, E], and the ground
    truth 'global_orient' [count, 2, 3], 'hand_pose' [count, 2, 45],
    'shape' [count, 2, 10], 'trans' [count, 2, 3], 'valid' [count, 2]
    float32 and 'handedness' [count, 2] int32 (left, right)."""
    rng = np.random.default_rng(seed)
    W, E = count, int(mix["events_per_window"])
    width, height = sensor
    sc = mix["pose_scale"]
    gt = {
        "global_orient": rng.standard_normal((W, 2, 3)) * sc["global_orient"],
        "hand_pose": rng.standard_normal((W, 2, 45)) * sc["hand_pose"],
        "shape": rng.standard_normal((W, 2, 10)) * sc["shape"],
        "trans": rng.standard_normal((W, 2, 3)) * sc["trans"]
        + np.array([[-mix["hand_x_m"], 0.0, mix["hand_z_m"]],
                    [mix["hand_x_m"], 0.0, mix["hand_z_m"]]]),
    }
    gt = {k: v.astype(np.float32) for k, v in gt.items()}
    left_gone = rng.random(W) < mix["one_hand_share"]
    for k in gt:                     # an absent hand copies the present one
        gt[k][left_gone, 0] = gt[k][left_gone, 1]
    valid = np.ones((W, 2), np.float32)
    valid[left_gone, 0] = 0.0
    handedness = valid.astype(np.int32)

    # which hand (0 left, 1 right) or noise each event belongs to
    u = rng.random((W, E), np.float32)
    noise = u < mix["noise_share"]
    side = (u >= mix["noise_share"] + (1 - mix["noise_share"]) / 2).astype(np.int64)
    side[left_gone] = 1
    # a point on one part's outline, in hand-local pixels at 0.4 m
    parts = _parts().astype(np.float32)
    perim = 2 * math.pi * np.sqrt((parts[:, 2] ** 2 + parts[:, 3] ** 2) / 2)
    cum = np.cumsum(perim / perim.sum())
    part = np.minimum(np.searchsorted(cum, rng.random((W, E), np.float32)), len(parts) - 1)
    theta = rng.random((W, E), np.float32) * np.float32(2 * math.pi)
    cx, cy, a, b, tilt = (parts[:, i][part] for i in range(5))
    ex, ey = a * np.cos(theta), b * np.sin(theta)
    ct, st = np.cos(tilt), np.sin(tilt)
    lx = cx + ex * ct + ey * st
    ly = cy - ex * st + ey * ct
    # each hand's pixel centre (kept on the sensor), scale by depth, roll
    focal = (height / 2) / math.tan(math.radians(yfov_deg) / 2)
    tr = gt["trans"]
    z = np.clip(np.abs(tr[..., 2]), 0.3, 0.6)                          # [W, 2]
    scale = (0.4 / z) * (mix["hand_size_m"][1] / 0.18)
    half_w, half_h = 55.0 * scale, 110.0 * scale
    ccx = np.clip(width / 2 + focal * tr[..., 0] / z, half_w, np.maximum(width - half_w, half_w))
    ccy = np.clip(height / 2 - focal * tr[..., 1] / z, half_h, np.maximum(height - half_h, half_h))
    roll = gt["global_orient"][..., 2]
    rows_ = np.arange(W)[:, None]
    sc_e, roll_e = scale[rows_, side].astype(np.float32), roll[rows_, side]
    lx = np.where(side == 0, -lx, lx)                                  # thumbs inwards
    cr, sr = np.cos(roll_e), np.sin(roll_e)
    jit = rng.standard_normal((2, W, E), np.float32) * np.float32(mix["edge_jitter_px"])
    px = ccx[rows_, side] + sc_e * (lx * cr - ly * sr) + jit[0]
    py = ccy[rows_, side] - sc_e * (lx * sr + ly * cr) + jit[1]
    x = np.where(noise, rng.integers(0, width, (W, E)), np.rint(px))
    y = np.where(noise, rng.integers(0, height, (W, E)), np.rint(py))
    x = np.clip(x, 0, width - 1).astype(np.int64)
    y = np.clip(y, 0, height - 1).astype(np.int64)
    labels = np.where(noise, 3, side + 1).astype(np.int32)
    p = (rng.random((W, E), np.float32) < 0.5).astype(np.int64)
    span = int(mix["window_ms"] * 1e6)
    t = np.sort(rng.integers(0, span, (W, E)), axis=1) + span * np.arange(W)[:, None]
    return dict(x=x, y=y, t=t.astype(np.int64), p=p, labels=labels, valid=valid,
                handedness=handedness, **gt)


def raw_events(win: Dict[str, np.ndarray], sl=slice(None)) -> np.ndarray:
    """[n, E, 4] float32 (x, y, t in ns, p) of windows ``sl``, converted as
    a reader converts stored rows (int -> float64 -> float32)."""
    return np.stack([win[k][sl] for k in ("x", "y", "t", "p")], -1).astype(
        np.float64).astype(np.float32)


def batch(win: Dict[str, np.ndarray], sl) -> Dict:
    """The training batch of windows ``sl``: raw events and labels, per
    hand the MANO ground truth and 'valid', and 'handedness'."""
    out = {"events": raw_events(win, sl), "labels": win["labels"][sl]}
    for i, s in enumerate(("left", "right")):
        out[s] = {"global_orient": win["global_orient"][sl, i],
                  "hand_pose": win["hand_pose"][sl, i], "shape": win["shape"][sl, i],
                  "trans": win["trans"][sl, i], "valid": win["valid"][sl, i]}
    out["handedness"] = win["handedness"][sl]
    return out


def rows(win: Dict[str, np.ndarray]):
    """(event rows [W * E, 6] int64 in the Ev2Hands-S layout (x, y, t, p,
    annotation, label), per-window annotations): window w's rows carry
    annotation w, which holds its hands' MANO parameters (an absent hand
    left out)."""
    W, E = win["x"].shape
    anno = np.broadcast_to(np.arange(W)[:, None], (W, E))
    r = np.stack([win["x"], win["y"], win["t"], win["p"], anno, win["labels"]], -1)
    annotations: List[Dict] = []
    for w in range(W):
        frame = {}
        for i, s in enumerate(("left", "right")):
            if win["valid"][w, i] > 0:
                frame[s] = {"global_orient": win["global_orient"][w, i],
                            "hand_pose": win["hand_pose"][w, i],
                            "shape": win["shape"][w, i], "trans": win["trans"][w, i]}
        annotations.append(frame)
    return r.reshape(W * E, 6).astype(np.int64), annotations
