"""MANO sequence interpolation: 5 fps annotations -> the simulator's
frame rate.

The port's own copy of ``ev2hands_tpu/datagen/interpolate.py``: SLERP for
each 3-dim axis-angle block of the pose, cubic splines for shape and
translation, on the host (scipy), once a sequence before simulation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation, Slerp


def interpolate_hand_params(
    pose: np.ndarray,    # [F, P*3] axis-angle blocks
    shape: np.ndarray,   # [F, 10]
    trans: np.ndarray,   # [F, 3]
    fps_in: float,
    fps_out: float,
    output_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Interpolate one hand's parameter sequence to fps_out."""
    F = pose.shape[0]
    x_in = np.linspace(0, F, num=F, endpoint=False)
    if output_length is None:
        output_length = int(round(F / fps_in * fps_out))
    x_out = np.linspace(0, x_in[-1], num=output_length, endpoint=True)

    out_pose = []
    for i in range(0, pose.shape[1], 3):
        rots = Rotation.from_rotvec(pose[:, i : i + 3])
        out_pose.append(Slerp(x_in, rots)(x_out).as_rotvec())
    out_pose = np.concatenate(out_pose, axis=1)

    def cubic(arr):
        cols = [
            interp1d(x_in, arr[:, i], kind="cubic" if F > 3 else "linear")(x_out)
            for i in range(arr.shape[1])
        ]
        return np.stack(cols, axis=1)

    return {
        "pose": out_pose.astype(np.float32),
        "shape": cubic(shape).astype(np.float32),
        "trans": cubic(trans).astype(np.float32),
    }


def interpolate_sequence(
    seq: Dict[int, Dict[str, Optional[Dict[str, np.ndarray]]]],
    fps_in: float,
    fps_out: float,
) -> List[List[Dict]]:
    """Frame-indexed {frame: {hand_type: {pose, shape, trans} | None}} ->
    list of per-output-frame hand lists (``interpolate_sequence``,
    ``dataset/utils.py:39-113``)."""
    per_hand: Dict[str, Dict[str, list]] = {}
    for frame_idx in sorted(seq, key=int):
        for hand_type, hand in seq[frame_idx].items():
            if hand is None:
                continue
            h = per_hand.setdefault(hand_type, {"pose": [], "shape": [], "trans": []})
            h["pose"].append(np.asarray(hand["pose"], np.float32).reshape(-1))
            h["shape"].append(np.asarray(hand["shape"], np.float32).reshape(-1))
            h["trans"].append(np.asarray(hand["trans"], np.float32).reshape(-1))

    max_len = max(len(h["pose"]) for h in per_hand.values())
    output_length = int(round(max_len / fps_in * fps_out))

    frames: List[List[Dict]] = [[] for _ in range(output_length)]
    for hand_type, h in per_hand.items():
        interp = interpolate_hand_params(
            np.stack(h["pose"]), np.stack(h["shape"]), np.stack(h["trans"]),
            fps_in, fps_out, output_length,
        )
        for i in range(output_length):
            frames[i].append({
                "hand_type": hand_type,
                "pose": interp["pose"][i],
                "shape": interp["shape"][i],
                "trans": interp["trans"][i],
            })
    return frames


def augment_sequence(
    frames: List[List[Dict]], rng: np.random.RandomState, max_shift_m: float = 0.1
) -> List[List[Dict]]:
    """Random global translation per augmented copy
    (``HandSimulator/augmentations.py:15-30``)."""
    shift = rng.uniform(-max_shift_m, max_shift_m, 3).astype(np.float32)
    out = []
    for hands in frames:
        out.append([dict(h, trans=h["trans"] + shift) for h in hands])
    return out
