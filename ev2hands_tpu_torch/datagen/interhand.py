"""InterHand2.6M annotation adapter.

The port's own copy of ``ev2hands_tpu/datagen/interhand.py``: loads the
MANO NeuralAnnot parameters and camera calibrations (plain JSON),
re-expresses world-frame MANO parameters in a camera frame, and converts
45-dim axis-angle finger poses to MANO PCA coefficients. numpy and scipy
on the port's ``mano/model_data.ManoModelData``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from ev2hands_tpu_torch.mano.model_data import ManoModelData


class AxisAngleToPca:
    """45-dim axis-angle finger pose -> MANO PCA coefficients.

    manopth composes ``full = hands_mean + pca @ components``; with all 45
    components the basis is square and invertible, so
    ``pca = (full - hands_mean) @ components^-1``
    (``interhand.py:110-158``)."""

    def __init__(self, model: ManoModelData):
        self.hands_mean = model.hands_mean.astype(np.float64)
        self.inv_components = np.linalg.inv(model.hands_components.astype(np.float64))

    def __call__(self, pose_aa: np.ndarray) -> np.ndarray:
        pose_aa = np.asarray(pose_aa, np.float64).reshape(-1, 45)
        return ((pose_aa - self.hands_mean) @ self.inv_components).astype(np.float32)


class CameraTransform:
    """Re-express world-frame MANO params in a camera frame
    (``interhand.py:25-104``): rotate the root orientation and compensate the
    translation through the shaped root joint (MANO rotates about the root
    joint, not the origin)."""

    def __init__(self, models: Dict[str, ManoModelData]):
        self.models = models

    def root_joint(self, side: str, betas: np.ndarray) -> np.ndarray:
        m = self.models[side]
        v_shaped = m.v_template + m.shapedirs @ np.asarray(betas, np.float32)
        return (m.J_regressor @ v_shaped)[0]

    def world_to_camera(
        self,
        side: str,
        global_orient: np.ndarray,  # [3] axis-angle, world
        transl: np.ndarray,         # [3] meters, world
        betas: np.ndarray,          # [10]
        R: np.ndarray,              # [3, 3] world->camera rotation
        t: np.ndarray,              # [3] world->camera translation (meters)
    ) -> Dict[str, np.ndarray]:
        R = np.asarray(R, np.float64)
        root = self.root_joint(side, betas).astype(np.float64)
        R_go = Rotation.from_rotvec(np.asarray(global_orient, np.float64))
        new_go = Rotation.from_matrix(R @ R_go.as_matrix()).as_rotvec()
        # world point p = R_go (x - root) + root + trans ; camera p' = R p + t
        new_trans = R @ (np.asarray(transl, np.float64) + root) + np.asarray(t) - root
        return {
            "global_orient": new_go.astype(np.float32),
            "trans": new_trans.astype(np.float32),
        }


class InterHandAnnotations:
    """Groups InterHand2.6M MANO annotations by capture/camera/frame
    (``interhand.py:162-229``). Expects the standard release layout:
    ``annotations/{split}/InterHand2.6M_{split}_MANO_NeuralAnnot.json`` and
    ``..._camera.json``."""

    def __init__(self, root: str, split: str):
        anno_dir = os.path.join(root, "annotations", split)
        with open(os.path.join(anno_dir, f"InterHand2.6M_{split}_MANO_NeuralAnnot.json")) as f:
            self.mano = json.load(f)
        with open(os.path.join(anno_dir, f"InterHand2.6M_{split}_camera.json")) as f:
            self.cameras = json.load(f)

    def capture_ids(self):
        return sorted(self.mano.keys(), key=int)

    def camera_params(self, capture_id: str, camera_id: str):
        cam = self.cameras[capture_id]
        R = np.asarray(cam["camrot"][camera_id], np.float64)
        t = np.asarray(cam["campos"][camera_id], np.float64) / 1000.0  # mm -> m
        # InterHand convention: x_cam = R (x_world - campos)
        return R, -R @ t

    def sequence(self, capture_id: str) -> Dict[int, Dict[str, Optional[Dict]]]:
        """{frame: {hand_type: {pose(48), shape, trans} | None}} in world frame."""
        frames = {}
        for frame_idx, hands in self.mano[capture_id].items():
            entry = {}
            for hand_type in ("left", "right"):
                h = hands.get(hand_type)
                if h is None:
                    entry[hand_type] = None
                    continue
                entry[hand_type] = {
                    "pose": np.asarray(h["pose"], np.float32),
                    "shape": np.asarray(h["shape"], np.float32),
                    "trans": np.asarray(h["trans"], np.float32),
                }
            frames[int(frame_idx)] = entry
        return frames
