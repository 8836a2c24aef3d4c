"""Dataset QA: replay a generated Ev2Hands-S dataset beside its ground-truth
MANO meshes.

Counterpart of ``ev2hands_tpu/datagen/visualize.py``: an mp4 of
side-by-side frames (event frame | ground-truth segmentation | the
ground-truth hands re-posed and rasterised on the device with
``render_two_hands``). It reads ``{root}.h5`` through ``Ev2HandSReader``
(``h5py``) and writes through OpenCV (``cv2``); it imports both only when
it runs, and says so where either is missing.

    python -m ev2hands_tpu_torch.datagen.visualize --root data/S/train \\
        [--mano_dir data/models | --synthetic_mano] [--out outputs/dataset_qa.mp4]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from ev2hands_tpu_torch.config import DEFAULT_CONFIG, Config
from ev2hands_tpu_torch.datagen.rasterizer import render_two_hands
from ev2hands_tpu_torch.mano.layer import ManoParams, mano_forward

# class id -> colour: background, left, right, noise
COLORS = np.array([[0, 0, 0], [0, 255, 0], [255, 0, 0], [255, 255, 255]], np.uint8)


def _require(module: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(
            f"replay needs {module}, which is not installed (h5py reads the "
            "dataset, OpenCV (cv2) writes the mp4)") from e


def replay(
    root: str,
    hands: Dict[str, ManoParams],
    out_path: str = "outputs/dataset_qa.mp4",
    cfg: Config = DEFAULT_CONFIG,
    n_windows: int = 50,
    window: int = 2048,
    fps: int = 10,
) -> str:
    """``n_windows`` windows of ``window`` events, evenly spaced over the
    dataset ``root`` (without ``.h5``), as frames [H, 3W, 3] of an mp4 at
    ``out_path``; the meshes on ``hands``' device -> ``out_path``."""
    cv2 = _require("cv2")
    _require("h5py")
    from ev2hands_tpu_torch.events.streams import Ev2HandSReader

    reader = Ev2HandSReader(root, n_events=window)
    W, H = cfg.sensor.width, cfg.sensor.height
    dev = hands["left"].v_template.device
    projection = torch.as_tensor(cfg.camera.projection_matrix(W, H),
                                 dtype=torch.float32, device=dev)
    faces = hands["left"].faces.cpu().numpy()

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (3 * W, H))
    stride = max((len(reader) - window) // max(n_windows, 1), 1)
    try:
        for i in range(n_windows):
            w = reader.window(i * stride)
            ev = w["events"]
            x = np.clip(ev[:, 0].astype(int), 0, W - 1)
            y = np.clip(ev[:, 1].astype(int), 0, H - 1)

            event_img = np.zeros((H, W, 3), np.uint8)
            event_img[y, x, 2] = np.where(ev[:, 3] > 0, 255, 0)
            event_img[y, x, 1] = np.where(ev[:, 3] <= 0, 255, 0)

            seg_img = np.zeros((H, W, 3), np.uint8)
            seg_img[y, x] = COLORS[np.clip(w["labels"], 0, 3)]

            verts = {}
            with torch.inference_mode():
                for side in ("left", "right"):
                    m = {k: torch.as_tensor(w[side][k], device=dev)
                         for k in ("global_orient", "hand_pose", "shape", "trans")}
                    verts[side] = mano_forward(
                        hands[side], m["global_orient"],
                        m["hand_pose"][: hands[side].pose_basis.shape[0]],
                        m["shape"], m["trans"]).vertices
                raster = render_two_hands(verts["left"], verts["right"], faces,
                                          projection, W, H)
            cls = raster.class_id.cpu().numpy()
            mesh_img = (COLORS[np.clip(cls, 0, 3)].astype(np.float32)
                        * raster.intensity.cpu().numpy()[..., None]).astype(np.uint8)
            writer.write(np.concatenate([event_img, seg_img, mesh_img], axis=1))
    finally:
        writer.release()
    return out_path


def main(argv: Optional[list] = None) -> str:
    from ev2hands_tpu_torch.train import add_mano_args, build_hands, check_device

    ap = argparse.ArgumentParser(description="Replay a generated dataset for QA")
    ap.add_argument("--root", required=True, help="dataset root (without .h5)")
    ap.add_argument("--out", default="outputs/dataset_qa.mp4")
    ap.add_argument("--n_windows", type=int, default=50)
    add_mano_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = DEFAULT_CONFIG.replace(
        mano=dataclasses.replace(DEFAULT_CONFIG.mano, model_path=args.mano_dir))
    device = check_device(args.device, "replay")
    hands = build_hands(cfg, synthetic=args.synthetic_mano, device=device)
    path = replay(args.root, hands, args.out, cfg, n_windows=args.n_windows)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
