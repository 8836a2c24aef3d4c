"""Streaming demo: a real event recording -> sliding-window inference ->
a three-pane video (events, segmentation, hand meshes).

Counterpart of ``ev2hands_tpu/demo.py``. Windows are assembled on the host
in a background thread (``Prefetcher``) while the card runs the step; one
step (``make_demo_step``) does the device work of a batch: the serving
function (ERPC -> TEHNet eval -> MANO, ``export.make_serving_fn``), the
event pixels, and the mesh pane: the vertices projected to pixels
(``splat``), or both meshes z-buffer rasterised on the device
(``device``, ``datagen/rasterizer.rasterize_mesh``). The host paints the
panes with numpy and hands each frame to a writer. It runs on the card
unless asked for the CPU.

    python -m ev2hands_tpu_torch.demo --input recording.pickle \\
        [--checkpoint_path best.pth] [--mano_dir data/models | --synthetic_mano] \\
        [--mesh_render splat|device|pyrender] [--out outputs/demo.mp4]

The command line writes an mp4 through OpenCV (``cv2``) and says so where
OpenCV is missing; ``run_demo`` itself takes any object with a
``write(frame)`` method.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ev2hands_tpu_torch.camera import opengl_projection_transform
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, Config
from ev2hands_tpu_torch.datagen.rasterizer import rasterize_mesh
from ev2hands_tpu_torch.export import make_serving_fn
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.model.tehnet import TEHNet

MESH_RENDERS = ("splat", "device", "pyrender")


def make_demo_step(net: TEHNet, hands: Dict[str, ManoParams], cfg: Config,
                   mesh_render: str = "splat"):
    """-> ``step(events [B, N, 4], valid [B, N], uniforms [B, n_points]
    float64)`` -> what the painters need, on the net's device: the
    segmentation argmax ``seg`` [B, n], the event pixels ``xy`` [B, n, 2],
    the polarity counts ``polarity`` [B, n, 2], the vertices in meters
    (``verts_left`` / ``verts_right`` [B, 778, 3]) and projected to pixels
    (``px_left`` / ``px_right`` [B, 778, 2]); and with
    ``mesh_render="device"`` both meshes rasterised (``mesh_cls`` [B, H, W]
    int32: 0 background, 1 left, 2 right; ``mesh_shade`` [B, H, W])."""
    if mesh_render not in MESH_RENDERS:
        raise ValueError(f"mesh_render={mesh_render!r}: want one of {MESH_RENDERS}")
    W, H = cfg.sensor.width, cfg.sensor.height
    device = next(net.parameters()).device
    serve = make_serving_fn(net, hands, cfg)
    projection = torch.as_tensor(cfg.camera.projection_matrix(W, H),
                                 dtype=torch.float32, device=device)
    size = torch.tensor([W, H], dtype=torch.float32, device=device)
    if mesh_render == "device":
        fl, fr = hands["left"].faces, hands["right"].faces
        n_v = hands["left"].v_template.shape[0]
        all_faces = torch.cat([fl, fr + n_v])
        materials = torch.cat([torch.ones(len(fl), dtype=torch.int32, device=device),
                               torch.full((len(fr),), 2, dtype=torch.int32,
                                          device=device)])
        # opengl_projection_transform maps x -> (1 - ndc_x) * 0.5 * W, the
        # rasterizer x -> (ndc_x + 1) * 0.5 * W: negate the first row so
        # both panes share the reference's orientation
        raster_proj = projection * torch.tensor(
            [[-1.0], [1.0], [1.0], [1.0]], device=device)

    @torch.inference_mode()
    def step(events, valid, uniforms) -> Dict[str, torch.Tensor]:
        out = serve(events.to(device), valid.to(device), uniforms.to(device))
        ev = out["events"]
        vl, vr = out["left_vertices"], out["right_vertices"]
        res = {
            "seg": out["seg"],
            "xy": (ev[..., :2] + 1.0) * 0.5 * size,
            "polarity": ev[..., 3:5],
            "px_left": opengl_projection_transform(projection, W, H, vl * 1e3),
            "px_right": opengl_projection_transform(projection, W, H, vr * 1e3),
            "verts_left": vl,
            "verts_right": vr,
        }
        if mesh_render == "device":
            # one window at a time bounds the rasterizer's working set
            rasters = [rasterize_mesh(v, all_faces, materials, raster_proj, W, H)
                       for v in torch.cat([vl, vr], dim=1) * 1e3]
            res["mesh_cls"] = torch.stack([r.class_id for r in rasters])
            res["mesh_shade"] = torch.stack([r.intensity for r in rasters])
        return res

    return step


def render_event_frame(xy, polarity, width, height) -> np.ndarray:
    """Positive events red, negative green (BGR), by their share of a
    pixel's polarity counts."""
    img = np.zeros((height, width, 3), np.uint8)
    x = np.clip(xy[:, 0].astype(int), 0, width - 1)
    y = np.clip(xy[:, 1].astype(int), 0, height - 1)
    total = polarity.sum(-1).clip(min=1)
    img[y, x, 2] = (polarity[:, 0] / total * 255).astype(np.uint8)
    img[y, x, 1] = (polarity[:, 1] / total * 255).astype(np.uint8)
    return img


def render_segmentation(xy, seg, width, height) -> np.ndarray:
    """Each event at its pixel: left green, right blue, noise white (BGR),
    background black."""
    img = np.zeros((height, width, 3), np.uint8)
    x = np.clip(xy[:, 0].astype(int), 0, width - 1)
    y = np.clip(xy[:, 1].astype(int), 0, height - 1)
    colors = np.array([[0, 0, 0], [0, 255, 0], [255, 0, 0], [255, 255, 255]],
                      np.uint8)
    img[y, x] = colors[np.clip(seg, 0, 3)]
    return img


def paint_mesh_splat(px_left, px_right, width, height) -> np.ndarray:
    """The projected vertices as points: left green, right blue (BGR)."""
    img = np.zeros((height, width, 3), np.uint8)
    for pts, color in ((px_left, (0, 255, 0)), (px_right, (255, 0, 0))):
        x = np.clip(pts[:, 0].astype(int), 0, width - 1)
        y = np.clip(pts[:, 1].astype(int), 0, height - 1)
        img[y, x] = color
    return img


def colorize_mesh_raster(cls, shade) -> np.ndarray:
    """The rasterised pane: left green, right blue (BGR), scaled by the
    flat-shaded intensity."""
    colors = np.array([[0, 0, 0], [0, 255, 0], [255, 0, 0]], np.float32)
    img = colors[np.clip(cls, 0, 2)] * shade[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _render_mesh_pyrender(vl, vr, fl, fr, width, height):  # pragma: no cover
    """Both meshes through pyrender's offscreen GL renderer, where it is
    installed."""
    import pyrender
    import trimesh

    scene = pyrender.Scene()
    for v, f in ((vl, fl), (vr, fr)):
        scene.add(pyrender.Mesh.from_trimesh(trimesh.Trimesh(v, f)))
    cam = pyrender.PerspectiveCamera(yfov=np.deg2rad(30), aspectRatio=width / height)
    scene.add(cam, pose=np.eye(4))
    r = pyrender.OffscreenRenderer(width, height)
    color, _ = r.render(scene)
    r.delete()
    return color[..., ::-1].copy()


def open_video_writer(path: str, fps: int, width: int, height: int):
    """An mp4 writer (OpenCV's ``VideoWriter``, mp4v) of ``width`` x
    ``height`` frames; raises where OpenCV is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "the demo writes its mp4 through OpenCV (cv2), which is not installed; "
            "install it, or call run_demo with a writer of your own") from e
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))


def run_demo(
    input_path: str,
    writer,
    checkpoint_path: str = "",
    batch_size: int = 8,
    max_windows: Optional[int] = None,
    synthetic_mano: bool = False,
    mesh_render: str = "splat",
    report_path: str = "",
    cfg: Config = DEFAULT_CONFIG,
    device="cuda",
) -> Dict:
    """Every sliding window of the recording at ``input_path`` (up to
    ``max_windows``) through the demo step in batches of ``batch_size``,
    each window's frame to ``writer.write``; the tail batch is padded and
    only its real windows are painted. Without ``checkpoint_path`` the
    weights are seeded (``weights.init_weights``, seed 0); the resample
    draws come from a generator seeded 0. Returns the report:
    frames, inference windows/s (the step and the copy to the host) and
    steady-state windows/s (everything, with prefetch overlap), both over
    the batches after the first, which carries the warm-up."""
    from ev2hands_tpu_torch.events.real_streams import RealStream, sliding_window_batches
    from ev2hands_tpu_torch.events.streams import Prefetcher
    from ev2hands_tpu_torch.train import build_hands, check_device

    device = check_device(device, "run_demo")
    W, H = cfg.sensor.width, cfg.sensor.height
    hands = build_hands(cfg, synthetic_mano, device)
    faces = {s: h.faces.cpu().numpy() for s, h in hands.items()}
    net = TEHNet(cfg.model, device=device)
    if checkpoint_path:
        from ev2hands_tpu_torch.checkpoint import load_model_state

        state = load_model_state(checkpoint_path)
    else:
        from ev2hands_tpu_torch.weights import init_weights

        state = init_weights(torch.Generator().manual_seed(0), cfg.model)
    net.load_state_dict(state, strict=True)
    step = make_demo_step(net.eval(), hands, cfg, mesh_render)
    stream = RealStream(input_path, W, H)
    gen = torch.Generator(device=device).manual_seed(0)

    n_frames = 0
    timings = []       # inference seconds a window, per batch
    batch_walls = []   # (wall seconds, windows) per batch, everything included
    batches = Prefetcher(sliding_window_batches(stream, batch_size, max_windows,
                                                with_gt=False))
    for b in batches:
        t_batch = time.perf_counter()
        k = b["n_valid"]
        ev = torch.as_tensor(b["events"], device=device)
        va = torch.as_tensor(b["event_valid"], device=device)
        u = torch.rand((ev.shape[0], cfg.model.n_points), generator=gen,
                       device=device, dtype=torch.float64)
        t0 = time.perf_counter()
        out = {key: v.cpu().numpy() for key, v in step(ev, va, u).items()}
        timings.append((time.perf_counter() - t0) / k)
        for i in range(k):
            events_img = render_event_frame(out["xy"][i], out["polarity"][i], W, H)
            seg_img = render_segmentation(out["xy"][i], out["seg"][i], W, H)
            if mesh_render == "device":
                mesh_img = colorize_mesh_raster(out["mesh_cls"][i], out["mesh_shade"][i])
            elif mesh_render == "pyrender":  # pragma: no cover - optional GL
                mesh_img = _render_mesh_pyrender(
                    out["verts_left"][i], out["verts_right"][i], faces["left"],
                    faces["right"], W, H)
            else:
                mesh_img = paint_mesh_splat(out["px_left"][i], out["px_right"][i], W, H)
            writer.write(np.concatenate([events_img, seg_img, mesh_img], axis=1))
            n_frames += 1
        batch_walls.append((time.perf_counter() - t_batch, k))

    report = {"batch_size": batch_size, "mesh_render": mesh_render, "frames": n_frames}
    if timings[1:]:
        report["inference_windows_per_s"] = 1.0 / float(np.mean(timings[1:]))
    if batch_walls[1:]:
        sec = sum(t for t, _ in batch_walls[1:])
        win = sum(kk for _, kk in batch_walls[1:])
        report["steady_state_windows_per_s"] = win / max(sec, 1e-9)
        report["steady_state_windows"] = win
        report["steady_state_seconds"] = sec
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return report


def main(argv=None) -> Dict:
    from ev2hands_tpu_torch.train import add_mano_args

    ap = argparse.ArgumentParser(description="Streaming two-hand demo")
    ap.add_argument("--input", required=True, help=".pickle or .aedat4 recording")
    ap.add_argument("--checkpoint_path", default="",
                    help="a .pth file or a checkpoint directory of the port")
    ap.add_argument("--out", default="outputs/demo.mp4")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_windows", type=int, default=None)
    add_mano_args(ap)
    ap.add_argument("--mesh_render", default="splat", choices=MESH_RENDERS,
                    help="mesh pane: projected vertices, rasterised on the device, "
                         "or pyrender's offscreen GL where it is installed")
    ap.add_argument("--report", default="",
                    help="write the throughput report (JSON) here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = DEFAULT_CONFIG.replace(
        mano=dataclasses.replace(DEFAULT_CONFIG.mano, model_path=args.mano_dir))
    W, H = cfg.sensor.width, cfg.sensor.height
    writer = open_video_writer(args.out, 25, 3 * W, H)
    try:
        report = run_demo(args.input, writer, args.checkpoint_path, args.batch_size,
                          args.max_windows, args.synthetic_mano, args.mesh_render,
                          args.report, cfg, args.device)
    finally:
        writer.release()
    print(json.dumps(report))
    print(f"wrote {report['frames']} frames to {args.out}")
    return report


if __name__ == "__main__":
    main()
