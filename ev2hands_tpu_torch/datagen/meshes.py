"""Mesh assembly for the data generator: procedural forearms and skin
colours.

The port's own copy of ``ev2hands_tpu/datagen/meshes.py``:
``forearm_mesh`` (numpy) builds a tapered open cylinder from the wrist,
``forearm_vertices`` is its torch twin (the same vertex layout: ring-major,
the cap vertex last), which runs on the device inside the frame simulator
so that the forearms follow the MANO joints without a copy to the host;
``random_skin_vertex_colors`` draws skin tones from a numpy ``RandomState``
(the same draws as the JAX package's for the same seed).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ev2hands_tpu_torch.config import HAND_COLOR


def forearm_mesh(
    wrist: np.ndarray,          # [3] wrist joint (meters)
    direction: np.ndarray,      # [3] direction from hand toward the elbow
    length: float = 0.25,
    radius_wrist: float = 0.035,
    radius_elbow: float = 0.045,
    segments: int = 16,
    rings: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tapered open cylinder from the wrist along ``direction``.

    Returns (vertices [segments*rings+1, 3], faces [F, 3]).
    """
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-9)
    # orthonormal frame around d
    a = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, a); u /= np.linalg.norm(u)
    v = np.cross(d, u)

    verts = []
    for r in range(rings):
        frac = r / (rings - 1)
        center = wrist + d * (length * frac)
        radius = radius_wrist + (radius_elbow - radius_wrist) * frac
        for s in range(segments):
            ang = 2 * np.pi * s / segments
            verts.append(center + radius * (np.cos(ang) * u + np.sin(ang) * v))
    verts.append(wrist + d * length)  # elbow cap center
    verts = np.asarray(verts, np.float32)

    faces = []
    for r in range(rings - 1):
        for s in range(segments):
            s2 = (s + 1) % segments
            i0, i1 = r * segments + s, r * segments + s2
            j0, j1 = (r + 1) * segments + s, (r + 1) * segments + s2
            faces.append([i0, i1, j0])
            faces.append([i1, j1, j0])
    cap = len(verts) - 1
    base = (rings - 1) * segments
    for s in range(segments):
        faces.append([base + s, base + (s + 1) % segments, cap])
    return verts, np.asarray(faces, np.int32)


def forearm_vertices(
    wrist: torch.Tensor,        # [3] wrist joint (meters)
    direction: torch.Tensor,    # [3] toward the elbow (unnormalised)
    length: float = 0.25,
    radius_wrist: float = 0.035,
    radius_elbow: float = 0.045,
    segments: int = 16,
    rings: int = 4,
) -> torch.Tensor:
    """Torch twin of :func:`forearm_mesh`'s vertices [segments*rings+1, 3]
    on ``wrist``'s device: :func:`forearm_mesh`'s faces index them."""
    dev = wrist.device
    d = direction / torch.clamp(torch.linalg.norm(direction), min=1e-9)
    a = torch.where(torch.abs(d[0]) < 0.9,
                    torch.tensor([1.0, 0.0, 0.0], device=dev),
                    torch.tensor([0.0, 1.0, 0.0], device=dev))
    u = torch.linalg.cross(d, a)
    u = u / torch.clamp(torch.linalg.norm(u), min=1e-9)
    v = torch.linalg.cross(d, u)

    fracs = torch.linspace(0.0, 1.0, rings, device=dev)               # [R]
    radii = radius_wrist + (radius_elbow - radius_wrist) * fracs       # [R]
    centers = wrist[None, :] + d[None, :] * (length * fracs)[:, None]  # [R, 3]
    seg = torch.arange(segments, dtype=torch.float32, device=dev)
    ang = 2.0 * np.pi * seg / torch.full_like(seg, segments)          # [S]
    ring = torch.cos(ang)[:, None] * u[None, :] + torch.sin(ang)[:, None] * v[None, :]
    verts = centers[:, None, :] + radii[:, None, None] * ring[None, :, :]
    cap = wrist + d * length
    return torch.cat([verts.reshape(-1, 3), cap[None, :]], dim=0)


def estimate_forearm_direction(joints21: np.ndarray) -> np.ndarray:
    """Down-the-arm direction from the 21-joint layout: away from the palm
    (wrist minus the middle-finger MCP)."""
    wrist = joints21[0]
    middle_mcp = joints21[9]
    d = wrist - middle_mcp
    n = np.linalg.norm(d)
    return d / max(n, 1e-9)


def random_skin_vertex_colors(
    n_vertices: int, rng: np.random.RandomState
) -> np.ndarray:
    """Per-vertex skin-tone colors: a random base tone around the reference's
    HAND_COLOR (``settings.py:45``) with low-frequency mottling, [V, 3] in
    [0, 1]."""
    base = np.asarray(HAND_COLOR) * rng.uniform(0.6, 1.3)
    base = np.clip(base + rng.randn(3) * 0.05, 0.05, 1.0)
    mottle = rng.randn(n_vertices, 1) * 0.04
    colors = np.clip(base[None, :] * (1.0 + mottle), 0.0, 1.0)
    return colors.astype(np.float32)


def two_hand_scene(
    mano_outputs: Dict[str, Dict[str, np.ndarray]],
    faces: np.ndarray,
    rng: np.random.RandomState,
    add_forearms: bool = True,
) -> Dict[str, np.ndarray]:
    """Assemble a render-ready scene from both hands' MANO outputs
    (vertices [V,3] + joints [21,3] per side): concatenated vertices, faces
    with offsets, per-triangle material ids (left=1, right=2), and per-vertex
    colors. Forearms inherit their hand's material id
    (cf. ``twohands.py:56-90``)."""
    all_v, all_f, all_m, all_c = [], [], [], []
    offset = 0
    for mat, side in ((1, "left"), (2, "right")):
        v = np.asarray(mano_outputs[side]["vertices"], np.float32)
        all_v.append(v)
        all_f.append(np.asarray(faces, np.int32) + offset)
        all_m.append(np.full(len(faces), mat, np.int32))
        all_c.append(random_skin_vertex_colors(len(v), rng))
        offset += len(v)

        if add_forearms:
            j = np.asarray(mano_outputs[side]["j3d"], np.float64)
            fv, ff = forearm_mesh(j[0], estimate_forearm_direction(j))
            all_v.append(fv)
            all_f.append(ff + offset)
            all_m.append(np.full(len(ff), mat, np.int32))
            all_c.append(random_skin_vertex_colors(len(fv), rng))
            offset += len(fv)

    return {
        "vertices": np.concatenate(all_v),
        "faces": np.concatenate(all_f),
        "materials": np.concatenate(all_m),
        "vertex_colors": np.concatenate(all_c),
    }
