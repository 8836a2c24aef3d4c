"""Z-buffered triangle rasterisation in plain PyTorch: the demo's mesh
pane on the device.

Counterpart of the part of ``ev2hands_tpu/datagen/rasterizer.py`` that the
demo runs (``RasterOutput``, ``project_vertices``, ``rasterize_mesh``):
perspective-project the vertices, evaluate each triangle's three edge
functions at every pixel centre of a block of rows, and keep per pixel the
nearest covered triangle in front of the camera (lowest triangle index
on a tie, as ``jnp.argmin`` and ``torch.argmin`` both return the first
minimum). The JAX package maps over single rows to bound its working set
at [T, W]; here a block of ``ROWS`` rows is one [ROWS, T, W] step, which
bounds memory the same way with fewer launches. Per-pixel class ids
(background 0, else the triangle's material), flat-shaded intensity and
depth.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# image rows a step: [ROWS, T, W] f32 temporaries, ~68 MB each for the
# demo's two hands (3,076 triangles) on the 346-pixel-wide sensor
ROWS = 16


class RasterOutput(NamedTuple):
    class_id: torch.Tensor    # [H, W] int32: 0 background, else material id
    intensity: torch.Tensor   # [H, W] float32 flat-shaded in [0, 1]
    depth: torch.Tensor       # [H, W] float32 (0 where background)


def project_vertices(
    vertices: torch.Tensor,     # [V, 3] camera space, -z forward (OpenGL)
    projection: torch.Tensor,   # [4, 4] OpenGL projection matrix
    width: int,
    height: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (screen xy [V, 2] in pixels, depth [V] as positive distances)."""
    ones = torch.ones_like(vertices[:, :1])
    h = torch.cat([vertices, ones], dim=-1) @ projection.t()
    w = torch.where(torch.abs(h[:, 3:4]) < 1e-9, 1e-9, h[:, 3:4])
    ndc = h[:, :3] / w
    x = (ndc[:, 0] + 1.0) * 0.5 * width
    y = (1.0 - ndc[:, 1]) * 0.5 * height
    return torch.stack([x, y], dim=-1), -vertices[:, 2]


def rasterize_mesh(
    vertices: torch.Tensor,     # [V, 3] camera space
    faces: torch.Tensor,        # [T, 3] int
    materials: torch.Tensor,    # [T] int per-triangle class id (> 0)
    projection: torch.Tensor,   # [4, 4]
    width: int,
    height: int,
) -> RasterOutput:
    """One mesh -> ``RasterOutput`` of a ``height`` x ``width`` image, lit
    along the camera's axis, ``ROWS`` image rows at a time."""
    faces = faces.long()
    xy, z = project_vertices(vertices, projection, width, height)
    tri_xy = xy[faces]   # [T, 3, 2]
    tri_z = z[faces]     # [T, 3]

    # flat shading from camera-space normals, two-sided
    v3 = vertices[faces]
    n = torch.linalg.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    shade = 0.2 + 0.8 * torch.abs(n[:, 2])   # the light along +z

    a, b, c = tri_xy[:, 0], tri_xy[:, 1], tri_xy[:, 2]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    safe_area = torch.where(torch.abs(area) < 1e-9, 1e-9, area)[:, None]
    sign = torch.sign(safe_area)
    visible = (tri_z.mean(dim=-1) > 1e-6)[:, None]   # in front of the camera
    z0, z1, z2 = tri_z[:, 0:1], tri_z[:, 1:2], tri_z[:, 2:3]
    xs = torch.arange(width, dtype=torch.float32, device=vertices.device) + 0.5
    cols = torch.arange(width, device=vertices.device)

    def edge(p0, p1, py):
        # [R, T, W]: cross(p1 - p0, p - p0)
        return (p1[:, 0, None] - p0[:, 0, None]) * (py - p0[:, 1, None]) - (
            p1[:, 1, None] - p0[:, 1, None]) * (xs - p0[:, 0, None])

    cls_rows, inten_rows, depth_rows = [], [], []
    for y0 in range(0, height, ROWS):
        py = (torch.arange(y0, min(y0 + ROWS, height), dtype=torch.float32,
                           device=vertices.device) + 0.5)[:, None, None]
        w0, w1, w2 = edge(b, c, py), edge(c, a, py), edge(a, b, py)
        inside = (w0 * sign >= 0) & (w1 * sign >= 0) & (w2 * sign >= 0)
        # barycentric depth
        zpix = (w0 / safe_area) * z0 + (w1 / safe_area) * z1 + (w2 / safe_area) * z2
        covered = inside & visible & (zpix > 1e-6)
        zbuf = torch.where(covered, zpix, torch.inf)
        best = torch.argmin(zbuf, dim=1)                      # [R, W]
        zbest = zbuf[torch.arange(best.shape[0], device=best.device)[:, None],
                     best, cols]
        hit = torch.isfinite(zbest)
        cls_rows.append(torch.where(hit, materials[best], 0).to(torch.int32))
        inten_rows.append(torch.where(hit, shade[best], 0.0))
        depth_rows.append(torch.where(hit, zbest, 0.0))
    return RasterOutput(class_id=torch.cat(cls_rows), intensity=torch.cat(inten_rows),
                        depth=torch.cat(depth_rows))
