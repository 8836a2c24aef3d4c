"""Z-buffered triangle rasterisation in plain PyTorch: the demo's mesh
pane and the data generator's shaded frames on the device.

Counterpart of ``ev2hands_tpu/datagen/rasterizer.py``: perspective-project
the vertices, evaluate each triangle's three edge functions at every pixel
centre of a block of rows, and keep per pixel the nearest covered triangle
in front of the camera (lowest triangle index on a tie, as ``jnp.argmin``
and ``torch.argmin`` both return the first minimum). The JAX package maps
over single rows to bound its working set at [T, W]; here a block of
``ROWS`` rows is one [ROWS, T, W] step, which bounds memory the same way
with fewer launches. ``rasterize_mesh`` gives per-pixel class ids
(background 0, else the triangle's material), flat-shaded intensity and
depth; ``rasterize_scene`` Gouraud colours lit by point lights.

Randomness cannot match ``jax.random``: ``sample_train_lights`` and
``background_draws`` draw from an explicit ``torch.Generator``, and
``background_from_draws`` is the deterministic rest of
``random_background``, so a test can give both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# image rows a step: [ROWS, T, W] f32 temporaries, ~68 MB each for the
# demo's two hands (3,076 triangles) on the 346-pixel-wide sensor
ROWS = 16


class RasterOutput(NamedTuple):
    class_id: torch.Tensor    # [H, W] int32: 0 background, else material id
    intensity: torch.Tensor   # [H, W] float32 flat-shaded in [0, 1]
    depth: torch.Tensor       # [H, W] float32 (0 where background)


class ShadedRasterOutput(NamedTuple):
    class_id: torch.Tensor    # [H, W] int32: 0 background, else material id
    rgb: torch.Tensor         # [H, W, 3] float32 in [0, 1] (black where background)
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


def _nearest_triangles(
    xy: torch.Tensor, z: torch.Tensor, faces: torch.Tensor, width: int, height: int,
) -> Tuple[torch.Tensor, Iterator[Tuple[torch.Tensor, ...]]]:
    """Screen xy [V, 2] and depths [V] of the vertices, faces [T, 3] ->
    (the triangles' safe signed areas [T], an iterator over blocks of up to
    ``ROWS`` image rows). A block gives the nearest covered triangle a
    pixel ``best`` [R, W] (0 where none), ``hit`` [R, W], its depth there
    and its three edge functions there [3, R, W]."""
    tri_xy = xy[faces]   # [T, 3, 2]
    tri_z = z[faces]     # [T, 3]
    a, b, c = tri_xy[:, 0], tri_xy[:, 1], tri_xy[:, 2]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    safe_area = torch.where(torch.abs(area) < 1e-9, 1e-9, area)
    sign = torch.sign(safe_area)[:, None]
    visible = (tri_z.mean(dim=-1) > 1e-6)[:, None]   # in front of the camera
    z0, z1, z2 = tri_z[:, 0:1], tri_z[:, 1:2], tri_z[:, 2:3]
    dev = xy.device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    cols = torch.arange(width, device=dev)

    def edge(p0, p1, py):
        # [R, T, W]: cross(p1 - p0, p - p0)
        return (p1[:, 0, None] - p0[:, 0, None]) * (py - p0[:, 1, None]) - (
            p1[:, 1, None] - p0[:, 1, None]) * (xs - p0[:, 0, None])

    def blocks():
        area_t = safe_area[:, None]
        for y0 in range(0, height, ROWS):
            py = (torch.arange(y0, min(y0 + ROWS, height), dtype=torch.float32,
                               device=dev) + 0.5)[:, None, None]
            w0, w1, w2 = edge(b, c, py), edge(c, a, py), edge(a, b, py)
            inside = (w0 * sign >= 0) & (w1 * sign >= 0) & (w2 * sign >= 0)
            # barycentric depth
            zpix = (w0 / area_t) * z0 + (w1 / area_t) * z1 + (w2 / area_t) * z2
            covered = inside & visible & (zpix > 1e-6)
            zbuf = torch.where(covered, zpix, torch.inf)
            best = torch.argmin(zbuf, dim=1)                      # [R, W]
            rows = torch.arange(best.shape[0], device=dev)[:, None]
            zbest = zbuf[rows, best, cols]
            w_best = torch.stack([w[rows, best, cols] for w in (w0, w1, w2)])
            yield best, torch.isfinite(zbest), zbest, w_best

    return safe_area, blocks()


def _unit_normals(v3: torch.Tensor) -> torch.Tensor:
    """Triangle corners [T, 3, 3] -> unit normals [T, 3]."""
    n = torch.linalg.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


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
    # flat shading from camera-space normals, two-sided, the light along +z
    shade = 0.2 + 0.8 * torch.abs(_unit_normals(vertices[faces])[:, 2])

    _, blocks = _nearest_triangles(xy, z, faces, width, height)
    cls_rows, inten_rows, depth_rows = [], [], []
    for best, hit, zbest, _ in blocks:
        cls_rows.append(torch.where(hit, materials[best], 0).to(torch.int32))
        inten_rows.append(torch.where(hit, shade[best], 0.0))
        depth_rows.append(torch.where(hit, zbest, 0.0))
    return RasterOutput(class_id=torch.cat(cls_rows), intensity=torch.cat(inten_rows),
                        depth=torch.cat(depth_rows))


def sample_train_lights(generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's point lights, drawn on the generator's device: three
    anchored positions ([0, -1, 1], [0, 1, 1], [1, 1, 2]) with U[0, 1)/10
    jitter and two uniform in [-2, 2]^3, each of integer intensity in
    {1, ..., 4} -> (positions [5, 3], intensities [5]) float32."""
    dev = generator.device
    anchors = torch.tensor([[0.0, -1.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 2.0]],
                           device=dev)
    jit3 = torch.rand((3, 3), generator=generator, device=dev)
    jit3 = jit3 / torch.full_like(jit3, 10.0)
    rnd2 = (2.0 * torch.rand((2, 3), generator=generator, device=dev) - 1.0) * 2.0
    positions = torch.cat([anchors + jit3, rnd2], dim=0)
    intensities = torch.randint(1, 5, (5,), generator=generator, device=dev)
    return positions, intensities.to(torch.float32)


def background_draws(generator: torch.Generator, height: int, width: int,
                     cells: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniforms of ``random_background``, on the generator's device:
    (a colour grid [cells, cells, 3], fine noise [H, W, 1])."""
    dev = generator.device
    grid = torch.rand((cells, cells, 3), generator=generator, device=dev)
    fine = torch.rand((height, width, 1), generator=generator, device=dev)
    return grid, fine


def background_from_draws(grid: torch.Tensor, fine: torch.Tensor,
                          height: int, width: int) -> torch.Tensor:
    """A background tile [H, W, 3] in [0, 1]: the grid upsampled bilinearly
    (half-pixel centres, as ``jax.image.resize``) plus 0.05 x the fine
    noise, clipped."""
    smooth = F.interpolate(grid.permute(2, 0, 1)[None], size=(height, width),
                           mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    return torch.clamp(smooth + fine * 0.05, 0.0, 1.0)


def random_background(generator: torch.Generator, height: int, width: int,
                      cells: int = 8) -> torch.Tensor:
    """A procedural background tile [H, W, 3] in [0, 1] (a low-frequency
    colour field plus fine noise): the static clutter behind the hands."""
    return background_from_draws(*background_draws(generator, height, width, cells),
                                 height, width)


def rasterize_scene(
    vertices: torch.Tensor,       # [V, 3] camera space
    faces: torch.Tensor,          # [T, 3] int
    materials: torch.Tensor,      # [T] int per-triangle class id (> 0)
    vertex_colors: torch.Tensor,  # [V, 3] float32 in [0, 1]
    light_pos: torch.Tensor,      # [L, 3] point-light positions (camera space)
    light_int: torch.Tensor,      # [L] intensities
    projection: torch.Tensor,     # [4, 4]
    width: int,
    height: int,
    ambient: float = 0.1,
) -> ShadedRasterOutput:
    """Gouraud-shaded z-buffered render: each pixel interpolates its
    triangle's lit vertex colours barycentrically. A triangle is lit at its
    centroid by the point lights (two-sided Lambert, inverse-square falloff,
    1/pi normalisation) over an ambient term, then tone-mapped x / (1 + x)."""
    faces = faces.long()
    xy, z = project_vertices(vertices, projection, width, height)
    v3 = vertices[faces]
    n = _unit_normals(v3)
    centroid = v3.mean(dim=1)                                 # [T, 3]
    to_l = light_pos[None, :, :] - centroid[:, None, :]       # [T, L, 3]
    d2 = torch.sum(to_l * to_l, dim=-1)                       # [T, L]
    ldir = to_l / torch.sqrt(torch.clamp(d2, min=1e-12))[..., None]
    lam = torch.abs(torch.sum(ldir * n[:, None, :], dim=-1))  # [T, L]
    light_tri = ambient + torch.sum(
        light_int[None, :] * lam / (math.pi * torch.clamp(d2, min=1e-4)), dim=-1)
    lit = vertex_colors[faces] * light_tri[:, None, None]
    lit_tri_c = lit / (1.0 + lit)                             # [T, 3 corners, 3]

    safe_area, blocks = _nearest_triangles(xy, z, faces, width, height)
    cls_rows, rgb_rows, depth_rows = [], [], []
    for best, hit, zbest, w_best in blocks:
        bary = (w_best / safe_area[best]).permute(1, 2, 0)    # [R, W, 3]
        color = torch.sum(bary[..., None] * lit_tri_c[best], dim=-2)
        cls_rows.append(torch.where(hit, materials[best], 0).to(torch.int32))
        rgb_rows.append(torch.where(hit[..., None], torch.clamp(color, 0.0, 1.0), 0.0))
        depth_rows.append(torch.where(hit, zbest, 0.0))
    return ShadedRasterOutput(class_id=torch.cat(cls_rows), rgb=torch.cat(rgb_rows),
                              depth=torch.cat(depth_rows))


def render_two_hands(
    verts_left: torch.Tensor,    # [V, 3]
    verts_right: torch.Tensor,   # [V, 3]
    faces,                       # [F, 3] one hand's faces (numpy or tensor)
    projection: torch.Tensor,
    width: int,
    height: int,
) -> RasterOutput:
    """Both hands in one ``rasterize_mesh``: the left's triangles are class
    1, the right's class 2."""
    V = verts_left.shape[0]
    faces = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces,
                       np.int64)
    dev = verts_left.device
    all_faces = torch.as_tensor(np.concatenate([faces, faces + V]), device=dev)
    materials = torch.as_tensor(
        np.concatenate([np.ones(len(faces)), np.full(len(faces), 2)]).astype(np.int32),
        device=dev)
    verts = torch.cat([verts_left, verts_right], dim=0)
    return rasterize_mesh(verts, all_faces, materials, projection, width, height)
