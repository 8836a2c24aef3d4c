"""Camera helpers of the real-data path.

Counterparts of ``ev2hands_tpu/camera.py``:
  * ``opengl_projection_transform`` (torch), the projection of the 2-D
    reprojection loss of finetuning;
  * ``undistort_points`` (numpy, on the host), without OpenCV: the port
    writes out ``cv2.undistortPoints``' fixed-point iteration for the k1 k2
    p1 p2 k3 distortion model, then reprojects through the camera matrix and
    clips to the sensor as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

def opengl_projection_transform(
    projection_matrix: torch.Tensor,   # [4, 4]
    width: int,
    height: int,
    points: torch.Tensor,              # [..., 3] camera space
) -> torch.Tensor:
    """Camera-space points -> [..., 2] pixel coordinates through an OpenGL
    projection matrix: the homogeneous divide, then ``(1 - ndc) * 0.5 *
    (W, H)``."""
    h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    h = torch.einsum("ij,...j->...i", projection_matrix.to(points.dtype), h)
    h = h / h[..., -1:]
    h = (1.0 - h) * 0.5
    return torch.stack([h[..., 0] * width, h[..., 1] * height], dim=-1)


# cv2.undistortPoints without a criteria argument: a COUNT criterion of 5
# iterations.
UNDISTORT_ITERS = 5


def undistort_points(
    xy: np.ndarray, camera_matrix: np.ndarray, dist: np.ndarray,
    width: int, height: int, iters: int = UNDISTORT_ITERS,
) -> np.ndarray:
    """[n, 2] pixel coordinates -> [n, 2] float32 undistorted pixels,
    clipped to the sensor.

    The iteration runs in float64 with OpenCV's operation order; as OpenCV
    does for float32 input, the normalised coordinates it returns are
    rounded to float32 before the reprojection through ``camera_matrix``
    (float64)."""
    K = np.asarray(camera_matrix, np.float64)
    k = np.zeros(5)
    d = np.asarray(dist, np.float64).ravel()
    if d.size not in (4, 5):
        raise ValueError(f"undistort_points: want 4 or 5 distortion "
                         f"coefficients (k1 k2 p1 p2 [k3]), got {d.size}")
    k[:d.size] = d
    k1, k2, p1, p2, k3 = k
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    pts = np.asarray(xy, np.float32).reshape(-1, 2).astype(np.float64)
    u, v = pts[:, 0], pts[:, 1]
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    # a point whose distortion factor turns negative keeps its pinhole
    # coordinates from then on, as in OpenCV
    done = np.zeros(x.shape, bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        done |= icdist < 0
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(done, x0, (x0 - dx) * icdist)
        y = np.where(done, y0, (y0 - dy) * icdist)
    und = np.stack([x, y], axis=-1).astype(np.float32)
    und = np.c_[und, np.ones_like(und[:, 0])] @ K.T
    und = und[:, :2]
    und[:, 0] = np.clip(und[:, 0], 0, width - 1)
    und[:, 1] = np.clip(und[:, 1], 0, height - 1)
    return und.astype(np.float32)
