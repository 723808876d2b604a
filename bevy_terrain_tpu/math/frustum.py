"""Host-side frustum math for tile culling.

The reference declares a ``CullingUniform`` with the view position, the
view-projection matrix and five frustum planes, and ships a plane
extraction helper (/root/reference/src/render/culling_bind_group.rs:25-55)
— though that snapshot leaves ``planes`` at default. This build
populates them: the host extracts planes (f64) from the camera's
view-projection each frame and the refinement kernel tests each candidate
tile's bounding volume against them (SURVEY.md L3 target), so tiles
outside the frustum are neither subdivided, meshed, nor sampled.

All functions are plain numpy (f64): this runs once per frame per view on
the host, next to the other f64 camera math.
"""

from __future__ import annotations

import numpy as np


def perspective(fov_y: float, aspect: float, near: float, far: float | None = None) -> np.ndarray:
    """Right-handed perspective projection (wgpu/Bevy convention: looking
    down -Z, depth mapped to [0, 1]). ``far=None`` gives an infinite
    reverse-Z projection (Bevy's default camera)."""
    f = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    if far is None:
        # infinite reverse-Z: z' = near / -z  (depth 1 at near, 0 at inf)
        m[2, 2] = 0.0
        m[2, 3] = near
    else:
        m[2, 2] = far / (near - far)
        m[2, 3] = far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->view matrix for a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def view_projection(eye, target, fov_y: float, aspect: float,
                    near: float = 0.1, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Convenience: infinite-reverse-Z perspective @ look_at."""
    return perspective(fov_y, aspect, near) @ look_at(eye, target, up)


def frustum_planes(view_proj: np.ndarray) -> np.ndarray:
    """Extract 5 frustum planes from a view-projection matrix.

    Same formula as the reference's helper (culling_bind_group.rs:25-38):
    planes i = row3 +/- row(i/2) for i in 0..4 (left, right, bottom, top)
    plus row3 - row2 (i=4). With an infinite reverse-Z projection the
    fifth plane is the near plane (row3 - row2 = w - z >= 0 <=> z <= w).
    Planes are normalized so signed distances are in world units; a point
    p is inside when dot(n, p) + d >= 0 for all planes.

    Returns (5, 4) f64 [nx, ny, nz, d].
    """
    vp = np.asarray(view_proj, np.float64)
    row3 = vp[3]
    planes = np.zeros((5, 4), np.float64)
    for i in range(5):
        row = vp[i // 2]
        planes[i] = row3 + row if (i & 1) == 0 and i != 4 else row3 - row
    norms = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return planes / np.maximum(norms, 1e-30)


def accept_all_planes() -> np.ndarray:
    """(5, 4) planes that classify every point as inside (culling off)."""
    p = np.zeros((5, 4), np.float64)
    p[:, 3] = 1.0
    return p
