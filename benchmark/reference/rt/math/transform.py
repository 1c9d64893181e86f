"""Quaternion / Euler / rigid-transform math on the host (numpy).

Port of ``raytracer_tpu/math/transform.py``, which is host numpy already:
scene construction happens once on the host.  Conventions follow the
reference renderer so its JSON scenes load verbatim:

- Euler angles are (pitch_x, yaw_y, roll_z) in degrees, applied as
  R = Ry(yaw) ∘ Rx(pitch) ∘ Rz(roll).
- Matrices use the row-vector convention: rows 0..2 are the images of the
  local X/Y/Z axes; ``world = local @ R + t``.
"""

from __future__ import annotations

import numpy as np


def quat_from_euler_deg(angles) -> np.ndarray:
    """Quaternion (x, y, z, w) from Euler degrees (pitch, yaw, roll)."""
    pitch, yaw, roll = [np.deg2rad(float(a)) * 0.5 for a in angles]
    sp, cp = np.sin(pitch), np.cos(pitch)
    sy, cy = np.sin(yaw), np.cos(yaw)
    sr, cr = np.sin(roll), np.cos(roll)
    # q = q_y(yaw) * q_x(pitch) * q_z(roll)  (Hamilton product)
    return np.array(
        [
            cy * cr * sp + sy * sr * cp,
            sy * cr * cp - cy * sr * sp,
            cy * sr * cp - sy * cr * sp,
            cy * cr * cp + sy * sr * sp,
        ],
        dtype=np.float64,
    )


def quat_to_matrix3(q) -> np.ndarray:
    """3x3 rotation matrix whose ROWS are the rotated basis axes."""
    x, y, z, w = [float(v) for v in q]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
            [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
            [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


class RigidTransform:
    """Rotation + translation (+ uniform scale for baked meshes)."""

    def __init__(self, translation=(0.0, 0.0, 0.0), euler_deg=(0.0, 0.0, 0.0), scale=1.0):
        self.translation = np.asarray(translation, dtype=np.float64)
        self.rot = quat_to_matrix3(quat_from_euler_deg(euler_deg))
        self.scale = float(scale)


def parse_transform(obj: dict | None) -> RigidTransform:
    """Parse the reference JSON ``transform`` block."""
    if not obj:
        return RigidTransform()
    return RigidTransform(
        translation=obj.get("translation", (0.0, 0.0, 0.0)),
        euler_deg=obj.get("orientation", (0.0, 0.0, 0.0)),
        scale=obj.get("scale", 1.0),
    )
