"""Rotation conversions (numpy, host-side; a copy of the JAX package's
``utils/rotation_utils.py``, which the port may not import).

Replaces the PyTorch3D-derived suite in the reference
(``robomimic/utils/torch_utils.py:237-744``). Conventions match PyTorch3D:
rot_6d is the first two ROWS of the rotation matrix; euler convention
strings like "XYZ" mean intrinsic rotations applied in that order.
Implemented fresh from the standard math; verified against the reference
torch implementation in tests.
"""

import numpy as np


def rot_6d_to_matrix(d6):
    """[..., 6] -> [..., 3, 3] via Gram-Schmidt (PyTorch3D convention)."""
    d6 = np.asarray(d6, dtype=np.float64)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    dot = np.sum(b1 * a2, axis=-1, keepdims=True)
    b2 = a2 - dot * b1
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2)


def matrix_to_rot_6d(mat):
    """[..., 3, 3] -> [..., 6]: first two rows flattened."""
    mat = np.asarray(mat)
    return mat[..., :2, :].reshape(mat.shape[:-2] + (6,))


def matrix_to_quaternion(mat):
    """[..., 3, 3] -> [..., 4] (w, x, y, z), robust Shepperd's method."""
    m = np.asarray(mat, dtype=np.float64)
    w = np.sqrt(np.maximum(0.0, 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2])) / 2
    x = np.sqrt(np.maximum(0.0, 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2])) / 2
    y = np.sqrt(np.maximum(0.0, 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2])) / 2
    z = np.sqrt(np.maximum(0.0, 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2])) / 2
    x = np.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = np.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = np.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    q = np.stack([w, x, y, z], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quaternion_to_axis_angle(quat):
    """[..., 4] (w, x, y, z) -> [..., 3] axis * angle."""
    q = np.asarray(quat, dtype=np.float64)
    norms = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    half_angles = np.arctan2(norms[..., 0], q[..., 0])[..., None]
    angles = 2.0 * half_angles
    small = np.abs(angles) < 1e-6
    # sin(x/2)/x ~ 1/2 - x^2/48 for small x
    sin_half_over_angle = np.where(
        small, 0.5 - angles**2 / 48.0, np.sin(half_angles) / np.where(small, 1.0, angles)
    )
    return q[..., 1:] / sin_half_over_angle


def matrix_to_axis_angle(mat):
    return quaternion_to_axis_angle(matrix_to_quaternion(mat))


def axis_angle_to_matrix(aa):
    """[..., 3] -> [..., 3, 3] (Rodrigues)."""
    aa = np.asarray(aa, dtype=np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = angle[..., 0] < 1e-8
    axis = aa / np.where(angle < 1e-8, 1.0, angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = np.cos(angle[..., 0])
    s = np.sin(angle[..., 0])
    C = 1 - c
    m = np.stack(
        [
            c + x * x * C, x * y * C - z * s, x * z * C + y * s,
            y * x * C + z * s, c + y * y * C, y * z * C - x * s,
            z * x * C - y * s, z * y * C + x * s, c + z * z * C,
        ],
        axis=-1,
    ).reshape(aa.shape[:-1] + (3, 3))
    eye = np.broadcast_to(np.eye(3), m.shape)
    return np.where(small[..., None, None], eye, m)


def matrix_to_euler_angles(mat, convention="XYZ"):
    """[..., 3, 3] -> [..., 3] intrinsic euler angles (PyTorch3D convention)."""
    m = np.asarray(mat, dtype=np.float64)
    assert convention == "XYZ", "only XYZ supported (the reference uses XYZ)"
    # PyTorch3D XYZ: angles (x, y, z) with R = Rx @ Ry @ Rz
    y = np.arcsin(np.clip(m[..., 0, 2], -1.0, 1.0))
    x = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    z = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return np.stack([x, y, z], axis=-1)


def rot_6d_to_axis_angle(rot_6d):
    """Reference ``TorchUtils.rot_6d_to_axis_angle``."""
    return matrix_to_axis_angle(rot_6d_to_matrix(rot_6d))


def rot_6d_to_euler_angles(rot_6d, convention="XYZ"):
    return matrix_to_euler_angles(rot_6d_to_matrix(rot_6d), convention)


def axis_angle_to_rot_6d(aa):
    return matrix_to_rot_6d(axis_angle_to_matrix(aa))


def quaternion_to_matrix(quat):
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = np.asarray(quat, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def euler_angles_to_matrix(euler, convention="XYZ"):
    """[..., 3] intrinsic euler angles -> [..., 3, 3] (PyTorch3D convention:
    R = Rx(a0) @ Ry(a1) @ Rz(a2) for "XYZ"; reference
    ``TorchUtils.euler_angles_to_matrix``)."""
    e = np.asarray(euler, dtype=np.float64)
    assert convention == "XYZ", "only XYZ supported (the reference uses XYZ)"

    def _axis_rot(axis, angle):
        c, s = np.cos(angle), np.sin(angle)
        one, zero = np.ones_like(angle), np.zeros_like(angle)
        if axis == "X":
            rows = (one, zero, zero, zero, c, -s, zero, s, c)
        elif axis == "Y":
            rows = (c, zero, s, zero, one, zero, -s, zero, c)
        else:
            rows = (c, -s, zero, s, c, zero, zero, zero, one)
        return np.stack(rows, axis=-1).reshape(angle.shape + (3, 3))

    mats = [
        _axis_rot(ax, e[..., i]) for i, ax in enumerate(convention)
    ]
    return mats[0] @ mats[1] @ mats[2]


def euler_angles_to_quat(euler, convention="XYZ"):
    """Reference ``TorchUtils.euler_angles_to_quat`` ((w, x, y, z) order)."""
    return matrix_to_quaternion(euler_angles_to_matrix(euler, convention))


def euler_angles_to_rot_6d(euler, convention="XYZ"):
    """Reference ``TorchUtils.euler_angles_to_rot_6d``."""
    return matrix_to_rot_6d(euler_angles_to_matrix(euler, convention))
