"""Host-side (numpy) box transforms: camera↔lidar↔image.

Parity: reference utils/box_utils.py:127-282 (camera/lidar/image box
conversions) plus 9-DoF corner generation (:57-71) for viz and infos.

Conventions: lidar boxes [x,y,z,dx,dy,dz,yaw(,pitch,roll)] centered;
camera boxes [x,y,z,l,h,w,ry] with y at the box BOTTOM; yaw_lidar =
-(ry_cam + pi/2).
"""

from __future__ import annotations

import numpy as np

from .common_utils import angles_to_matrix, rotation_matrix_z

CORNER_TEMPLATE = (
    np.array(
        [
            [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
            [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        ],
        dtype=np.float64,
    )
    / 2.0
)


def boxes_to_corners_3d(boxes):
    """(N, 7+) lidar boxes (yaw only) → (N, 8, 3)."""
    corners = boxes[:, None, 3:6] * CORNER_TEMPLATE[None]
    rot = rotation_matrix_z(boxes[:, 6])
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return (corners + boxes[:, None, 0:3]).astype(np.float32)


def boxes9d_to_corners_3d(boxes):
    """(N, 9+) full-pose lidar boxes → (N, 8, 3)."""
    corners = boxes[:, None, 3:6] * CORNER_TEMPLATE[None]
    rot = angles_to_matrix(boxes[:, 6], boxes[:, 7], boxes[:, 8])
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return (corners + boxes[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib, pitch=None,
                                  roll=None):
    """(N, 7) camera [x,y,z,l,h,w,ry] (y at bottom) → lidar
    [x,y,z,dx,dy,dz,yaw(,pitch,roll)]."""
    boxes = boxes3d_camera.copy()
    xyz_camera = boxes[:, 0:3]
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    out = [xyz_lidar, l, w, h, -(r + np.pi / 2)]
    if pitch is not None:
        out += [pitch.reshape(-1, 1), np.zeros_like(l) if roll is None else roll.reshape(-1, 1)]
    return np.concatenate(out, axis=-1).astype(np.float32)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7+) lidar → (N, 7) camera [x,y,z,l,h,w,ry], y at bottom."""
    boxes = boxes3d_lidar.copy()
    xyz_lidar = boxes[:, 0:3]
    l, w, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1).astype(np.float32)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes → (N, 8, 3) camera-frame corners."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]).T
    z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]).T
    if bottom_center:
        y = np.zeros((n, 8))
        y[:, 4:8] = -h.reshape(n, 1)
    else:
        y = np.array([h / 2] * 4 + [-h / 2] * 4).T
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(n), np.ones(n)
    rot = np.array(
        [
            [np.cos(ry), zeros, np.sin(ry)],
            [zeros, ones, zeros],
            [-np.sin(ry), zeros, np.cos(ry)],
        ]
    ).transpose(2, 0, 1)
    corners = np.stack([x, y, z], axis=2)  # (N, 8, 3)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes → (N, 4) [x1,y1,x2,y2] image boxes."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    c = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([c.min(axis=1), c.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0, image_shape[1] - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0, image_shape[0] - 1)
    return boxes2d.astype(np.float32)


def in_hull_obb(points, box9d):
    """Exact point-in-9DoF-box (numpy twin of ops.geometry)."""
    rot = angles_to_matrix(box9d[6], box9d[7], box9d[8])
    local = (points[:, :3] - box9d[:3]) @ rot
    return np.all(np.abs(local) <= box9d[3:6] / 2 + 1e-6, axis=-1)


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    corners = boxes_to_corners_3d(boxes[:, :7])
    inside = (
        (corners >= np.asarray(limit_range[0:3]))
        & (corners <= np.asarray(limit_range[3:6]))
    ).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners
