"""Recording labels and frame sources (port of ``absolutetrack_tpu/tracker/video_data.py``).

The label JSON (cameras, camera angles, per-frame hand poses and
camera_to_world transforms, an inline hand model) loads into numpy arrays,
with the cameras and hand model as CPU tensors. Frames come from a
width-stacked mono video (PyAV, else cv2) or from a synthetic renderer:
landmark blobs (``SyntheticFrameSource``) or the skinned hand mesh
(``MeshFrameSource``). The renderers are host numpy and scipy, as in the
JAX package; their batched projections run in torch on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel, hand_model_from_dict
from ..kinematics.skinning import landmarks_from_hand_pose, mesh_from_hand_pose


@dataclasses.dataclass
class HandPoseLabels:
    """Parsed recording labels (reference video_pose_data.py:23-93)."""

    cameras: cam.Camera  # batch (V,) intrinsics only (identity extrinsics), CPU
    camera_kind: str
    camera_angles: np.ndarray  # (V,)
    camera_to_world: np.ndarray  # (T, V, 4, 4)
    hand_model: HandModel  # millimeters, CPU
    joint_angles: np.ndarray  # (T, 2, 22)
    wrist_transforms: np.ndarray  # (T, 2, 4, 4)
    hand_confidences: np.ndarray  # (T, 2)

    def __len__(self) -> int:
        return len(self.joint_angles)

    @property
    def num_views(self) -> int:
        return len(self.camera_angles)

    def cameras_at(self, frame_idx: int) -> cam.Camera:
        """Source cameras with this frame's extrinsics attached."""
        return self.cameras._replace(
            T_world_from_eye=torch.as_tensor(self.camera_to_world[frame_idx], dtype=torch.float32)
        )


def labels_from_json(labels: dict) -> HandPoseLabels:
    """A parsed label JSON (the reference's schema) -> ``HandPoseLabels``."""
    cams, kinds = [], []
    for js in labels["cameras"]:
        c, kind = cam.camera_from_json(js)
        cams.append(c)
        kinds.append(kind)
    if len(set(kinds)) != 1:
        raise ValueError(f"mixed camera kinds unsupported: {sorted(set(kinds))}")
    return HandPoseLabels(
        cameras=cam.stack_cameras(cams),
        camera_kind=kinds[0],
        camera_angles=np.asarray(labels["camera_angles"], np.float32),
        camera_to_world=np.asarray(labels["camera_to_world_transforms"], np.float32),
        hand_model=hand_model_from_dict(labels["hand_model"]),
        joint_angles=np.asarray(labels["joint_angles"], np.float32),
        wrist_transforms=np.asarray(labels["wrist_transforms"], np.float32),
        hand_confidences=np.asarray(labels["hand_confidences"], np.float32),
    )


def load_labels(path: str) -> HandPoseLabels:
    with open(path) as f:
        return labels_from_json(json.load(f))


@torch.no_grad()
def gt_landmark_sequence(labels: HandPoseLabels) -> np.ndarray:
    """(T, 2, 21, 3) FK landmarks of the GT poses (world, mm), on the CPU."""
    t = len(labels)
    hand_b = labels.hand_model.map(lambda x: x.expand((t, 2) + x.shape))
    lm = landmarks_from_hand_pose(
        hand_b,
        torch.as_tensor(labels.joint_angles),
        torch.as_tensor(labels.wrist_transforms),
        torch.arange(2).expand(t, 2),
    )
    return lm.numpy()


def split_stacked_frame(raw_mono: np.ndarray, num_views: int) -> np.ndarray:
    """(H, V*W) width-stacked frame -> (V, H, W) per-view images (the
    reference splits by reshape, video_pose_data.py:123-125)."""
    h = raw_mono.shape[0]
    return np.moveaxis(raw_mono.reshape(h, num_views, -1), 1, 0)


class VideoFrameSource:
    """Decode a width-stacked mono video into (V, H, W) uint8 frames with
    PyAV, else cv2; ``ImportError`` when neither is installed."""

    def __init__(self, path: str, num_views: int):
        if not os.path.exists(path):
            # cv2 would yield an empty stream for a missing file
            raise FileNotFoundError(path)
        self.path = path
        self.num_views = num_views

    def __iter__(self) -> Iterator[np.ndarray]:
        try:
            import av  # type: ignore
        except ImportError:
            av = None
        if av is not None:
            container = av.open(self.path)
            try:
                for frame in container.decode(container.streams.video[0]):
                    yield split_stacked_frame(np.asarray(frame.to_image())[..., 0], self.num_views)
            finally:
                container.close()
            return
        import cv2  # type: ignore

        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            cap.release()
            raise IOError(f"cv2 cannot decode {self.path}")
        try:
            while True:
                ok, raw = cap.read()
                if not ok:
                    break
                if raw.ndim == 3:
                    raw = raw[..., 0]
                yield split_stacked_frame(raw, self.num_views)
        finally:
            cap.release()


def _sensor_size(labels: HandPoseLabels, image_size) -> Tuple[int, int]:
    if image_size is not None:
        return image_size
    return int(labels.cameras.width.reshape(-1)[0]), int(labels.cameras.height.reshape(-1)[0])


@torch.no_grad()
def _project_all(labels: HandPoseLabels, points: torch.Tensor):
    """Every frame's world points (T, K, 3) in every view, in one batched
    CPU call -> (window coords (T, V, K, 2), eye coords (T, V, K, 3))."""
    t, v = len(labels), labels.num_views
    cams = labels.cameras.map(lambda x: x.expand((t,) + x.shape))._replace(
        T_world_from_eye=torch.as_tensor(labels.camera_to_world, dtype=torch.float32)
    )
    pts = points[:, None].expand(t, v, points.shape[1], 3)
    eye = cam.world_to_eye(cams, pts)
    return cam.eye_to_window(cams, eye, labels.camera_kind).numpy(), eye.numpy()


class SyntheticFrameSource:
    """Synthetic views from the GT landmarks: gaussian blobs at each
    landmark's projection (f32 frames on the 0..255 scale)."""

    def __init__(
        self,
        labels: HandPoseLabels,
        landmarks_world: np.ndarray,  # (T, 2, 21, 3) mm
        image_size: Optional[Tuple[int, int]] = None,
        blob_sigma: float = 3.0,
    ):
        self.labels = labels
        self.landmarks = landmarks_world
        self.image_size = _sensor_size(labels, image_size)
        self.blob_sigma = blob_sigma
        self._win: Optional[np.ndarray] = None  # (T, V, 2, 21, 2)
        self._z: Optional[np.ndarray] = None  # (T, V, 2, 21)

    def _project_all(self) -> None:
        t, v = len(self.labels), self.labels.num_views
        lm = torch.from_numpy(np.array(self.landmarks, np.float32).reshape(t, 2 * 21, 3))
        win, eye = _project_all(self.labels, lm)
        self._win = win.reshape(t, v, 2, 21, 2)
        self._z = eye[..., 2].reshape(t, v, 2, 21)

    def render_frame(self, frame_idx: int) -> np.ndarray:
        if self._win is None:
            self._project_all()
        labels = self.labels
        w, h = self.image_size
        v = labels.num_views
        out = np.zeros((v, h, w), np.float32)
        r = int(4 * self.blob_sigma) + 1  # beyond 4 sigma ~ 0
        span = np.arange(-r, r + 1, dtype=np.float32)
        for hand in range(2):
            if labels.hand_confidences[frame_idx, hand] <= 0:
                continue
            win = self._win[frame_idx, :, hand]  # (V, 21, 2)
            z = self._z[frame_idx, :, hand]  # (V, 21)
            for vi in range(v):
                keep = (
                    (z[vi] > 0)
                    & (win[vi, :, 0] >= 0) & (win[vi, :, 0] < w)
                    & (win[vi, :, 1] >= 0) & (win[vi, :, 1] < h)
                )
                if not np.any(keep):
                    continue
                x0 = win[vi, keep, 0]
                y0 = win[vi, keep, 1]
                xi = np.round(x0).astype(np.int64)
                yi = np.round(y0).astype(np.int64)
                xs_l = xi[:, None] + np.arange(-r, r + 1)
                ys_l = yi[:, None] + np.arange(-r, r + 1)
                dx2 = (xi[:, None] + span - x0[:, None]) ** 2
                dy2 = (yi[:, None] + span - y0[:, None]) ** 2
                blob = 255.0 * np.exp(-(dy2[:, :, None] + dx2[:, None, :]) / (2 * self.blob_sigma**2))
                # out-of-image contributions are dropped, not clipped onto the border
                inside = (
                    (ys_l[:, :, None] >= 0) & (ys_l[:, :, None] < h)
                    & (xs_l[:, None, :] >= 0) & (xs_l[:, None, :] < w)
                )
                np.add.at(
                    out[vi],
                    (np.clip(ys_l[:, :, None], 0, h - 1), np.clip(xs_l[:, None, :], 0, w - 1)),
                    np.where(inside, blob, 0.0),
                )
        return np.clip(out, 0, 255)

    def __iter__(self) -> Iterator[np.ndarray]:
        for t in range(len(self.labels)):
            yield self.render_frame(t)


def _bary_grid(level: int) -> np.ndarray:
    """(K, 3) barycentric sample grid with i + j + k = level."""
    pts = [
        (i / level, j / level, (level - i - j) / level)
        for i in range(level + 1)
        for j in range(level + 1 - i)
    ]
    return np.asarray(pts, np.float32)


_BARY_LEVELS = (4, 8, 16, 32)  # covers projected triangle edges up to 64 px
_BARY_GRIDS = {lv: _bary_grid(lv) for lv in _BARY_LEVELS}
_PACK_SHADE = 256.0  # packed z-buffer key = z_sixteenths * 256 + shade


class MeshFrameSource:
    """Z-buffered silhouettes of the LBS-skinned hand mesh with headlamp
    shading, f32 frames of whole shades on the 0..255 scale.

    Each triangle is sampled on a barycentric grid sized to its projected
    edge length; the samples scatter into a per-view z-buffer with one
    ``np.minimum.at`` over keys that pack (depth in 1/16 mm, shade), and a
    one-pixel grey closing fills sub-pixel holes.
    """

    def __init__(
        self,
        labels: HandPoseLabels,
        image_size: Optional[Tuple[int, int]] = None,
        ambient: float = 60.0,
        diffuse: float = 185.0,
    ):
        self.labels = labels
        self.image_size = _sensor_size(labels, image_size)
        self.ambient = float(ambient)
        self.diffuse = float(diffuse)
        hm = labels.hand_model
        if hm.mesh_vertices is None or hm.dense_bone_weights is None:
            raise ValueError("labels' hand model carries no mesh; use SyntheticFrameSource")
        self._tris = hm.mesh_triangles.numpy().astype(np.int64)  # (Ntri, 3)
        self._win: Optional[np.ndarray] = None  # (T, V, 2, Nv, 2)
        self._eye: Optional[np.ndarray] = None  # (T, V, 2, Nv, 3)

    @torch.no_grad()
    def _project_all(self) -> None:
        """Skin and project every frame's mesh in one batched CPU call."""
        labels = self.labels
        t, v = len(labels), labels.num_views
        n_verts = int(self._tris.max()) + 1
        verts = mesh_from_hand_pose(
            labels.hand_model.map(lambda x: x.expand((t, 2) + x.shape)),
            torch.as_tensor(labels.joint_angles),
            torch.as_tensor(labels.wrist_transforms),
            torch.arange(2).expand(t, 2),
        )  # (T, 2, Nv, 3) world mm
        win, eye = _project_all(labels, verts.reshape(t, 2 * n_verts, 3))
        self._win = win.reshape(t, v, 2, n_verts, 2)
        self._eye = eye.reshape(t, v, 2, n_verts, 3)

    def _splat(self, pack: np.ndarray, win: np.ndarray, eye: np.ndarray) -> None:
        """Scatter one hand's triangles into the packed z-buffer (in place)."""
        w, h = self.image_size
        t2 = win[self._tris]  # (Ntri, 3, 2)
        teye = eye[self._tris]  # (Ntri, 3, 3)
        tz = teye[..., 2]
        # triangles fully in front of the camera and loosely on screen
        # (the fisheye projection of near or behind points wraps)
        xy_ok = (
            (t2[..., 0] > -w) & (t2[..., 0] < 2 * w)
            & (t2[..., 1] > -h) & (t2[..., 1] < 2 * h)
        ).all(axis=-1)
        keep = (tz > 1.0).all(axis=-1) & xy_ok
        if not np.any(keep):
            return
        t2, tz, teye = t2[keep], tz[keep], teye[keep]

        # headlamp shade off the eye-space normal toward the centroid ray
        n = np.cross(teye[:, 1] - teye[:, 0], teye[:, 2] - teye[:, 0])
        c = teye.mean(axis=1)
        denom = np.linalg.norm(n, axis=-1) * np.linalg.norm(c, axis=-1) + 1e-9
        lam = np.abs(np.einsum("ti,ti->t", n, c)) / denom
        shade = np.floor(np.clip(self.ambient + self.diffuse * lam, 0, 255))  # packs exactly

        edge = np.maximum(
            np.linalg.norm(t2[:, 0] - t2[:, 1], axis=-1),
            np.maximum(
                np.linalg.norm(t2[:, 1] - t2[:, 2], axis=-1),
                np.linalg.norm(t2[:, 2] - t2[:, 0], axis=-1),
            ),
        )
        for i, lv in enumerate(_BARY_LEVELS):
            lo = 0.0 if i == 0 else float(_BARY_LEVELS[i - 1] * 2)
            hi = float(lv * 2)  # grid spacing <= 2 px at this level
            sel = (edge > lo) & (edge <= hi) if i != len(_BARY_LEVELS) - 1 else (edge > lo)
            if not np.any(sel):
                continue
            bary = _BARY_GRIDS[lv]
            xy = np.einsum("kc,tcd->tkd", bary, t2[sel])
            z = np.einsum("kc,tc->tk", bary, tz[sel])
            xi = np.round(xy[..., 0]).astype(np.int64)
            yi = np.round(xy[..., 1]).astype(np.int64)
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            if not np.any(ok):
                continue
            key = (
                np.clip(np.round(z * 16.0), 0, 2**24).astype(np.float64) * _PACK_SHADE
                + np.broadcast_to(shade[sel, None], z.shape)
            )
            np.minimum.at(pack, (yi * w + xi)[ok], key[ok])

    def render_frame(self, frame_idx: int) -> np.ndarray:
        if self._win is None:
            self._project_all()
        from scipy.ndimage import maximum_filter, minimum_filter

        labels = self.labels
        w, h = self.image_size
        v = labels.num_views
        out = np.zeros((v, h, w), np.float32)
        for vi in range(v):
            pack = np.full(h * w, np.inf, np.float64)
            for hand in range(2):
                if labels.hand_confidences[frame_idx, hand] <= 0:
                    continue
                self._splat(pack, self._win[frame_idx, vi, hand], self._eye[frame_idx, vi, hand])
            pack = pack.reshape(h, w)
            fg = np.isfinite(pack)
            if fg.any():
                # a one-pixel grey closing of the packed depth fills holes
                # where the buffer was background, inside the silhouette's box
                rows = np.flatnonzero(fg.any(axis=1))
                cols = np.flatnonzero(fg.any(axis=0))
                r0, r1 = max(rows[0] - 2, 0), min(rows[-1] + 3, h)
                c0, c1 = max(cols[0] - 2, 0), min(cols[-1] + 3, w)
                box = pack[r0:r1, c0:c1]
                closed = maximum_filter(minimum_filter(box, size=3), size=3)
                box = np.where(np.isfinite(box), box, closed)
                finite = np.isfinite(box)
                out[vi, r0:r1, c0:c1] = np.where(
                    finite, np.mod(np.where(finite, box, 0.0), _PACK_SHADE), 0.0
                ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        for t in range(len(self.labels)):
            yield self.render_frame(t)


def make_frame_source(
    labels: HandPoseLabels,
    renderer: str = "mesh",
    landmarks_world: Optional[np.ndarray] = None,
    blob_sigma: float = 3.0,
    image_size: Optional[Tuple[int, int]] = None,
):
    """A synthetic frame source: ``mesh`` (default) or ``blobs``; the GT
    landmarks are computed for the blobs only when not given."""
    if renderer == "mesh":
        return MeshFrameSource(labels, image_size=image_size)
    if renderer != "blobs":
        raise ValueError(f"unknown renderer {renderer!r}")
    if landmarks_world is None:
        landmarks_world = gt_landmark_sequence(labels)
    return SyntheticFrameSource(labels, landmarks_world, image_size=image_size, blob_sigma=blob_sigma)
