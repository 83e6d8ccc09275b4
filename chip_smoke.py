"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds kernel K1 (``absolutetrack_tpu_torch/csrc/bilinear_sample.cu``)
with nvcc and holds it against its plain PyTorch version on the card, in
every row-weight mode (f32, bf16, and int8 on uint8 views), at the sequential
path's shape (4 slots x 96x96), at the non-pipelined lockstep frame's
(24 recordings x 4 slots, 96 slots) and on edge cases (flat planes,
crop rows that are no multiple of 8, planes off a 16-byte boundary, one
slot, 70,000 slots), timing the two main shapes by CUDA-graph replay
(device time) and by eager calls. Then it drives seven paths at full
``ModelConfig()`` width with TF32 off, K1's launches counted from 0 just
before each:

* sequential (``HandTracker.track_sequence``): 32 frames of a synthetic
  scene with the tracked pose fed back into the next frame's crops (one
  K1 launch a frame), twice more for the spread, a synchronised stage
  breakdown, a ``torch.profiler`` trace for the device's busy time, and 8
  frames with crops from given poses compared with the port's CPU run;
* lockstep (``eval_lib.track_recordings_batched(pipelined=True)``): 24
  recordings of 16 frames in chunks of 8 (one K1 launch of 768 slots a
  chunk), twice more for the spread, stages, a one-chunk trace, K1 at
  the chunk's own coordinates against its plain version in every mode,
  and the results against the sequential tracker and against the port's
  CPU run;
* demo (``apps/demo``, replay mode): the scene's views 1-2 as a stereo
  rig, its box-mesh hand rendered by ``MeshFrameSource`` (before the
  timed loop) and GT 2D keypoints from a ``ReplayDetector``, through
  ``LiveTracker`` for 32 frames after a warm-up (one K1 launch of 4 slots
  a frame), in parity (``ModelConfig()``, f32 rows) and serving
  (``ModelConfig.serving()``, whose tracker samples with bf16 rows, as
  the TPU's kernels do): the step's host time and its spread,
  ``run_pipeline``'s, the device's busy time; each precision against the
  port's CPU run (serving end to end and, on the same inputs, conv by conv
  and its tail: ``serving_stages``), serving against parity, and one
  replay through the CLI (``main``);
* protocol (``protocol_phase``): the evaluation protocol from a checkpoint
  file to the metrics table: a reference-named state dict written as a
  ``.pt``, loaded by ``build_model``, saved and read back bit-equal; both
  eval CLIs over a label tree of 4 recordings x 32 frames with mesh frames
  (known skeleton one recording at a time, K1 at N=32 a chunk, and in
  lockstep, N=128; unknown skeleton in lockstep with the mean and the
  Gauss-Newton calibration); ``load_eval``'s metrics of each run;
  lockstep against sequential, one recording against the port's CPU run,
  the GN windows card against CPU, a serving run (K1's bf16 rows at N=32)
  and K1 at N=32 and N=128 against its plain version, with its times;
* data (``data_phase``): the packed-data path: the protocol's label tree
  packed by ``pack_sample_data.main`` (views 1-2, windows of 8 frames;
  each frame's 4 fisheye views rectified in one K1 launch of 4 x 305,280
  px), then ``run_inference_torch_data.main`` over all 32 windows 16 at a
  time and over 4 one at a time (each window preprocessed on the prefetch
  thread, one K1 launch of 16 crops), each run repeated; lockstep against
  one at a time, 2 windows against the port's CPU run, one recording's
  pack against the CPU's, a serving run (bf16 rows), the device's busy
  time over one group, a K1 failure on the prefetch thread raising in the
  consumer, and K1 at both shapes against its plain version, with its
  times;
* train (``train_phase``): ``apps.train.main`` on packed windows from a
  tree the phase packs itself (2 recordings, windows of 8), ``--branch
  both``, 16 steps of 4 windows (64 crops a step) from a reference-named
  ``.pt``, each window preprocessed on the prefetch thread (one K1 launch
  of 16 crops), saving at step 8 and 16; the train-state file read back
  bit-equal to the state in memory; ``--resume`` for 4 more steps (the
  step counter goes on); ``--rendered --input-size 96 --window 2`` for 8
  steps over recording_00/02/11 of 66 mesh frames (one K1 launch of 128
  slots a recording on uint8 frames; the cache in a fresh directory) with
  the held-out MPJPE before and after; each step's ms (synchronised) and
  wait for its batch, steps/s, crops/s and peak memory; a synchronised
  breakdown of a step into forward, backward and optimizer; the device's
  busy time over two steps; one step (2 windows, T=2) against the port's
  CPU (loss, gradients per leaf, params) and the card's own spread over
  two identical steps; K1 at the rendered shape against its plain version
  in the f32, bf16 and int8 row modes, with its times;
* parallel (``parallel_phase``): sharding over processes, each world's
  ranks spawned by ``spawn_world`` (``python3 chip_smoke.py --rank R
  <spec>``, a file store, every rank killed on a failure): the protocol's
  label tree through ``multiprocess_eval`` in one process without a
  group, at world 1 over NCCL (its init and first-collective times,
  ``allreduce_metrics``'s) and over 2 gloo ranks sharing the card (NCCL
  refuses two ranks on one card), merged metrics against the group-less
  run; in the same world the lockstep phase's recordings through
  ``track_recordings_batched(mesh=)`` (each rank 12: K1 at N=384 a chunk)
  against one process, and one train step at (data, model) = (2, 1) and
  (1, 2) on a batch whose masks differ between its halves, against one
  process on the whole batch and on the same partition (``partition_grads``);
  K1 at N=384 against its plain version, with its times; the demo's
  shared-memory frame ring (``ring_transport``, the native library built
  from source), its ms a frame.

Prints the card's name and power limit first, one ``{"path": ...}``, one
``{"lockstep": ...}``, one ``{"demo": ...}``, one ``{"protocol": ...}``, one
``{"data": ...}``, one ``{"train": ...}``, one ``{"parallel": ...}`` and one
``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": ...}``. Any failed check raises; without a CUDA
device, or without the port beside it, it exits non-zero and prints no
result.

``build_scene`` is importable (numpy only) so the tests reuse the scene.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_VIEWS = 4
SRC_HW = (480, 636)  # the sensor
PAD_HW = (512, 640)  # frames upload zero-padded to this
FEEDBACK_FRAMES = 32
GIVEN_POSE_FRAMES = 8
LOCKSTEP_RECORDINGS = 24  # bench.py's lockstep workload
LOCKSTEP_FRAMES = 16  # per recording: two chunks
LOCKSTEP_CHUNK = 8
LOCKSTEP_SLOTS = LOCKSTEP_RECORDINGS * LOCKSTEP_CHUNK * 2 * 2  # hands x views: 768
SEQUENTIAL_CHECKED = (0, 11, 23)  # recordings held against the sequential tracker
CPU_CHECKED = 2  # recordings of the card-against-CPU run, LOCKSTEP_CHUNK frames each
K1_TOL = 1e-3  # 0..255 scale; K1 rounds every product and sum as the plain version does
LANDMARK_TOL_MM = 0.5
ANGLE_TOL = 1e-3
DEMO_FRAMES = 32
DEMO_WARMUP = 4
DEMO_CPU_FRAMES = 8  # card against CPU, each precision
DEMO_CLI_FRAMES = 4
SERVING_TRANSLATION_REL = 0.01  # tests/test_models.py::TestServingPrecision's budget
SERVING_ANGLE_REL = 0.02
# Serving, the card against the port's CPU run. End to end, the rare bf16
# outputs that round the other way in cuDNN's and the CPU's sums cascade
# through the trunk to the bf16-against-f32 drift's size, so the end-to-end
# limits are parity's and cannot tell a wrongly rounded flow; stage by stage
# on the same inputs they can: each conv's outputs bit-equal, and the tail.
SERVING_CPU_WRIST_MM = LANDMARK_TOL_MM
SERVING_CPU_ANGLE = ANGLE_TOL
SERVING_CONV_BIT_EQUAL = 0.998  # the least share of a conv's bf16 outputs bit-equal to the CPU's
SERVING_TAIL_WRIST_MM = 1e-3  # the tail (ConvRNN, regressor, decode) from the same features
SERVING_TAIL_ANGLE = 1e-6
PROTOCOL_RECORDINGS = 4  # the label tree of the protocol phase
PROTOCOL_FRAMES = 32  # per recording: four chunks
PROTOCOL_CPU_FRAMES = 8  # one recording, the card against the port's CPU run
GN_LOG_SCALE_TOL = 1e-5  # the GN windows' log-scales, card against CPU
GN_RESIDUAL_TOL_MM = 1e-3  # its final mean landmark residual
DATA_RECORDINGS = 4  # the data phase's label tree: the protocol's recordings
DATA_FRAMES = 32
DATA_WINDOW = 8  # pack_sample_data's default window: N = 8 frames x 2 views = 16 slots a window
DATA_BATCH = 16  # windows in lockstep (--batch-windows)
DATA_B1_LIMIT = 4  # windows of the one-at-a-time run (--limit)
DATA_CPU_WINDOWS = 2  # windows of the card-against-CPU run
DATA_CPU_FRAMES = 16  # frames of the one recording packed on the CPU too
MONO_EQUAL = 0.999  # the least share of packed mono bytes equal between the card's pack and the CPU's
LABELS_REL = 1e-5  # packed labels, card against CPU, relative to each field's largest value
TRAIN_STEPS = 16  # packed training at --batch 4: 4 windows x T=8 x 2 views = 64 crops a step
TRAIN_RESUME_STEPS = 4
TRAIN_BATCH = 4
TRAIN_WINDOW = 8  # pack_sample_data's window: K1 at N=16 a window
TRAIN_RENDERED_STEPS = 8
TRAIN_RENDERED_FRAMES = 66  # 16 windows at stride 4 and T=2: K1 at N=4 x 16 x 2 = 128 a recording
TRAIN_RENDERED_WINDOW = 2
TRAIN_LR = 1e-4  # the CLI's default
# One step, card against CPU, at full width. tests/test_torch_training.py
# holds each gradient leaf to 1e-4 of its own largest |g| at tiny width; at
# full width a pre-activation within rounding of 0 flips a ReLU, so a leaf
# can move by ~6e-4 of its own largest (the port against JAX on the CPU:
# 5.6e-4, backbone.stage2.0.conv1), and the gradient is held against the
# largest |g| of all leaves and in norm instead; params after the step
# within 1e-6 where |g| exceeds 1e-4 of that largest, 2 lr elsewhere.
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_GRAD_NORM_REL = 1e-5
TRAIN_PARAM_TOL = 1e-6
PARALLEL_WORLD = 2  # ranks of the sharded world: the card's machine has one card, so they share it under gloo
PARALLEL_LAYOUTS = ((2, 1), (1, 2))  # (data, model) of the sharded train and eval steps
PARALLEL_BATCH = 4  # samples of the sharded steps' batch, T = PARALLEL_T frames
PARALLEL_T = 2
PARALLEL_TIMEOUT_S = 600  # a world's limit; a dead rank fails its peers within init_distributed's 120 s
PARALLEL_EVAL_REL = 1e-6  # multiprocess_eval's merged err_sum against one process (tests/test_multiprocess.py)
PARALLEL_EVAL_STEP_REL = 1e-4  # the sharded eval step's err_sum_m against one process (tests/test_parallel.py)
PARALLEL_OUTPUT_TOL = 1e-4  # its joint angles and wrists (tests/test_parallel.py)
PARALLEL_LANDMARK_MM = 1e-2  # the sharded lockstep's landmarks against one process (tests/test_parallel.py)
# A sharded step's loss and gradients against one process that computes the
# same data blocks and views at the same shapes (``partition_grads``): only
# the order of the ranks' f32 sum differs. Against the whole batch in one
# process the bounds are the train phase's for the loss and the largest |g|;
# its norm is reported: cuDNN picks other algorithms at half the batch, which
# moved the gradient by 1.6e-5 in norm on the H100 with no collective at all
# (scripts/sharded_step_noise.py; 8.5e-8 with cuDNN off).
PARALLEL_PARTITION_REL = 1e-6
RING_FRAMES = 300  # frames pushed through the demo's shared-memory ring
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


# --------------------------------------------------------------------------
# hermetic synthetic scene (numpy only)
# --------------------------------------------------------------------------


def _rot_x(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


_BOX_TRIANGLES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
    np.int64,
)


def _box(a, b, half_w: float, half_d: float) -> np.ndarray:
    """(8, 3) corners of a box from ``a`` to ``b``, ``half_w`` wide across
    the segment in the palm plane and ``half_d`` deep along z: corner
    4 * end + 2 * i + j sits at end -+ half_w (i) -+ half_d (j)."""
    d = (b - a) / np.linalg.norm(b - a)
    e1 = np.cross(d, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    return np.array([
        end + si * half_w * e1 + sj * half_d * e2
        for end in (a, b) for si in (-1, 1) for sj in (-1, 1)
    ])


def _synthetic_mesh(jp: np.ndarray, tips: np.ndarray) -> dict:
    """A box mesh of the hand: one box for the palm on the wrist frame and
    one for each finger's three phalanges, each on the skinning frame that
    moves it (frame 2 + 3f + s), with one-hot dense bone weights."""
    boxes = [(_box(np.array([-3.0, -5.0, 0.0]), np.array([-3.0, 60.0, 0.0]), 36.0, 9.0), 1)]
    for f in range(5):
        ends = [jp[4 * f + 1], jp[4 * f + 2], jp[4 * f + 3], tips[f]]
        for seg in range(3):
            boxes.append((_box(ends[seg], ends[seg + 1], 7.0 - seg, 6.0 - seg), 2 + 3 * f + seg))
    verts = np.concatenate([b for b, _ in boxes])
    frames = np.repeat([frame for _, frame in boxes], 8)
    return dict(
        mesh_vertices=verts.astype(np.float32),
        mesh_triangles=np.concatenate([_BOX_TRIANGLES + 8 * i for i in range(len(boxes))]),
        dense_bone_weights=np.eye(17, dtype=np.float32)[frames],
    )


def synthetic_hand_model(mesh: bool = False) -> dict:
    """A left-canonical hand in mm with the fields of the JAX HandModel:
    5 four-joint fingers along +y from the wrist, flexion about x,
    abduction about z, 21 landmarks skinned to 1-2 of the 17 frames. With
    ``mesh``, also a box mesh (``mesh_vertices``, ``mesh_triangles``,
    ``dense_bone_weights``) for the mesh renderer; the other fields are
    the same either way."""
    base_x = [-32.0, -18.0, -2.0, 14.0, 28.0]
    base_y = [12.0, 40.0, 42.0, 40.0, 36.0]
    seg = [17.0, 22.0, 25.0, 23.0, 18.0]
    splay = [-35.0, -6.0, 0.0, 6.0, 12.0]  # finger direction in the palm plane, deg
    jp = np.zeros((22, 3))
    axes = np.zeros((22, 3))
    lm = np.zeros((21, 3))
    bw = np.zeros((21, 3))
    bi = np.zeros((21, 3), np.int64)
    for f in range(5):
        d = _rot_z(splay[f]) @ np.array([0.0, 1.0, 0.0])
        for j in range(4):
            jp[4 * f + j] = [base_x[f], base_y[f], 0.0] + j * seg[f] * d
            axes[4 * f + j] = [0.0, 0.0, 1.0] if j == 0 else _rot_z(splay[f]) @ [1.0, 0.0, 0.0]
        frame = 2 + 3 * f  # frames 2-4 of finger f follow joints 0-1, 0-2, 0-3
        lm[f] = jp[4 * f + 3] + seg[f] * d  # fingertip
        bw[f, 0], bi[f, 0] = 1.0, frame + 2
        for j in range(3):  # landmarks at joints 1-3
            k = 6 + 3 * f + j
            lm[k] = jp[4 * f + 1 + j]
            bw[k, :2] = (0.7, 0.3) if j else (1.0, 0.0)
            bi[k, :2] = (frame + j, frame + max(j - 1, 0))
    axes[20], axes[21] = [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]
    bw[5, 0], bi[5, 0] = 1.0, 1  # wrist landmark on the wrist frame
    limits = np.tile([[-0.2, 1.4]], (22, 1))
    limits[0::4][:5] = [-0.35, 0.35]
    limits[20:] = [-0.6, 0.6]
    idx = np.arange(22)
    return dict(
        **(_synthetic_mesh(jp, lm[:5]) if mesh else {}),
        joint_rotation_axes=axes.astype(np.float32),
        joint_rest_positions=jp.astype(np.float32),
        joint_frame_index=idx,
        joint_parent=np.where(idx % 4 == 0, 21, idx - 1),
        joint_first_child=np.where(idx % 4 == 3, -1, idx + 1),
        joint_next_sibling=np.where(idx < 16, idx + 4, -1),
        landmark_rest_positions=lm.astype(np.float32),
        landmark_rest_bone_weights=bw.astype(np.float32),
        landmark_rest_bone_indices=bi,
        joint_limits=limits.astype(np.float32),
    )


def build_scene(seed: int = 0, n_frames: int = FEEDBACK_FRAMES, mesh: bool = False) -> dict:
    """A 4-camera fisheye62 rig (rolled 0/90/90/180 deg), two hands about
    350 mm in front of it moving slowly, and uint8 frames; ``mesh`` gives
    the hand model its box mesh (nothing else changes)."""
    rng = np.random.default_rng(seed)
    h, w = SRC_HW
    rolls = np.array([0.0, 90.0, 90.0, 180.0])
    positions = [[-45, -15, 0], [45, -15, 0], [-55, 20, -5], [55, 20, -5]]
    yaw_pitch = [(-15, 5), (15, 5), (-25, 12), (25, 12)]
    c2w = np.tile(np.eye(4), (N_VIEWS, 1, 1))
    for v in range(N_VIEWS):
        body = _rot_y(yaw_pitch[v][0]) @ _rot_x(yaw_pitch[v][1])
        c2w[v, :3, :3] = body @ _rot_z(-rolls[v])
        c2w[v, :3, 3] = positions[v]
    coeffs = np.zeros((N_VIEWS, 8))
    coeffs[:, :4] = [-0.02, 0.004, -0.0008, 0.0001] * (1 + 0.1 * rng.standard_normal((N_VIEWS, 4)))
    coeffs[:, 4:6] = 1e-4 * rng.standard_normal((N_VIEWS, 2))
    cameras = dict(
        fx=230.0 + rng.uniform(-5, 5, N_VIEWS),
        fy=230.0 + rng.uniform(-5, 5, N_VIEWS),
        cx=(w - 1) / 2 + rng.uniform(-3, 3, N_VIEWS),
        cy=(h - 1) / 2 + rng.uniform(-3, 3, N_VIEWS),
        coeffs=coeffs,
        width=np.full(N_VIEWS, float(w)),
        height=np.full(N_VIEWS, float(h)),
    )

    t = np.arange(n_frames)[:, None]
    ja = np.zeros((n_frames, 2, 22))
    ja[:, :, :20] = 0.25 + 0.15 * np.sin(0.2 * t[..., None] + rng.uniform(0, 6, (1, 2, 20)))
    ja[:, :, 0:20:4] *= 0.3  # small abduction
    palm_to_rig = np.diag([1.0, -1.0, -1.0])  # fingers up, palm toward the rig
    mirror = np.diag([-1.0, 1.0, 1.0])
    wrist = np.tile(np.eye(4), (n_frames, 2, 1, 1))
    for i in range(n_frames):
        rot = _rot_y(10 * math.sin(0.1 * i)) @ _rot_x(15) @ palm_to_rig
        wrist[i, 0, :3, :3] = rot
        wrist[i, 1, :3, :3] = mirror @ rot @ mirror  # the right hand mirrors the left
        wrist[i, 0, :3, 3] = [-80 + 15 * math.sin(0.15 * i), 20 + 10 * math.cos(0.1 * i), 350]
        wrist[i, 1, :3, 3] = [85 - 10 * math.sin(0.12 * i), 25, 340 + 20 * math.sin(0.1 * i)]

    return dict(
        cameras=cameras,
        camera_angles=rolls.astype(np.float32),
        camera_to_world=np.tile(c2w, (n_frames, 1, 1, 1)).astype(np.float32),
        hand_model=synthetic_hand_model(mesh),
        joint_angles=ja.astype(np.float32),
        wrist_transforms=wrist.astype(np.float32),
        hand_confidences=np.ones((n_frames, 2), np.float32),
        frames=rng.integers(0, 256, (n_frames, N_VIEWS, h, w), dtype=np.uint8),
    )


def labels_json(scene: dict, start: int = 0, length=None) -> dict:
    """Frames [start, start + length) of the scene as a label dict of the
    reference's JSON schema (``tracker/video_data.py::load_labels``)."""
    c = scene["cameras"]
    coeff_names = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")
    cameras = [
        {
            "DistortionModel": "FishEye62",
            "ImageSizeX": int(c["width"][v]), "ImageSizeY": int(c["height"][v]),
            **{k: float(c[k][v]) for k in ("fx", "fy", "cx", "cy")},
            **dict(zip(coeff_names, map(float, c["coeffs"][v]))),
        }
        for v in range(N_VIEWS)
    ]
    sl = slice(start, None if length is None else start + length)
    return {
        "cameras": cameras,
        "camera_angles": scene["camera_angles"].tolist(),
        "camera_to_world_transforms": scene["camera_to_world"][sl].tolist(),
        "hand_model": {k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()},
        "joint_angles": scene["joint_angles"][sl].tolist(),
        "wrist_transforms": scene["wrist_transforms"][sl].tolist(),
        "hand_confidences": scene["hand_confidences"][sl].tolist(),
    }


def scene_recordings(scene: dict, starts, length: int) -> list:
    """(labels, frames) pairs for the port's eval drivers: one recording of
    ``length`` frames from each start offset, frames as (V, 480, 636) uint8."""
    from absolutetrack_tpu_torch.tracker.video_data import labels_from_json

    return [
        (labels_from_json(labels_json(scene, s, length)), list(scene["frames"][s : s + length]))
        for s in starts
    ]


def pad_frames(frames: np.ndarray, pad_hw=PAD_HW) -> np.ndarray:
    """(..., H, W) -> (..., hp, wp) zero-padded."""
    out = np.zeros(frames.shape[:-2] + tuple(pad_hw), frames.dtype)
    out[..., : frames.shape[-2], : frames.shape[-1]] = frames
    return out


def border_coords(valid_hw) -> np.ndarray:
    """(K, 2) source coordinates (x, y) that probe the sampler's edges: -1
    markers, points just inside and just outside each border of the valid
    extent (x in [0, w-1), y in [0, h-1)), a NaN and far-out values."""
    h, w = valid_hw

    def below(v):
        return float(np.nextafter(np.float32(v), np.float32(-1)))

    return np.array(
        [
            (-1.0, -1.0), (0.0, 100.0), (-1e-6, 100.0), (below(w - 1), 100.0),
            (w - 1.0, 100.0), (w - 0.5, 100.0), (100.0, 0.0), (100.0, -1e-6),
            (100.0, below(h - 1)), (100.0, h - 1.0), (100.0, h - 0.5),
            (0.0, 0.0), (below(w - 1), below(h - 1)), (np.nan, 10.0),
            (1e9, 10.0), (-1e9, 10.0),
        ],
        np.float32,
    )


# --------------------------------------------------------------------------
# the port on a device
# --------------------------------------------------------------------------


def torch_scene(scene: dict, device) -> dict:
    """The scene as the port's tensors on ``device``, the frames zero-padded
    to ``PAD_HW`` as a caller uploads them (sample with ``src_valid_hw=SRC_HW``)."""
    import torch

    from absolutetrack_tpu_torch.geometry import camera as cam
    from absolutetrack_tpu_torch.kinematics.hand_model import hand_model_from_dict

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    c = scene["cameras"]
    return dict(
        cameras=cam.Camera(
            fx=f32(c["fx"]), fy=f32(c["fy"]), cx=f32(c["cx"]), cy=f32(c["cy"]),
            coeffs=f32(c["coeffs"]),
            T_world_from_eye=f32(scene["camera_to_world"][0]),
            width=f32(c["width"]), height=f32(c["height"]),
        ),
        camera_angles=f32(scene["camera_angles"]),
        camera_to_world=f32(scene["camera_to_world"]),
        hand_model=hand_model_from_dict(scene["hand_model"], device=device),
        joint_angles=f32(scene["joint_angles"]),
        wrist_transforms=f32(scene["wrist_transforms"]),
        hand_confidences=f32(scene["hand_confidences"]),
        frames=torch.as_tensor(pad_frames(scene["frames"]), device=device),
    )


def with_pose_prior(model, ts: dict, crop_size, scale: float = 1e-5):
    """A copy of ``model`` whose known-skeleton head predicts, up to
    ``scale`` times its random output, the scene's first pose in crop
    coordinates.

    Random weights put the tracked wrist anywhere, so tracked-pose feedback
    would lose the hands after one frame. A pose that is constant in crop
    coordinates is a fixed point of the feedback loop (the crop camera
    looks at the hand's center, which the prediction keeps on the axis),
    so the loop holds the hands in view as a trained model would.
    """
    import torch

    from absolutetrack_tpu_torch.models.regressor import output_dims
    from absolutetrack_tpu_torch.tracker.crop_gen import gen_crop_slots

    slots = gen_crop_slots(
        ts["cameras"], ts["camera_angles"], ts["hand_model"],
        ts["joint_angles"][0], ts["wrist_transforms"][0], ts["hand_confidences"][0],
        crop_size,
    )
    if not bool(slots.hand_valid[0]):
        raise RuntimeError("scene: the left hand is not in view at frame 0")
    ext = slots.cameras.T_world_to_eye[0, 0].clone()
    ext[:3, 3] *= 1e-3
    wrist = ts["wrist_transforms"][0, 0].clone()
    wrist[:3, 3] *= 1e-3
    b = ext @ wrist  # wrist in the crop camera, meters
    head = copy.deepcopy(model)
    out = head.regressor_k.out
    template = head.regressor_k.template
    pts = template @ b[:3, :3].T + b[:3, 3]
    ranges, _ = output_dims(False, template.shape[0])
    with torch.no_grad():
        out.weight.mul_(scale)
        out.bias.zero_()
        r = ranges["joint_angles"]
        out.bias[r[0]:r[1]] = ts["joint_angles"][0, 0, :20]
        r = ranges["wrist_xfs"]
        out.bias[r[0]:r[1]] = pts.reshape(-1)
    return head


def damped(model, head_scale: float = 0.02, memory_scale: float = 0.1):
    """A copy of ``model`` with the regression heads' output convs scaled by
    ``head_scale`` and the ConvRNN by ``memory_scale``.

    At random init the heads' outputs are ~+-40, which makes the Procrustes
    wrist decode ill-conditioned, and the memory loop has a spectral radius
    above 1: f32 summation-order noise between two devices then grows past
    any fixed tolerance. Damped, the outputs have a trained model's scale.
    """
    import torch

    out = copy.deepcopy(model)
    with torch.no_grad():
        for conv in (out.regressor_k.out, out.regressor_u.out):
            conv.weight.mul_(head_scale)
            conv.bias.mul_(head_scale)
        for conv in out.temporal.blocks:
            conv.weight.mul_(memory_scale)
            conv.bias.mul_(memory_scale)
    return out


def _call_ms(fn, iters: int) -> float:
    """Mean time of one eager call of ``fn`` over ``iters`` back-to-back
    calls, by CUDA events: the host's launch overhead included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times and timed by CUDA events, so no
    host launch overhead falls inside the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _probe(x, y, valid_hw):
    """Overwrite the first pixels of slot 0 with ``border_coords``."""
    import torch

    xy = torch.as_tensor(border_coords(valid_hw), device=x.device)
    x.view(x.shape[0], -1)[0, : len(xy)] = xy[:, 0]
    y.view(y.shape[0], -1)[0, : len(xy)] = xy[:, 1]


def touched_source_bytes(images, image_idx, xs, ys, valid_hw) -> int:
    """Bytes of ``images`` that the four taps of the in-bounds pixels read,
    each byte counted once: the least source traffic of one sample."""
    import torch

    from absolutetrack_tpu_torch.ops.warp_kernel import view_index

    h, w = valid_hw
    _, hp, wp = images.shape
    xs, ys = xs.reshape(xs.shape[0], -1), ys.reshape(ys.shape[0], -1)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    inside = (xs >= 0) & (x0 + 1 <= w - 1) & (ys >= 0) & (y0 + 1 <= h - 1)
    v = view_index(image_idx, images.shape[0])[:, None].expand_as(xs)
    corner = ((v[inside] * hp + y0[inside].long()) * wp + x0[inside].long())
    taps = torch.cat([corner, corner + 1, corner + wp, corner + wp + 1])
    return int(torch.unique(taps).numel()) * images.element_size()


def slot_cameras(ts: dict, t: int, crop_size):
    """Frame ``t``'s four crop slots from the given pose: their view
    indices (4,), source cameras and crop cameras (batch 4)."""
    from absolutetrack_tpu_torch.geometry.crop import crop_camera_to_camera
    from absolutetrack_tpu_torch.tracker.crop_gen import gen_crop_slots

    cams = ts["cameras"]._replace(T_world_from_eye=ts["camera_to_world"][t])
    slots = gen_crop_slots(
        cams, ts["camera_angles"], ts["hand_model"],
        ts["joint_angles"][t], ts["wrist_transforms"][t], ts["hand_confidences"][t],
        crop_size,
    )
    idx = slots.view_idx.reshape(-1)
    src = cams.map(lambda a: a[idx])
    crop = crop_camera_to_camera(slots.cameras.map(lambda a: a.reshape((4,) + a.shape[2:])), crop_size)
    return idx, src, crop


def kernel_inputs(ts: dict, crop_size) -> dict:
    """K1's inputs at the sequential path's shape and the non-pipelined
    lockstep frame's, as (N, h, w) planes on the main path's layout: frame
    0's four slots (``idx``, ``x4``, ``y4``; slot 3 looks down the source's
    optical axis) and those slots 24 times, jittered (``idx96``, ...)."""
    import torch

    from absolutetrack_tpu_torch.geometry import camera as cam
    from absolutetrack_tpu_torch.ops.resample import _crop_source_coords_planar

    dev = ts["frames"].device
    idx, src, crop = slot_cameras(ts, 0, crop_size)
    # slot 3: identity source and crop poses, so the crop's centre pixel
    # lies exactly on the source's optical axis (r == 0)
    eye = torch.eye(4, device=dev)
    center = float(crop_size[0] // 2)
    src = src._replace(T_world_from_eye=torch.stack([*src.T_world_from_eye[:3], eye]))
    crop = crop._replace(
        T_world_from_eye=torch.stack([*crop.T_world_from_eye[:3], eye]),
        cx=torch.cat([crop.cx[:3], torch.tensor([center], device=dev)]),
        cy=torch.cat([crop.cy[:3], torch.tensor([center], device=dev)]),
    )
    x4, y4 = _crop_source_coords_planar(src, crop, crop_size, cam.FISHEYE62, True)
    axis_px = int(center) * crop_size[0] + int(center)
    if not (torch.isfinite(x4).all() and torch.isfinite(y4).all()):
        raise RuntimeError("coordinate planes are not finite (subnormal epsilon flushed?)")
    if float(x4[3, axis_px]) != float(src.cx[3]) or float(y4[3, axis_px]) != float(src.cy[3]):
        raise RuntimeError("the on-axis pixel does not map to the principal point")

    # K1 takes (N, h, w) planes on the main path (warp_perspective_crop)
    x4, y4 = (a.view(4, crop_size[1], crop_size[0]) for a in (x4, y4))
    gen = torch.Generator(device="cpu").manual_seed(1)
    reps = 24
    jitter = lambda: (20 * torch.rand((reps * 4, 1, 1), generator=gen) - 10).to(dev)  # noqa: E731
    return dict(
        idx=idx, x4=x4, y4=y4,
        idx96=idx.repeat(reps).contiguous(),
        x96=(x4.repeat(reps, 1, 1) + jitter()).contiguous(),
        y96=(y4.repeat(reps, 1, 1) + jitter()).contiguous(),
    )


def kernel_phase(ts: dict, crop_size) -> dict:
    """K1 against its plain version on the card, in every row-weight mode,
    at the sequential path's shape (N=4 slots x 96x96), at the
    non-pipelined lockstep frame's (24 recordings x 4 slots, N=96) and on
    ``k1_edge_cases``; K1's times at the two main shapes."""
    import torch

    dev = ts["frames"].device
    k = kernel_inputs(ts, crop_size)
    idx, x4, y4, idx96, x96, y96 = (k[name] for name in ("idx", "x4", "y4", "idx96", "x96", "y96"))

    padded_u8 = ts["frames"][0].contiguous()
    unpadded_u8 = padded_u8[:, : SRC_HW[0], : SRC_HW[1]].contiguous()
    sources = {
        "uint8_padded": (padded_u8, SRC_HW),
        "uint8_unpadded": (unpadded_u8, None),
        "float32_padded": (padded_u8.float(), SRC_HW),
        "float32_unpadded": (unpadded_u8.float(), None),
        "bfloat16_padded": (padded_u8.to(torch.bfloat16), SRC_HW),
        # fractional values: the bf16 rows round them, as the Pallas kernels do
        "float32_fractional_padded": (
            padded_u8.float() + torch.rand(padded_u8.shape, generator=torch.Generator().manual_seed(2)).to(dev),
            SRC_HW,
        ),
    }
    # out-of-range view indices: a negative one counts from the end once, then all clamp
    idx_out = torch.tensor([-1, N_VIEWS, -N_VIEWS - 2, 2 * N_VIEWS + 1], device=dev)
    cases = {"n4": (x4, y4, idx), "n4_idx_out": (x4, y4, idx_out), "n96": (x96, y96, idx96)}
    cases.update(k1_edge_cases(x96, y96, idx96))
    max_err = 0.0
    for name, (images, valid_hw) in sources.items():
        for case, (xs, ys, ii) in cases.items():
            xs, ys = _probed(xs, ys, valid_hw or tuple(images.shape[1:]))
            for mode in row_modes(images.dtype):
                err = k1_error(images, ii, xs, ys, valid_hw, mode)
                if err > K1_TOL:
                    raise RuntimeError(f"K1 {name} {case} rows={mode}: max |err| {err} > {K1_TOL}")
                max_err = max(max_err, err)

    return dict(
        max_abs_err=max_err,
        cases=sorted(cases),
        n4=k1_timings(padded_u8, idx, x4, y4),
        n96=k1_timings(padded_u8, idx96, x96, y96),
    )


def k1_edge_cases(xs, ys, ii) -> dict:
    """K1's shapes and layouts off the main path, cut from (N, h, w) planes
    on the card: flat (N, P) planes (a gather's lanes on consecutive
    pixels) with P = 9,215 and 97, crop rows not a multiple of the 8-pixel
    patch (95 x 97), planes 4 bytes past a 16-byte boundary, one slot, and
    70,000 slots of 8 pixels (past the grid's 65,535 slots in y, where
    blocks stride over slots; view indices out of range as well)."""
    import torch

    n = xs.shape[0]
    fx, fy = xs.reshape(n, -1), ys.reshape(n, -1)
    many = torch.arange(70_000, device=xs.device)
    cols = (many[:, None] * 8 + torch.arange(8, device=xs.device)) % fx.numel()
    return {
        "flat_p9215": (fx[:, :9215].contiguous(), fy[:, :9215].contiguous(), ii),
        "flat_p97": (fx[:8, :97].contiguous(), fy[:8, :97].contiguous(), ii[:8]),
        "rows_95x97": (fx[:, : 95 * 97].reshape(n, 95, 97).contiguous(), fy[:, : 95 * 97].reshape(n, 95, 97).contiguous(), ii),
        "planes_offset": (at_offset(xs, 4), at_offset(ys, 4), ii),
        "n1": (xs[:1], ys[:1], ii[:1]),
        "n70000_p8": (fx.reshape(-1)[cols], fy.reshape(-1)[cols], ii[many % n] - many % 3),
    }


def at_offset(a, byte_offset: int):
    """A copy of ``a`` whose data starts ``byte_offset`` bytes past a
    16-byte boundary (the allocator's blocks start on one)."""
    import torch

    shift = byte_offset // a.element_size()
    buf = torch.empty(a.numel() + shift, dtype=a.dtype, device=a.device)
    return buf[shift:].view(a.shape).copy_(a)


def _probed(xs, ys, valid_hw):
    """Copies of the planes, at their alignment, with ``border_coords`` in
    the first pixels of slot 0 where the slot has room for them."""
    xs, ys = (at_offset(a, a.data_ptr() % 16) for a in (xs, ys))
    if xs[0].numel() >= len(border_coords(valid_hw)):
        _probe(xs, ys, valid_hw)
    return xs, ys


def row_modes(dtype) -> tuple:
    """K1's row-weight modes for a source type: f32 and bf16, and int8 for uint8."""
    import torch

    from absolutetrack_tpu_torch.ops import warp_kernel as wk

    return (wk.ROWS_F32, wk.ROWS_BF16) + ((wk.ROWS_INT8,) if dtype == torch.uint8 else ())


def k1_error(images, ii, xs, ys, valid_hw, row_mode=0) -> float:
    """Max |K1 - plain| on one call in one row-weight mode; raises on a
    non-finite output."""
    import torch

    from absolutetrack_tpu_torch.ops import warp_kernel

    got = warp_kernel.K1(images, ii, xs, ys, valid_hw, row_mode)
    want = warp_kernel.bilinear_sample_plain(images, ii, (xs, ys), valid_hw, row_mode)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"K1: non-finite output at N={xs.shape[0]} rows={row_mode}")
    return float((got - want).abs().max())


def k1_timings(images, ii, xs, ys, iters: int = 100) -> dict:
    """K1's device time at one shape (CUDA-graph replay) in its row-weight
    modes (int8 on uint8 views only), beside its bound, its plain version's time (f32 and
    bf16 rows) and ``grid_sample``'s, and the eager calls'."""
    import torch
    from torch.nn import functional as F

    from absolutetrack_tpu_torch.ops import warp_kernel

    n, p = xs.shape[0], xs[0].numel()
    h, w = SRC_HW
    k1 = lambda: warp_kernel.K1(images, ii, xs, ys, SRC_HW)  # noqa: E731
    k1_int8 = lambda: warp_kernel.K1(images, ii, xs, ys, SRC_HW, warp_kernel.ROWS_INT8)  # noqa: E731
    k1_bf16 = lambda: warp_kernel.K1(images, ii, xs, ys, SRC_HW, warp_kernel.ROWS_BF16)  # noqa: E731
    plain = lambda: warp_kernel.bilinear_sample_plain(images, ii, (xs, ys), SRC_HW)  # noqa: E731
    plain_bf16 = lambda: warp_kernel.bilinear_sample_plain(  # noqa: E731
        images, ii, (xs, ys), SRC_HW, warp_kernel.ROWS_BF16
    )
    # yardstick only: grid_sample blends border taps with zeros, so it is
    # not the same function at the border; the port never calls it
    lib_in = images[ii, :h, :w].float()[:, None].contiguous()
    gx, gy = xs.reshape(n, 1, p), ys.reshape(n, 1, p)
    grid = torch.stack([gx / (w - 1) * 2 - 1, gy / (h - 1) * 2 - 1], -1).contiguous()
    library = lambda: F.grid_sample(  # noqa: E731
        lib_in, grid, mode="bilinear", padding_mode="zeros", align_corners=True
    )
    # what the function must move: the view index and both coordinate
    # planes read once, the f32 output written once, and of the views
    # only the bytes that this run's taps touch (the padding and the
    # pixels outside every crop are never read); ~20 f32 operations a pixel
    source = touched_source_bytes(images, ii, xs, ys, SRC_HW)
    moved = source + ii.numel() * 8 + 3 * n * p * 4
    flops = 20 * n * p
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    few = max(iters // 5, 2)
    out = dict(
        ms=_device_ms(k1, iters), bf16_ms=_device_ms(k1_bf16, iters),
        int8_ms=_device_ms(k1_int8, iters) if images.dtype == torch.uint8 else None,  # int8 rows need uint8 views
        plain_ms=_device_ms(plain, few), bf16_plain_ms=_device_ms(plain_bf16, few),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=_device_ms(library, iters),
        call_ms=_call_ms(k1, 2 * iters), plain_call_ms=_call_ms(plain, few),
        library_call_ms=_call_ms(library, 2 * iters),
        bytes=moved, source_bytes=source, flops=flops,
    )
    del lib_in, grid
    torch.cuda.empty_cache()
    return out


def _run(tracker, ts, n_frames, feedback):
    return tracker.track_sequence(
        ts["frames"][:n_frames], ts["cameras"], ts["camera_to_world"][:n_frames],
        ts["camera_angles"], ts["hand_model"], ts["joint_angles"][:n_frames],
        ts["wrist_transforms"][:n_frames], ts["hand_confidences"][:n_frames],
        feedback=feedback,
    )


def stage_breakdown(tracker, ts, n_frames: int) -> dict:
    """Host-clock ms per frame of each stage of ``track_frame`` (crops from
    the given poses), with the device synchronised between stages."""
    import torch

    sync = torch.cuda.synchronize
    state = tracker.init_state()
    skel = tracker.skeleton_inputs(ts["hand_model"])
    total = dict(crop_slots=0.0, warp_and_inputs=0.0, network=0.0, finish=0.0)
    for t in range(n_frames):
        cams = ts["cameras"]._replace(T_world_from_eye=ts["camera_to_world"][t])
        sync()
        t0 = time.perf_counter()
        slots = tracker.crop_slots(
            cams, ts["camera_angles"], ts["hand_model"], ts["joint_angles"][t],
            ts["wrist_transforms"][t], ts["hand_confidences"][t],
        )
        sync()
        t1 = time.perf_counter()
        frame = tracker.make_inputs(state, ts["frames"][t], cams, slots)
        sync()
        t2 = time.perf_counter()
        new_temporal, out = tracker.model.regress_pose_use_skeleton(state.temporal, frame, skel)
        sync()
        t3 = time.perf_counter()
        state, _ = tracker._finish(state, new_temporal, slots, out)
        sync()
        t4 = time.perf_counter()
        for key, dt in zip(total, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            total[key] += dt
    return {k: v / n_frames * 1e3 for k, v in total.items()}


def device_busy(run, n_frames: int) -> dict:
    """Kernel time and kernel count a frame, summed over a ``torch.profiler``
    trace of ``run()``, which tracks ``n_frames`` frames on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    return dict(
        device_busy_ms_per_frame=sum(e.self_device_time_total for e in kernels) / n_frames / 1e3,
        kernels_per_frame=sum(e.count for e in kernels) / n_frames,
    )


def path_phase(scene: dict, ts: dict, seed: int) -> dict:
    """Track at full ``ModelConfig()`` width on the card: tracked-pose
    feedback with K1's launches counted, then crops from given poses held
    against the port's own CPU run."""
    import torch

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.ops import warp_kernel
    from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig

    set_conv_precision("highest")  # parity mode: no TF32 in convs or matmuls
    cfg = ModelConfig()
    opts = TrackerConfig(crop_size=cfg.input_size, src_valid_hw=SRC_HW)
    model = UmeTrackModel(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    tracker = HandTracker(with_pose_prior(model, ts, opts.crop_size), opts)

    _run(tracker, ts, 4, True)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    warp_kernel.K1.reset_counts()
    t0 = time.perf_counter()
    _, res = _run(tracker, ts, FEEDBACK_FRAMES, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = warp_kernel.K1.launches
    if launches != FEEDBACK_FRAMES:
        raise RuntimeError(f"K1 launched {launches} times over {FEEDBACK_FRAMES} frames")
    for name, value in res._asdict().items():
        if value.is_floating_point() and not torch.isfinite(value).all():
            raise RuntimeError(f"feedback run: non-finite {name}")
    full = int((res.hand_valid.all(dim=1) & (res.num_views == 2).all(dim=1)).sum())
    if full < 0.75 * FEEDBACK_FRAMES:
        raise RuntimeError(f"both hands valid with 2 views on only {full}/{FEEDBACK_FRAMES} frames")
    # the spread: the same run twice more, outside the counted one
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        _run(tracker, ts, FEEDBACK_FRAMES, True)
        torch.cuda.synchronize()
        repeats.append((time.perf_counter() - t0) / FEEDBACK_FRAMES * 1e3)
    stages = stage_breakdown(tracker, ts, GIVEN_POSE_FRAMES)
    busy = device_busy(lambda: _run(tracker, ts, GIVEN_POSE_FRAMES, True), GIVEN_POSE_FRAMES)

    # crops from the given poses: this device against the CPU (plain sampler)
    net = damped(model)
    _, r_dev = _run(HandTracker(net, opts), ts, GIVEN_POSE_FRAMES, False)
    _, r_cpu = _run(HandTracker(copy.deepcopy(net).to("cpu"), opts), torch_scene(scene, "cpu"), GIVEN_POSE_FRAMES, False)
    r_dev = type(r_dev)(*(v.cpu() for v in r_dev))
    if not torch.equal(r_dev.hand_valid, r_cpu.hand_valid):
        raise RuntimeError("hand validity differs between the card and the CPU")
    valid = r_cpu.hand_valid
    if not valid.any():
        raise RuntimeError("no valid hand in the given-pose run")
    lm_err = float((r_dev.tracked_keypoints - r_cpu.tracked_keypoints).norm(dim=-1)[valid].max())
    ja_err = float((r_dev.joint_angles - r_cpu.joint_angles).abs()[valid].max())
    if lm_err > LANDMARK_TOL_MM or ja_err > ANGLE_TOL:
        raise RuntimeError(f"card vs CPU: landmarks {lm_err} mm, joint angles {ja_err}")
    return dict(
        frames=FEEDBACK_FRAMES,
        ms_per_frame=wall / FEEDBACK_FRAMES * 1e3,
        frames_per_s=FEEDBACK_FRAMES / wall,
        ms_per_frame_repeats=repeats,
        **busy,
        k1_launches=launches,
        frames_both_hands_2_views=full,
        stage_ms_per_frame=stages,
        given_pose_frames=GIVEN_POSE_FRAMES,
        landmark_max_err_mm=lm_err,
        joint_angle_max_err=ja_err,
    )


class _RecordCalls:
    """Stands in for K1 and records each call's arguments."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.kernel(*args)


def _stage_ms(run, n_chunks: int) -> dict:
    """Host-clock ms per chunk of each stage of the lockstep, the device
    synchronised at every stage's end (``stage_hook``); ``readback`` is the
    copy of every chunk's results to the host after the last chunk."""
    import torch

    total = {}
    last = [0.0]

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        total[name] = total.get(name, 0.0) + now - last[0]
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    run(stage_hook=hook)
    total["readback"] = time.perf_counter() - last[0]
    return {k: v / n_chunks * 1e3 for k, v in total.items()}


def _chunk_trace(run) -> dict:
    """Device time of one chunk by ``torch.profiler``: the sum of every
    device activity, K1's share and the five largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(max_frames=LOCKSTEP_CHUNK)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    events.sort(key=lambda e: -e.self_device_time_total)
    return dict(
        device_busy_ms=sum(e.self_device_time_total for e in events) / 1e3,
        device_activities=sum(e.count for e in events),
        k1_ms=sum(e.self_device_time_total for e in events if "bilinear_sample" in e.key) / 1e3,
        top=[(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in events[:5]],
    )


def _result_errors(a, b) -> tuple:
    """(landmark mm, joint angle rad) between two SequenceResults, where valid."""
    if not np.array_equal(a.valid_tracking, b.valid_tracking):
        raise RuntimeError("hand validity differs")
    v = a.valid_tracking
    if not v.any():
        raise RuntimeError("no valid hand to compare")
    lm = float(np.linalg.norm(a.tracked_keypoints - b.tracked_keypoints, axis=-1)[v].max())
    ja = float(np.abs(a.joint_angles - b.joint_angles)[v].max())
    return lm, ja


def lockstep_phase(seed: int) -> dict:
    """The pipelined lockstep eval at full ``ModelConfig()`` width with TF32
    off: 24 recordings of 16 frames (each from its own start frame of one
    scene) through ``eval_lib.track_recordings_batched(pipelined=True,
    chunk_size=8)``, two chunks of 768 crop slots, K1 once a chunk; its
    spread, stages and device time; K1 at the chunk's own coordinates
    against its plain version (and at 1,024 slots, where the TPU cuts
    slabs); and the results against the port's sequential tracker on the
    card and against the port's CPU run."""
    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.ops import warp_kernel

    set_conv_precision("highest")
    r, n, chunk = LOCKSTEP_RECORDINGS, LOCKSTEP_FRAMES, LOCKSTEP_CHUNK
    n_chunks = n // chunk
    scene = build_scene(seed + 1, n_frames=n + r - 1)
    recordings = scene_recordings(scene, range(r), n)
    cfg = ModelConfig()
    net = damped(UmeTrackModel(cfg, device="cuda", generator=torch.Generator().manual_seed(seed)))

    def run(recs=recordings, model=net, **kw):
        return eval_lib.track_recordings_batched(model, recs, chunk_size=chunk, pipelined=True, **kw)

    run(max_frames=chunk)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    warp_kernel.K1.reset_counts()
    t0 = time.perf_counter()
    results = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = warp_kernel.K1.launches, dict(warp_kernel.K1.shapes)
    p = cfg.input_size[0] * cfg.input_size[1]
    if launches != n_chunks or shapes != {(LOCKSTEP_SLOTS, p): n_chunks}:
        raise RuntimeError(f"K1 launches {launches} by shape {shapes}; want {n_chunks} at N={LOCKSTEP_SLOTS}")
    for res in results:
        for name, value in vars(res).items():
            if value is not None and not np.isfinite(value).all():
                raise RuntimeError(f"lockstep: non-finite {name}")
        if res.tracked_keypoints.shape != (2, n, 21, 3) or not res.valid_tracking.all():
            raise RuntimeError("lockstep: wrong shape, or a hand lost on a clean scene")
    repeats = []
    for _ in range(2):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        repeats.append(r * n / (time.perf_counter() - t1))
    stages = _stage_ms(run, n_chunks)
    trace = _chunk_trace(run)

    # K1 at the chunk's own coordinates: one chunk with K1's calls recorded
    recorder = _RecordCalls(warp_kernel.K1)
    warp_kernel.K1 = recorder
    try:
        run(max_frames=chunk)
    finally:
        warp_kernel.K1 = recorder.kernel
    images, ii, xs, ys, valid_hw, _ = recorder.calls[0]
    del recorder
    errs = {}
    for name, (idx, x, y) in {
        "n768": (ii, xs, ys),
        # 1,024 slots (32 recordings), where the TPU cuts the call into slabs
        "n1024": tuple(torch.cat([a, a[:256]]).contiguous() for a in (ii, xs, ys)),
    }.items():
        errs[name] = max(k1_error(images, idx, x, y, valid_hw, mode) for mode in row_modes(images.dtype))
        if errs[name] > K1_TOL:
            raise RuntimeError(f"K1 at {name}: max |err| {errs[name]} > {K1_TOL}")
    # the bf16 rows on f32 and bf16 views as well, at the chunk's coordinates
    errs["n768_bf16_rows_f32_bf16_views"] = max(
        k1_error(images.to(dtype), ii, xs, ys, valid_hw, warp_kernel.ROWS_BF16)
        for dtype in (torch.float32, torch.bfloat16)
    )
    if errs["n768_bf16_rows_f32_bf16_views"] > K1_TOL:
        raise RuntimeError(f"K1 bf16 rows at N=768: max |err| {errs['n768_bf16_rows_f32_bf16_views']} > {K1_TOL}")
    k1 = dict(
        k1_timings(images, ii, xs, ys, iters=20), max_abs_err=errs["n768"], n1024_max_abs_err=errs["n1024"],
        bf16_rows_f32_bf16_views_max_abs_err=errs["n768_bf16_rows_f32_bf16_views"],
    )
    del images, ii, xs, ys
    torch.cuda.empty_cache()

    # each checked recording alone through the sequential per-frame tracker
    seq = {}
    for i in SEQUENTIAL_CHECKED:
        labels, frames = recordings[i]
        alone = eval_lib.track_recording(net, labels, frames, chunk_size=chunk, pipelined=False)
        seq[i] = _result_errors(alone, results[i])
    seq_lm, seq_ja = max(e[0] for e in seq.values()), max(e[1] for e in seq.values())
    if seq_lm > LANDMARK_TOL_MM or seq_ja > ANGLE_TOL:
        raise RuntimeError(f"lockstep vs sequential: landmarks {seq_lm} mm, joint angles {seq_ja}")

    # the card against the port's CPU run, CPU_CHECKED recordings of one chunk
    few = recordings[:CPU_CHECKED]
    card = run(few, max_frames=chunk)
    cpu = run(few, model=copy.deepcopy(net).to("cpu"), max_frames=chunk)
    cpu_errs = [_result_errors(a, b) for a, b in zip(card, cpu)]
    cpu_lm, cpu_ja = max(e[0] for e in cpu_errs), max(e[1] for e in cpu_errs)
    if cpu_lm > LANDMARK_TOL_MM or cpu_ja > ANGLE_TOL:
        raise RuntimeError(f"lockstep card vs CPU: landmarks {cpu_lm} mm, joint angles {cpu_ja}")

    return dict(
        recordings=r,
        frames_per_recording=n,
        chunk=chunk,
        frames_per_s=r * n / wall,
        wall_s=wall,
        frames_per_s_repeats=repeats,
        k1_launches=launches,
        k1_slots_per_launch=LOCKSTEP_SLOTS,
        stage_ms_per_chunk=stages,
        chunk_trace=trace,
        k1_n768=k1,
        sequential_checked=list(SEQUENTIAL_CHECKED),
        vs_sequential_landmark_max_err_mm=seq_lm,
        vs_sequential_joint_angle_max_err=seq_ja,
        cpu_checked_recordings=CPU_CHECKED,
        vs_cpu_landmark_max_err_mm=cpu_lm,
        vs_cpu_joint_angle_max_err=cpu_ja,
    )


def demo_inputs(seed: int, n_frames: int):
    """The demo's replay, as ``apps/demo/main.py`` builds it, from the
    scene with its box-mesh hand: (labels, the stereo pair's cameras, and
    per frame the (2, 480, 636) uint8 mono views, their RGB copies and the
    GT keypoints' (2, 2, 21, 2) slots and validity), rendered up front."""
    from absolutetrack_tpu_torch.apps.demo.detector_2d import keypoints_to_slots
    from absolutetrack_tpu_torch.apps.demo.main import STEREO_VIEWS, replay_from_labels, stereo_pair
    from absolutetrack_tpu_torch.tracker.video_data import labels_from_json

    labels = labels_from_json(labels_json(build_scene(seed, n_frames=n_frames, mesh=True)))
    frames, detector = replay_from_labels(labels, n_frames)
    out = []
    for mono, rgb in stereo_pair(frames):
        kp, valid = keypoints_to_slots([detector.detect(rgb[v], v) for v in range(2)])
        detector.advance()
        out.append((mono, rgb, kp, valid))
    stereo = labels.cameras_at(0).map(lambda x: x[list(STEREO_VIEWS)])
    return labels, stereo, detector.sequence, out


def _demo_steps(live, inputs) -> tuple:
    """``live`` over ``inputs`` from a reset state -> (host ms a frame, the
    per-frame keypoint dicts, the per-frame results on the device)."""
    import torch

    live.reset()
    if live.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, results = [], []
    for mono, _, kp, valid in inputs:
        outs.append(live(mono, kp, valid))  # ends in the frame's blocking readback
        results.append(live.last_result)
    return (time.perf_counter() - t0) / len(inputs) * 1e3, outs, results


def _demo_errors(a_outs, a_res, b_outs, b_res) -> tuple:
    """(landmark mm, joint angle rad) between two runs of the demo, hand by hand."""
    lm, ja = 0.0, 0.0
    for oa, ra, ob, rb in zip(a_outs, a_res, b_outs, b_res):
        if sorted(oa) != sorted(ob):
            raise RuntimeError(f"tracked hands differ: {sorted(oa)} vs {sorted(ob)}")
        for h in oa:
            lm = max(lm, float(np.linalg.norm(oa[h] - ob[h], axis=-1).max()))
            ja = max(ja, float((ra.joint_angles[h].cpu() - rb.joint_angles[h].cpu()).abs().max()))
    return lm, ja


def _wrist_angle_errors(a_res, b_res) -> tuple:
    """(wrist translation mm, joint angle rad) max errors of two runs' results,
    and the scales of ``a_res``: its largest translation and max(|angle|, 1)."""
    import torch

    ta, tb = (torch.stack([r.wrist_xfs[:, :3, 3] for r in res]).cpu() for res in (a_res, b_res))
    aa, ab = (torch.stack([r.joint_angles for r in res]).cpu() for res in (a_res, b_res))
    return (
        float((ta - tb).abs().max()), float((aa - ab).abs().max()),
        float(ta.abs().max()), max(float(aa.abs().max()), 1.0),
    )


def _bf16_agreement(a, b) -> tuple:
    """(share of bit-equal elements, largest difference in units of the
    bf16 spacing at ``b``) of two tensors of bf16 values."""
    import torch

    a, b = a.float().cpu(), b.float().cpu()
    _, e = torch.frexp(b)
    spacing = torch.ldexp(torch.ones_like(b), e - 8)  # bf16 keeps 8 significant bits
    return float((a == b).float().mean()), float(((a - b).abs() / spacing).max())


def serving_stages(card_net, cpu_net, f32_net, live, frame_input) -> dict:
    """One demo frame from a reset state through the serving network on
    the card and through the port's CPU copy on the card's own inputs.

    Conv by conv: each conv's bf16 output on the card against the CPU
    copy's on the card's input to that conv (share bit-equal, largest
    difference in bf16 spacings), and the same convs computed in f32 on
    the same bf16 values, bias included, and rounded once at the end (what
    a conv that rounds at other places than JAX's ``conv(x, w) + b`` gives).
    Whole stages: the trunk's bf16 features and, from the card's features,
    the tail's f32 outputs; the f32 trunk's features rounded to bf16 give
    the share that a trunk computing in f32 reaches."""
    import torch
    from torch.nn import functional as F

    from absolutetrack_tpu_torch.models.layers import Conv2d
    from absolutetrack_tpu_torch.models.umetrack import FrameInputs, SkeletonInputs
    from absolutetrack_tpu_torch.tracker.crop_gen import gen_crop_slots_from_2d

    tr, dev = live.tracker, card_net.device
    mono, _, kp, valid = frame_input
    slots = gen_crop_slots_from_2d(
        live.cameras, torch.from_numpy(kp).to(dev), torch.from_numpy(valid).to(dev),
        tr.opts.crop_size, focal_multiplier=tr.opts.hand_ratio_in_crop,
    )
    state = tr.init_state().temporal
    frame = tr.make_inputs(tr.init_state(), torch.from_numpy(mono).to(dev), live.cameras, slots)
    skel = tr.skeleton_inputs(live.hand_model_mm)
    cpu_frame = FrameInputs(*(x.cpu() for x in frame))
    cpu_state = type(state)(*(x.cpu() for x in state))
    cpu_skel = SkeletonInputs(*(x.cpu() for x in skel))
    convs = {name: m for name, m in card_net.named_modules() if isinstance(m, Conv2d)}
    seen = {}

    def record(name):
        def hook(_module, inputs, output):
            seen.setdefault(name, (inputs[0], output))  # a hook that returns None keeps the output

        return hook

    hooks = [m.register_forward_hook(record(name)) for name, m in convs.items()]
    try:
        with torch.no_grad():
            card = card_net.extract_features(frame)
            n = card.shape[0]
            _, out_card = card_net.regress_from_features(state, frame, card, card_net.encode_skeleton(skel, n))
    finally:
        for h in hooks:
            h.remove()
    cpu_convs = dict(cpu_net.named_modules())
    per_conv, once = {}, {}
    with torch.no_grad():
        cpu = cpu_net.extract_features(cpu_frame)
        f32 = f32_net.extract_features(frame).to(torch.bfloat16)
        _, out_cpu = cpu_net.regress_from_features(cpu_state, cpu_frame, card.cpu(), cpu_net.encode_skeleton(cpu_skel, n))
        for name, (x, y) in seen.items():
            if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
                raise RuntimeError(f"serving conv {name}: {x.dtype} in, {y.dtype} out on the card")
            m = convs[name]
            want = cpu_convs[name](x.cpu())
            per_conv[name] = _bf16_agreement(y, want)
            f32_conv = F.conv2d(x.float(), m.weight.float(), m.bias.float(), m.stride, m.padding)
            once[name] = _bf16_agreement(f32_conv.to(torch.bfloat16), want)
    equal, spacings = _bf16_agreement(card, cpu)
    f32_equal, f32_spacings = _bf16_agreement(f32, cpu)
    worst = min(per_conv, key=lambda k: per_conv[k][0])
    return dict(
        convs=len(per_conv),
        conv_min_bit_equal_share=per_conv[worst][0],
        conv_min_bit_equal_share_at=worst,
        conv_max_diff_bf16_spacings=max(v[1] for v in per_conv.values()),
        rounded_once_conv_min_bit_equal_share=min(v[0] for v in once.values()),
        trunk_features=int(card.numel()),
        trunk_bit_equal_share=equal,
        trunk_max_diff_bf16_spacings=spacings,
        f32_trunk_bit_equal_share=f32_equal,
        f32_trunk_max_diff_bf16_spacings=f32_spacings,
        tail_wrist_max_err_mm=float((out_card.wrist_xfs[:, :3, 3].cpu() - out_cpu.wrist_xfs[:, :3, 3]).abs().max()) * 1e3,
        tail_joint_angle_max_err=float((out_card.joint_angles.cpu() - out_cpu.joint_angles).abs().max()),
    )


def with_biases(model, seed: int, std: float = 0.05):
    """``model`` with N(0, std) conv biases, drawn from ``seed`` (the init
    zeroes them), so that where a bias add rounds shows in the serving checks."""
    import torch

    from absolutetrack_tpu_torch.models.layers import Conv2d

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                m.bias.copy_(std * torch.randn(m.bias.shape, generator=g))
    return model


def reference_state_dict(cfg, seed: int = 0, head_scale: float = 0.02, memory_scale: float = 0.1) -> dict:
    """A seeded state dict with the reference checkpoint's names and shapes
    for ``cfg`` (the inverse of ``models/weights.py``'s naming): He-normal
    convs, no bias on the ResNet convs (as torchvision's) and N(0, 0.05)
    biases elsewhere, BatchNorms with nonzero statistics and positive
    variances. As ``damped`` does, the regression heads' output convs are
    drawn ``head_scale`` times smaller and the ConvRNN ``memory_scale``
    times; the unknown-skeleton head's bias also holds the wrist template
    (a trained head predicts well-spread wrist points), so pass 1's scales
    stay near 1."""
    import torch

    from absolutetrack_tpu_torch.models.params import export_jax_params
    from absolutetrack_tpu_torch.models.regressor import output_dims, wrist_rigid_template
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel

    tree = export_jax_params(UmeTrackModel(cfg, device="cpu"))
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(shape, std):
        return std * torch.randn(shape, generator=g)

    def conv(prefix, p, bias=True, scale=1.0):
        kh, kw, i, o = p["w"].shape
        sd[prefix + ".weight"] = normal((o, i, kh, kw), scale * math.sqrt(2.0 / (kh * kw * o)))
        if bias:
            sd[prefix + ".bias"] = normal((o,), 0.05 * scale)

    def bn(prefix, n):
        sd[prefix + ".weight"] = 1.0 + normal((n,), 0.1)
        sd[prefix + ".bias"] = normal((n,), 0.1)
        sd[prefix + ".running_mean"] = normal((n,), 0.1)
        sd[prefix + ".running_var"] = 0.5 + torch.rand((n,), generator=g)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(1000)

    def conv_bn(conv_prefix, bn_prefix, p, bias=False):
        conv(conv_prefix, p, bias)
        bn(bn_prefix, p["w"].shape[-1])

    def block(prefix, p):
        conv_bn(prefix + ".conv1", prefix + ".bn1", p["conv1"])
        conv_bn(prefix + ".conv2", prefix + ".bn2", p["conv2"])
        if "downsample" in p:
            conv_bn(prefix + ".downsample.0", prefix + ".downsample.1", p["downsample"])

    root = "_feature_extractor._image_backbone"
    conv_bn(f"{root}.0._layers.0.0", f"{root}.0._layers.0.1", tree["backbone"]["stem"])
    for si in range(4):
        for bi, p in enumerate(tree["backbone"][f"stage{si}"]):
            block(f"{root}.0._layers.{si + 1}.{bi}", p)
    conv(f"{root}.1", tree["backbone"]["proj"])
    root = "_feature_extractor._multi_view_fusion"
    for i, p in enumerate(tree["fusion"]["blocks"]):
        conv_bn(f"{root}.{3 * i}", f"{root}.{3 * i + 1}", p, bias=True)
    conv(f"{root}.{3 * len(tree['fusion']['blocks'])}", tree["fusion"]["final"])
    for i, p in enumerate(tree["temporal"]["blocks"]):
        conv(f"_temporal._temporal_module.{2 * i}", p, scale=memory_scale)
    n_in, n_out = tree["skeleton_encoder"]["fc"]["w"].shape
    sd["_skeleton_enc._layers.0.weight"] = normal((n_out, n_in), math.sqrt(1.0 / n_in))
    sd["_skeleton_enc._layers.0.bias"] = normal((n_out,), 0.05)
    bn("_skeleton_enc._layers.2", cfg.n_skeleton_feature_channels)
    for which in ("k", "u"):
        root = f"_regressor_{which}._pose_regression_layers"
        reg = tree[f"regressor_{which}"]
        for i, p in enumerate(reg["blocks"]):
            block(f"{root}.{i}", p)
        conv(f"{root}.{len(reg['blocks'])}", reg["out"], scale=head_scale)
    r = output_dims(True, cfg.n_wrist_rigid_pts)[0]["wrist_xfs"]
    out_bias = sd[f"_regressor_u._pose_regression_layers.{cfg.n_pose_regression_blocks}.bias"]
    out_bias[r[0] : r[1]] += torch.from_numpy(wrist_rigid_template(cfg.n_wrist_rigid_pts).reshape(-1))
    return sd


def demo_phase(seed: int) -> dict:
    """The live demo in replay mode at full width on the card, parity and
    serving, and its checks (see the module's docstring)."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import torch

    from absolutetrack_tpu_torch.apps.demo import main as demo_main
    from absolutetrack_tpu_torch.apps.demo.detector_2d import ReplayDetector
    from absolutetrack_tpu_torch.apps.demo.pipeline import DemoConfig, LiveTracker, run_pipeline
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.ops import warp_kernel

    set_conv_precision("highest")  # f32 parts without TF32 in both runs
    n, warm = DEMO_FRAMES, DEMO_WARMUP
    labels, stereo, sequence, inputs = demo_inputs(seed, warm + n)
    warmup, counted = inputs[:warm], inputs[warm:]
    parity_net = damped(with_biases(UmeTrackModel(ModelConfig(), device="cuda", generator=torch.Generator().manual_seed(seed)), seed))
    serving_net = UmeTrackModel(ModelConfig.serving(), device="cuda", generator=torch.Generator().manual_seed(seed))
    serving_net.load_state_dict(parity_net.state_dict())  # the same weights, rounded to bf16 once
    p = ModelConfig().input_size[0] * ModelConfig().input_size[1]

    runs = {}
    # the serving model's tracker samples with bf16 rows, the parity model's with f32 rows
    for name, net, mode in (("parity", parity_net, "f32"), ("serving", serving_net, "bf16")):
        live = LiveTracker(net, labels.hand_model, cameras=stereo)
        _demo_steps(live, warmup)  # cuDNN plans, the allocator
        warp_kernel.K1.reset_counts()
        ms, outs, results = _demo_steps(live, counted)
        launches, shapes, modes = warp_kernel.K1.launches, dict(warp_kernel.K1.shapes), dict(warp_kernel.K1.modes)
        if launches != n or shapes != {(4, p): n} or modes != {mode: n}:
            raise RuntimeError(f"demo {name}: K1 launches {launches}, shapes {shapes}, modes {modes}; want {n} {mode} at N=4")
        valid = torch.stack([r.hand_valid for r in results]).cpu()
        for r in results:
            for field in ("joint_angles", "wrist_xfs"):
                if not torch.isfinite(getattr(r, field)).all():
                    raise RuntimeError(f"demo {name}: non-finite {field}")
        if not valid.all() or any(sorted(o) != [0, 1] for o in outs):
            raise RuntimeError(f"demo {name}: a hand was lost on a clean replay")
        repeats = [_demo_steps(live, counted)[0] for _ in range(2)]
        live.reset()
        det = ReplayDetector(sequence[warm:])
        t0 = time.perf_counter()
        run_pipeline(
            ((mono, rgb) for mono, rgb, _, _ in counted), det, live, DemoConfig(send_udp=False), max_frames=n
        )
        pipeline_ms = (time.perf_counter() - t0) / n * 1e3
        busy = device_busy(lambda: _demo_steps(live, counted[:GIVEN_POSE_FRAMES]), GIVEN_POSE_FRAMES)
        runs[name] = dict(
            live=live, outs=outs, results=results,
            report=dict(
                frames=n, step_ms_per_frame=ms, step_ms_per_frame_repeats=repeats,
                pipeline_ms_per_frame=pipeline_ms, **busy,
                k1_launches=launches, k1_slots_per_launch=4, k1_row_mode=mode,
            ),
        )

    # parity: the card against the port's CPU run
    par = runs["parity"]
    few = counted[:DEMO_CPU_FRAMES]
    cpu = LiveTracker(copy.deepcopy(parity_net).to("cpu"), labels.hand_model, cameras=stereo)
    _, cpu_outs, cpu_res = _demo_steps(cpu, few)
    lm_err, ja_err = _demo_errors(par["outs"][: len(few)], par["results"][: len(few)], cpu_outs, cpu_res)
    if lm_err > LANDMARK_TOL_MM or ja_err > ANGLE_TOL:
        raise RuntimeError(f"demo card vs CPU: landmarks {lm_err} mm, joint angles {ja_err}")

    # serving against parity on the card, TestServingPrecision's relative budget
    ser = runs["serving"]
    dt, da, scale_t, scale_a = _wrist_angle_errors(par["results"], ser["results"])
    if not dt < SERVING_TRANSLATION_REL * scale_t or not da < SERVING_ANGLE_REL * scale_a:
        raise RuntimeError(f"serving vs parity: wrist {dt} mm of {scale_t}, angles {da} of {scale_a}")
    if any(r.wrist_xfs.dtype != torch.float32 or r.joint_angles.dtype != torch.float32 for r in ser["results"]):
        raise RuntimeError("serving outputs are not f32")

    # serving: the card against the port's CPU run, which rounds as JAX's
    # serving model does op by op (tests/test_torch_serving.py)
    cpu = LiveTracker(copy.deepcopy(serving_net).to("cpu"), labels.hand_model, cameras=stereo)
    _, cpu_outs, cpu_res = _demo_steps(cpu, few)
    s_lm, _ = _demo_errors(ser["outs"][: len(few)], ser["results"][: len(few)], cpu_outs, cpu_res)
    s_dt, s_da, _, _ = _wrist_angle_errors(ser["results"][: len(few)], cpu_res)
    if not s_dt < SERVING_CPU_WRIST_MM or not s_da < SERVING_CPU_ANGLE:
        raise RuntimeError(f"serving card vs CPU: wrist {s_dt} mm, joint angles {s_da}")
    stages = serving_stages(serving_net, cpu.tracker.model, parity_net, ser["live"], counted[0])
    if (
        not stages["conv_min_bit_equal_share"] >= SERVING_CONV_BIT_EQUAL
        or not stages["tail_wrist_max_err_mm"] < SERVING_TAIL_WRIST_MM
        or not stages["tail_joint_angle_max_err"] < SERVING_TAIL_ANGLE
    ):
        raise RuntimeError(f"serving stages, card vs CPU: {stages}")

    # one replay through the CLI, the labels written as a recording's JSON
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "labels.json"
        path.write_text(json.dumps(labels_json(build_scene(seed, n_frames=DEMO_CLI_FRAMES, mesh=True))))
        out = io.StringIO()
        with redirect_stdout(out):
            demo_main.main([
                "--source", "replay", "--labels", str(path), "--max-frames", str(DEMO_CLI_FRAMES),
                "--no-udp", "--torch-device", "cuda",
            ])
    cli_lines = [line for line in out.getvalue().splitlines() if line.startswith("frame ")]
    if len(cli_lines) != DEMO_CLI_FRAMES or "hands=[0, 1]" not in cli_lines[-1]:
        raise RuntimeError(f"demo CLI: {out.getvalue()!r}")
    cli_s = time.perf_counter() - t0

    for r in runs.values():
        del r["live"]
    return dict(
        views="scene views 1-2 (rolled 90 deg), 480x636 uint8, box-mesh hand, GT 2D keypoints",
        warmup_frames=warm,
        parity=runs["parity"]["report"],
        serving=runs["serving"]["report"],
        cpu_checked_frames=len(few),
        vs_cpu_landmark_max_err_mm=lm_err,
        vs_cpu_joint_angle_max_err=ja_err,
        serving_vs_parity_wrist_max_err_mm=dt,
        serving_vs_parity_wrist_scale_mm=scale_t,
        serving_vs_parity_joint_angle_max_err=da,
        serving_vs_parity_angle_scale=scale_a,
        serving_vs_cpu_landmark_max_err_mm=s_lm,
        serving_vs_cpu_wrist_max_err_mm=s_dt,
        serving_vs_cpu_joint_angle_max_err=s_da,
        serving_stages_vs_cpu=stages,
        cli_frames=len(cli_lines),
        cli_s=cli_s,
        cli_last_line=cli_lines[-1],
    )


def protocol_tree(root: Path, scene: dict, n_recordings: int, length: int) -> tuple:
    """Write the eval protocol's inputs under ``root``: a label tree
    ``data/testing/user00/recording_0{i}.json`` of ``n_recordings``
    recordings of ``length`` frames, recording i starting at frame i of
    the scene, and the scene's hand model as the generic hand-model JSON.
    Returns (the tree's root, the hand model's path)."""
    user = root / "data" / "testing" / "user00"
    user.mkdir(parents=True, exist_ok=True)
    for i in range(n_recordings):
        (user / f"recording_{i:02d}.json").write_text(json.dumps(labels_json(scene, i, length)))
    generic = root / "generic_hand_model.json"
    generic.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
    return root / "data", generic


def read_results(out_dir) -> dict:
    """The eval apps' result pickles under ``out_dir``, by relative name."""
    import pickle

    out_dir = Path(out_dir)
    return {str(p.relative_to(out_dir)): pickle.loads(p.read_bytes()) for p in sorted(out_dir.rglob("*.npy"))}


def results_error(a: dict, b: dict) -> float:
    """The largest tracked-landmark distance (mm) between two runs' results,
    over each recording's frames that both hold, where valid; raises when
    the recordings or their validity differ."""
    if sorted(a) != sorted(b):
        raise RuntimeError(f"result sets differ: {sorted(a)} vs {sorted(b)}")
    err = 0.0
    for name in a:
        n = min(a[name]["valid_tracking"].shape[1], b[name]["valid_tracking"].shape[1])
        va, vb = a[name]["valid_tracking"][:, :n], b[name]["valid_tracking"][:, :n]
        if not np.array_equal(va, vb) or not va.any():
            raise RuntimeError(f"{name}: validity differs, or no valid hand")
        d = np.linalg.norm(a[name]["tracked_keypoints"][:, :n] - b[name]["tracked_keypoints"][:, :n], axis=-1)
        err = max(err, float(d[va].max()))
    return err


def protocol_phase(seed: int, device: str = "cuda", n_frames: int = PROTOCOL_FRAMES, tiny: bool = False) -> dict:
    """The eval protocol from a checkpoint file to the metrics table, at
    full ``ModelConfig()`` width on the card (``tiny`` and ``device="cpu"``:
    its CPU rehearsal): a reference-named state dict written as a zip
    ``.pt``, read through ``build_model``, saved with ``save_params`` and
    read back bit-equal; both eval CLIs over a label tree of
    ``PROTOCOL_RECORDINGS`` recordings (known skeleton one recording at a
    time and four in lockstep, unknown skeleton in lockstep with the mean
    and the Gauss-Newton calibration); ``load_eval.aggregate_metrics`` of
    each; lockstep against sequential; on the card also one recording
    against the port's CPU run, the GN windows card against CPU, a serving
    run (K1's bf16 rows) and K1 at the protocol's shapes against its plain
    version, with K1's launches counted from 0 before each CLI run."""
    import tempfile

    import torch

    from absolutetrack_tpu_torch.apps import calibration, eval_lib, load_eval
    from absolutetrack_tpu_torch.apps import run_eval_known_skeleton as known
    from absolutetrack_tpu_torch.apps import run_eval_unknown_skeleton as unknown
    from absolutetrack_tpu_torch.models.checkpoint import load_params, save_params
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.params import load_jax_params
    from absolutetrack_tpu_torch.ops import warp_kernel

    on_card = device == "cuda"
    r = PROTOCOL_RECORDINGS
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    p = cfg.input_size[0] * cfg.input_size[1]
    chunks = -(-n_frames // LOCKSTEP_CHUNK)
    calib_chunks = -(-min(calibration.CALIB_FRAMES, n_frames) // LOCKSTEP_CHUNK)
    slots = LOCKSTEP_CHUNK * 4  # a recording's crop slots a chunk
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # 1. the checkpoint: reference names -> .pt -> build_model -> save_params -> load_params
        pt = root / "reference.pt"
        torch.save(reference_state_dict(cfg, seed), pt)
        model = eval_lib.build_model(str(pt), cfg, device=device)
        native = root / "params.msgpack"
        save_params(str(native), model)
        back = load_jax_params(load_params(str(native), cfg), cfg, device=device)
        mine, theirs = model.state_dict(), back.state_dict()
        if sorted(mine) != sorted(theirs) or not all(torch.equal(mine[k], theirs[k]) for k in mine):
            raise RuntimeError("the weights read back from save_params are not bit-equal")
        del model, back, mine, theirs

        # 2. the label tree
        data, generic_path = protocol_tree(root, build_scene(seed, n_frames + r - 1, mesh=True), r, n_frames)
        arch = ["--tiny-arch"] if tiny else []
        runs = {}

        def run(name, module, argv, tracked, expect_launches):
            out = root / name
            warp_kernel.K1.reset_counts()
            clock = _RenderClock(eval_lib)
            with clock:
                wall, lines, _ = _cli(module, ["--output-dir", str(out), "--checkpoint", str(pt), "--override"] + arch + argv)
            shapes, modes = dict(warp_kernel.K1.shapes), dict(warp_kernel.K1.modes)
            if on_card:  # the card's f32 model samples with f32 rows
                want = {(n, p): k for n, k in expect_launches.items()}
                if shapes != want or modes != {"f32": sum(want.values())}:
                    raise RuntimeError(f"{name}: K1 launches by shape {shapes}, modes {modes}; want {want} f32")
            results = read_results(out)
            for rel, res in results.items():
                for key in ("tracked_keypoints", "gt_keypoints"):
                    if not np.isfinite(res[key]).all():
                        raise RuntimeError(f"{name} {rel}: non-finite {key}")
                if not res["valid_tracking"].any():
                    raise RuntimeError(f"{name} {rel}: no hand tracked")
            runs[name] = dict(
                report=dict(
                    wall_s=wall, frames_tracked=tracked, frames_per_s=tracked / wall,
                    frames_rendered=clock.frames, render_s=clock.seconds, render_share=clock.seconds / wall,
                    k1_launches={f"N={n}": k for (n, _), k in sorted(shapes.items())}, k1_row_modes=modes,
                    metrics=load_eval.aggregate_metrics(str(out)), last_line=lines[-1],
                ),
                results=results,
            )

        common = ["--input-dir", str(data), "--torch-device", device]
        unknown_args = common + ["--batch-recordings", str(r), "--generic-hand-model", str(generic_path)]
        two_pass = r * (min(calibration.CALIB_FRAMES, n_frames) + n_frames)
        # 3. known skeleton: one recording at a time (N=32 a chunk), then four in lockstep (N=128)
        run("known_b1", known, common + ["--batch-recordings", "1"], r * n_frames, {slots: r * chunks})
        run("known_b4", known, common + ["--batch-recordings", str(r)], r * n_frames, {r * slots: chunks})
        # 4. unknown skeleton, both passes in lockstep
        for calib in ("mean", "gn"):
            run(f"unknown_{calib}", unknown, unknown_args + ["--calib-mode", calib], two_pass,
                {r * slots: calib_chunks + chunks})
        lockstep_err = results_error(runs["known_b1"]["results"], runs["known_b4"]["results"])
        if lockstep_err > LANDMARK_TOL_MM:
            raise RuntimeError(f"known skeleton lockstep vs sequential: {lockstep_err} mm")
        scales = {
            calib: [res["calibrated_scale"] for res in runs[f"unknown_{calib}"]["results"].values()]
            for calib in ("mean", "gn")
        }
        if not all(0.5 < s < 2.0 for v in scales.values() for s in v):
            raise RuntimeError(f"calibrated scales far from 1: {scales}")

        report = dict(
            recordings=r, frames_per_recording=n_frames, chunk=LOCKSTEP_CHUNK,
            checkpoint_round_trip_bit_equal=True, checkpoint_bytes=native.stat().st_size,
            calibrated_scales=scales, known_lockstep_vs_sequential_max_err_mm=lockstep_err,
        )
        if on_card:
            report.update(_protocol_on_card(root, data, generic_path, pt, runs, common, slots, chunks, p))
        report["runs"] = {name: v["report"] for name, v in runs.items()}
    counted = [v["k1_launches"] for v in report["runs"].values()] + ([report["serving"]["k1_launches"]] if on_card else [])
    report["k1_launches"] = sum(sum(c.values()) for c in counted)
    return report


class _RenderClock:
    """Times the host's rendering inside an eval run: while it is entered,
    every frame source that ``eval_lib.frames_for`` hands out counts the
    seconds spent producing its frames."""

    def __init__(self, eval_lib):
        self.eval_lib, self.seconds, self.frames = eval_lib, 0.0, 0

    def _timed(self, source):
        it = iter(source)
        while True:
            t0 = time.perf_counter()
            try:
                frame = next(it)
            except StopIteration:
                return
            self.seconds += time.perf_counter() - t0
            self.frames += 1
            yield frame

    def __enter__(self):
        self.original = self.eval_lib.frames_for
        self.eval_lib.frames_for = lambda *a, **k: self._timed(self.original(*a, **k))
        return self

    def __exit__(self, *exc):
        self.eval_lib.frames_for = self.original


def _cli(module, argv) -> tuple:
    """(wall seconds, printed lines, return value) of one ``module.main(argv)``."""
    import io
    from contextlib import redirect_stdout

    out = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        result = module.main(argv)
    return time.perf_counter() - t0, out.getvalue().splitlines(), result


def _protocol_on_card(root, data, generic_path, pt, runs, common, slots, chunks, p) -> dict:
    """The protocol phase's checks that need the card: one recording against
    the port's CPU run, the device's busy time, a serving run, the GN windows
    card against CPU, and K1 at the protocol's shapes (N = 32 and 128 crop slots) against its plain
    version in every row mode, with its times."""
    import shutil

    import torch

    from absolutetrack_tpu_torch.apps import calibration, eval_lib
    from absolutetrack_tpu_torch.apps import run_eval_known_skeleton as known
    from absolutetrack_tpu_torch.kinematics.hand_model import load_hand_model_json
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops import gauss_newton, warp_kernel
    from absolutetrack_tpu_torch.tracker.video_data import load_labels

    out = {}
    # one recording: the card's sequential pickle against the port's CPU run
    one = root / "one" / "testing" / "user00"
    one.mkdir(parents=True)
    first = sorted((Path(data) / "testing" / "user00").glob("*.json"))[0]
    shutil.copy(first, one / first.name)
    one_root = ["--input-dir", str(root / "one"), "--checkpoint", str(pt), "--override"]
    wall, _, _ = _cli(known, one_root + ["--output-dir", str(root / "cpu"), "--torch-device", "cpu",
                                         "--max-frames", str(PROTOCOL_CPU_FRAMES)])
    card = {k: v for k, v in runs["known_b1"]["results"].items() if k.startswith("testing/user00/" + first.stem)}
    cpu_err = results_error(card, read_results(root / "cpu"))
    if cpu_err > LANDMARK_TOL_MM:
        raise RuntimeError(f"protocol card vs CPU: {cpu_err} mm")
    out.update(cpu_frames=PROTOCOL_CPU_FRAMES, cpu_wall_s=wall, vs_cpu_max_err_mm=cpu_err)

    # the device's busy time a frame over one chunk of each known-skeleton
    # run (torch.profiler), and its idle share of the counted run's wall time
    r = len(runs["known_b1"]["results"])
    for name, batch in (("known_b1", 1), ("known_b4", r)):
        argv = common + ["--checkpoint", str(pt), "--override", "--output-dir", str(root / "busy"),
                         "--batch-recordings", str(batch), "--max-frames", str(LOCKSTEP_CHUNK)]
        busy = device_busy(lambda: _cli(known, argv), r * LOCKSTEP_CHUNK)
        rep = runs[name]["report"]
        rep.update(busy, device_idle_share=1 - busy["device_busy_ms_per_frame"] * rep["frames_tracked"] / 1e3 / rep["wall_s"])

    # serving: K1's bf16 rows at N=32
    warp_kernel.K1.reset_counts()
    wall, _, _ = _cli(known, one_root + ["--output-dir", str(root / "serving"), "--torch-device", "cuda",
                                         "--precision", "serving"])
    want = ({(slots, p): chunks}, {"bf16": chunks})
    if (dict(warp_kernel.K1.shapes), dict(warp_kernel.K1.modes)) != want:
        raise RuntimeError(f"serving: K1 {dict(warp_kernel.K1.shapes)} {dict(warp_kernel.K1.modes)}; want {want}")
    serving = read_results(root / "serving")
    serving_err = results_error(card, serving)
    frames = sum(res["valid_tracking"].shape[1] for res in serving.values())
    out["serving"] = dict(wall_s=wall, frames_per_s=frames / wall,
                          k1_launches={f"N={slots}": chunks}, k1_row_modes={"bf16": chunks},
                          vs_parity_max_err_mm=serving_err)

    # the GN windows of both hands (T = CALIB_FRAMES, 6 iterations) in one solve, card against CPU
    model = eval_lib.build_model(str(pt), ModelConfig(), device="cuda")
    labels = [load_labels(lf) for lf in known.find_label_files(str(data))]
    generic = load_hand_model_json(str(generic_path))
    calib = eval_lib.track_recording(
        model, labels[0], eval_lib.frames_for(labels[0], None), hand_model_mm=generic,
        calibrate_scale=True, max_frames=calibration.CALIB_FRAMES,
    )
    windows = calibration.gn_windows(generic, [calib], "cpu")
    if windows is None:
        raise RuntimeError("GN windows: no hand has 2 valid frames")
    fits, ms = {}, {}
    for dev in ("cuda", "cpu"):
        args = [x.to(dev) for x in windows[1:]]
        hand = generic.to(dev)

        def fit():
            res = gauss_newton.calibrate_scale_windows(hand, *args[:3], frame_mask=args[3], iters=6)
            if dev == "cuda":
                torch.cuda.synchronize()
            return res

        fit()  # warm-up
        t0 = time.perf_counter()
        for _ in range(3):
            fits[dev] = fit()
        ms[dev] = (time.perf_counter() - t0) / 3 * 1e3
    gn_log_err = float((fits["cuda"].log_scale.cpu() - fits["cpu"].log_scale).abs().max())
    gn_res_err = float((fits["cuda"].residual.cpu() - fits["cpu"].residual).abs().max())
    if not gn_log_err <= GN_LOG_SCALE_TOL or not gn_res_err <= GN_RESIDUAL_TOL_MM:
        raise RuntimeError(f"GN windows card vs CPU: log-scale {gn_log_err}, residual {gn_res_err} mm")
    out["gn_window"] = dict(
        windows=len(windows[0]), frames=int(windows[1].shape[1]), iterations=6, card_ms=ms["cuda"],
        cpu_ms=ms["cpu"], log_scale=fits["cuda"].log_scale.tolist(), residual_mm=fits["cuda"].residual.tolist(),
        log_scale_err=gn_log_err, log_scale_tol=GN_LOG_SCALE_TOL,
        residual_err_mm=gn_res_err, residual_tol_mm=GN_RESIDUAL_TOL_MM,
    )

    # K1 at the protocol's shapes against its plain version, and its times
    serving_model = eval_lib.build_model(str(pt), ModelConfig.serving(), device="cuda")
    recorder = _RecordCalls(warp_kernel.K1)
    warp_kernel.K1 = recorder
    try:
        for net in (model, serving_model):
            eval_lib.track_recording(net, labels[0], eval_lib.frames_for(labels[0], None), max_frames=LOCKSTEP_CHUNK)
        eval_lib.track_recordings_batched(
            model, [(lab, eval_lib.frames_for(lab, None)) for lab in labels], max_frames=LOCKSTEP_CHUNK
        )
    finally:
        warp_kernel.K1 = recorder.kernel
    calls = {}
    for images, ii, xs, ys, valid_hw, mode in recorder.calls:
        calls.setdefault((xs.shape[0], warp_kernel.ROW_MODE_NAMES[int(mode)]), (images, ii, xs, ys, valid_hw))
    want = {(slots, "f32"), (len(labels) * slots, "f32"), (slots, "bf16")}
    if set(calls) != want:
        raise RuntimeError(f"K1 calls recorded at {sorted(calls)}; want {sorted(want)}")
    k1 = {}
    for (n, mode), (images, ii, xs, ys, valid_hw) in sorted(calls.items()):
        err = max(k1_error(images, ii, xs, ys, valid_hw, m) for m in row_modes(images.dtype))
        if err > K1_TOL:
            raise RuntimeError(f"K1 at N={n} ({mode} run): max |err| {err} > {K1_TOL}")
        if mode == "f32":
            k1[f"n{n}"] = dict(k1_timings(images, ii, xs, ys, iters=50), max_abs_err=err, source_dtype=str(images.dtype))
        else:
            k1[f"n{n}_serving_max_abs_err"] = err
    out["k1"] = k1
    return out


def packed_compare(a_root, b_root) -> dict:
    """Two packs of the same recordings, window by window over the windows
    both hold: the share of mono bytes equal, their largest difference, and
    the labels' largest error relative to each field's largest value;
    raises when the folders differ, a mono byte differs by more than 1 or
    the labels by more than ``LABELS_REL``."""
    from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders

    folders = [find_dataset_folders(str(r), ["mono", "labels"]) for r in (a_root, b_root)]
    rel = [[str(Path(f).relative_to(r)) for f in fs] for fs, r in zip(folders, (a_root, b_root))]
    if rel[0] != rel[1] or not rel[0]:
        raise RuntimeError(f"packed folders differ: {rel}")
    equal, total, max_diff, labels_err = 0, 0, 0, 0.0
    for fa, fb in zip(*folders):
        da, db = PackedDataset([fa], ["mono", "labels"]), PackedDataset([fb], ["mono", "labels"])
        for i in range(min(len(da), len(db))):
            a, b = da[i], db[i]
            d = np.abs(a["mono"].astype(np.int16) - b["mono"].astype(np.int16))
            equal, total, max_diff = equal + int((d == 0).sum()), total + d.size, max(max_diff, int(d.max()))
            if sorted(a["labels"]) != sorted(b["labels"]):
                raise RuntimeError("packed label keys differ")
            for key, value in a["labels"].items():
                if isinstance(value, dict):
                    if value != b["labels"][key]:
                        raise RuntimeError(f"packed {key} differs")
                    continue
                va, vb = np.asarray(value, np.float64), np.asarray(b["labels"][key], np.float64)
                scale = max(float(np.abs(va).max()), 1e-12)
                labels_err = max(labels_err, float(np.abs(va - vb).max()) / scale)
    if max_diff > 1 or equal / total < MONO_EQUAL or labels_err > LABELS_REL:
        raise RuntimeError(f"packs differ: mono max {max_diff}, equal share {equal / total}, labels {labels_err}")
    return dict(mono_equal_share=equal / total, mono_max_diff=max_diff, labels_max_rel_err=labels_err)


def data_phase(
    seed: int, device: str = "cuda", n_recordings: int = DATA_RECORDINGS, n_frames: int = DATA_FRAMES,
    window: int = DATA_WINDOW, batch_windows: int = DATA_BATCH, limit: int = DATA_B1_LIMIT,
) -> dict:
    """The packed-data path at full ``ModelConfig()`` width with TF32 off
    (``device="cpu"`` and a small tree: its CPU rehearsal): the protocol's
    label tree of ``n_recordings`` x ``n_frames`` mesh frames packed by
    ``pack_sample_data.main`` (views 1-2, windows of ``window`` frames, one
    K1 launch of 4 full frames a frame), then
    ``run_inference_torch_data.main`` over every window ``batch_windows``
    at a time and over the first ``limit`` one at a time (one K1 launch of
    2 ``window`` crops a window), K1's launches counted from 0 before each
    run; lockstep against one at a time; on the card also 2 windows against
    the port's CPU run, one recording's pack against the CPU's, a serving
    run (bf16 rows), the device's busy time over one group, and K1 at both
    new shapes against its plain version in the f32 and bf16 row modes,
    with its times."""
    import tempfile

    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.apps import pack_sample_data as pack
    from absolutetrack_tpu_torch.apps import run_inference_torch_data as infer
    from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders
    from absolutetrack_tpu_torch.data.transform import preprocess_packed
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops import warp_kernel

    on_card = device == "cuda"
    cfg = ModelConfig()
    h, w = SRC_HW
    crop_px = cfg.input_size[0] * cfg.input_size[1]
    n_windows = n_recordings * 2 * (n_frames // window)
    out = dict(recordings=n_recordings, frames_per_recording=n_frames, window=window, windows=n_windows)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data, generic = protocol_tree(root, build_scene(seed, n_frames + n_recordings - 1, mesh=True), n_recordings, n_frames)
        pt = root / "reference.pt"
        torch.save(reference_state_dict(cfg, seed), pt)

        def pack_args(input_dir, max_frames, out_dir, dev):
            return ["--input-dir", str(input_dir), "--generic-hand-model", str(generic), "--window", str(window),
                    "--views", "1", "2", "--max-frames", str(max_frames), "--renderer", "mesh",
                    "--output-dir", str(out_dir), "--torch-device", dev]

        def counted(name, want):
            shapes, modes = dict(warp_kernel.K1.shapes), dict(warp_kernel.K1.modes)
            if (shapes, modes) != (want if on_card else ({}, {})):  # the CPU launches no K1
                raise RuntimeError(f"{name}: K1 launches by shape {shapes}, modes {modes}; want {want}")
            return {f"N={n} P={p}": k for (n, p), k in sorted(shapes.items())}

        # 1. pack on the device: one K1 launch of the 4 views a frame
        warp_kernel.K1.reset_counts()
        with _RenderClock(eval_lib) as render:
            wall, lines, _ = _cli(pack, pack_args(data, n_frames, root / "packed", device))
        frames = n_recordings * n_frames
        launches = counted("pack", ({(N_VIEWS, h * w): frames}, {"f32": frames}))
        out["pack"] = dict(
            wall_s=wall, frames=frames, render_s=render.seconds, render_share=render.seconds / wall,
            k1_launches=launches, last_line=lines[-1], rectify_ms_per_frame=_rectify_ms(data, window, device),
        )

        # 2. the windows, batch_windows at a time, then the first `limit` one
        # at a time; each run twice, the first counted
        infer_args = ["--data-root", str(root / "packed"), "--checkpoint", str(pt), "--torch-device", device]
        runs = {}
        for name, argv, n in (
            ("w_batch", ["--batch-windows", str(batch_windows)], n_windows),
            ("w1", ["--batch-windows", "1", "--limit", str(limit)], limit),
        ):
            warp_kernel.K1.reset_counts()
            wall, lines, (errors, loop_s) = _cli(infer, infer_args + argv)
            if errors.shape != (n, window) or not np.isfinite(errors).all():
                raise RuntimeError(f"{name}: errors of shape {errors.shape}, or not finite")
            launches = counted(name, ({(2 * window, crop_px): n}, {"f32": n}))
            _, _, (again, repeat_s) = _cli(infer, infer_args + argv)
            if not np.abs(again - errors).max() <= LANDMARK_TOL_MM:
                raise RuntimeError(f"{name}: a repeat of the run gave other errors")
            runs[name] = errors
            out[name] = dict(
                windows=n, frames=n * window, wall_s=wall, loop_s=loop_s, windows_per_s=n / loop_s,
                frames_per_s=n * window / loop_s, repeat_loop_s=repeat_s, repeat_frames_per_s=n * window / repeat_s,
                mean_error_mm=float(errors.mean()), k1_launches=launches,
                printed=[line for line in lines if line.startswith(("throughput", "Mean"))],
            )
        out["batched_vs_b1_max_err_mm"] = float(np.abs(runs["w_batch"][:limit] - runs["w1"]).max())
        if not out["batched_vs_b1_max_err_mm"] <= LANDMARK_TOL_MM:
            raise RuntimeError(f"data: W={batch_windows} against W=1: {out['batched_vs_b1_max_err_mm']} mm")

        # reading a window (the label dict's msgpack decode) and preprocessing it, alone
        ds = PackedDataset(find_dataset_folders(str(root / "packed"), ["mono", "labels"]), ["mono", "labels"])
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(min(len(ds), batch_windows))]
        out["read_ms_per_window"] = (time.perf_counter() - t0) / len(samples) * 1e3
        preprocess_packed(np.asarray(samples[0]["mono"]), samples[0]["labels"], device=device)  # warm-up
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        seqs = [preprocess_packed(np.asarray(s["mono"]), s["labels"], device=device) for s in samples]
        sync()
        out["preprocess_ms_per_window"] = (time.perf_counter() - t0) / len(samples) * 1e3
        # the network alone on preprocessed windows: one group in lockstep, one window
        model = eval_lib.build_model(str(pt), cfg, device=device)
        out["network_ms"] = {}
        for name, group in (("group", infer.stack_windows(seqs)), ("window", infer.stack_windows(seqs[:1]))):
            infer.eval_windows_batched(model, group).cpu()  # warm-up
            t0 = time.perf_counter()
            infer.eval_windows_batched(model, group).cpu()
            out["network_ms"][f"{name}_of_{len(group.hand_idx)}"] = (time.perf_counter() - t0) * 1e3
        del model, seqs
        if on_card:
            out.update(_data_on_card(root, data, pack_args, infer_args, runs, out["w_batch"]["loop_s"], window))
    out["k1_launches"] = sum(
        sum(out[name]["k1_launches"].values()) for name in ("pack", "w_batch", "w1", "serving") if name in out
    )
    return out


def _rectify_ms(data, n_frames: int, device: str) -> float:
    """Host-clock ms a frame of ``rectify_views`` over ``n_frames`` frames of
    the tree's first recording, rendered before the clock starts, after
    one warm-up frame: the warp and its readback without the rendering."""
    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.apps import pack_sample_data as pack
    from absolutetrack_tpu_torch.tracker.video_data import load_labels

    labels = load_labels(str(sorted((Path(data) / "testing" / "user00").glob("*.json"))[0]))
    frames = list(itertools.islice(eval_lib.frames_for(labels, None), n_frames))
    pack.rectify_views(labels, frames, max_frames=1, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pack.rectify_views(labels, frames, max_frames=n_frames, device=device)  # ends in copies to the host
    return (time.perf_counter() - t0) / n_frames * 1e3


def _data_on_card(root, data, pack_args, infer_args, runs, batch_loop_s, window) -> dict:
    """The data phase's checks that need the card: 2 windows against the
    port's CPU run, one recording's pack against the CPU's, a serving run,
    the device's busy time over one group, a K1 failure on the prefetch
    thread raising in the consumer, and K1 at the rectify and window shapes
    against its plain version in the f32 and bf16 row modes, with its
    times."""
    import shutil

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.apps import pack_sample_data as pack
    from absolutetrack_tpu_torch.apps import run_inference_torch_data as infer
    from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders
    from absolutetrack_tpu_torch.data.transform import preprocess_packed
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops import warp_kernel
    from absolutetrack_tpu_torch.tracker.video_data import load_labels

    out = {}
    # the card's errors against the port's CPU run, on the same packed windows
    argv = [a if a != "cuda" else "cpu" for a in infer_args] + ["--limit", str(DATA_CPU_WINDOWS)]
    wall, _, (cpu_errors, _) = _cli(infer, argv)
    out["vs_cpu_max_err_mm"] = float(np.abs(cpu_errors - runs["w1"][:DATA_CPU_WINDOWS]).max())
    out["cpu_windows"], out["cpu_wall_s"] = DATA_CPU_WINDOWS, wall
    if not out["vs_cpu_max_err_mm"] <= LANDMARK_TOL_MM:
        raise RuntimeError(f"data card vs CPU: {out['vs_cpu_max_err_mm']} mm")

    # one recording packed on the CPU against the card's pack of it
    first = sorted((Path(data) / "testing" / "user00").glob("*.json"))[0]
    (root / "one" / "testing").mkdir(parents=True)
    shutil.copy(first, root / "one" / "testing" / first.name)
    for dev in ("cpu", "cuda"):
        _cli(pack, pack_args(root / "one", DATA_CPU_FRAMES, root / f"one_{dev}", dev))
    out["pack_vs_cpu"] = dict(packed_compare(root / "one_cuda", root / "one_cpu"), frames=DATA_CPU_FRAMES)

    # serving: the bf16 trunk, and preprocessing with bf16 rows
    warp_kernel.K1.reset_counts()
    wall, _, (serving, loop_s) = _cli(infer, infer_args + ["--precision", "serving", "--limit", str(DATA_CPU_WINDOWS)])
    crop_px = math.prod(ModelConfig().input_size)
    want = ({(2 * window, crop_px): DATA_CPU_WINDOWS}, {"bf16": DATA_CPU_WINDOWS})
    if (dict(warp_kernel.K1.shapes), dict(warp_kernel.K1.modes)) != want:
        raise RuntimeError(f"data serving: K1 {dict(warp_kernel.K1.shapes)} {dict(warp_kernel.K1.modes)}; want {want}")
    out["serving"] = dict(
        windows=DATA_CPU_WINDOWS, loop_s=loop_s, k1_launches={f"N={2 * window} P={crop_px}": DATA_CPU_WINDOWS},
        k1_row_modes={"bf16": DATA_CPU_WINDOWS},
        vs_parity_max_err_mm=float(np.abs(serving - runs["w1"][:DATA_CPU_WINDOWS]).max()),
    )

    # the device's busy time over one group of batch_windows windows, and
    # its idle share of the counted run's evaluation loop
    group = infer_args + ["--batch-windows", str(DATA_BATCH), "--limit", str(DATA_BATCH)]
    busy = device_busy(lambda: _cli(infer, group), DATA_BATCH * window)
    idle = 1 - busy["device_busy_ms_per_frame"] * runs["w_batch"].size / 1e3 / batch_loop_s
    out["device"] = dict(busy, group_windows=DATA_BATCH, device_idle_share=idle)

    # a K1 failure on the prefetch thread reaches the consumer: the run raises
    def refused(*args):
        raise RuntimeError("K1 refused the launch")

    kernel, warp_kernel.K1 = warp_kernel.K1, refused
    try:
        _cli(infer, infer_args + ["--limit", "1"])
    except RuntimeError as e:
        if "K1 refused" not in str(e):
            raise
    else:
        raise RuntimeError("a K1 failure on the prefetch thread did not reach the consumer")
    finally:
        warp_kernel.K1 = kernel
    out["worker_failure_raises"] = True

    # K1 at both new shapes, on the path's own coordinates
    recorder = _RecordCalls(warp_kernel.K1)
    warp_kernel.K1 = recorder
    try:
        labels = load_labels(str(first))
        pack.rectify_views(labels, eval_lib.frames_for(labels, None), max_frames=1, device="cuda")
        ds = PackedDataset(find_dataset_folders(str(root / "packed"), ["mono", "labels"]), ["mono", "labels"])
        preprocess_packed(np.asarray(ds[0]["mono"]), ds[0]["labels"], device="cuda")
    finally:
        warp_kernel.K1 = recorder.kernel
    k1 = {}
    for name, (images, ii, xs, ys, valid_hw, _) in zip(("n4_full_frame", "n16_windows"), recorder.calls):
        err = max(k1_error(images, ii, xs, ys, valid_hw, m) for m in row_modes(images.dtype))
        if err > K1_TOL:
            raise RuntimeError(f"K1 at {name}: max |err| {err} > {K1_TOL}")
        k1[name] = dict(k1_timings(images, ii, xs, ys, iters=50), max_abs_err=err, rows_checked=["f32", "bf16"],
                        source_dtype=str(images.dtype), n=xs.shape[0], p=xs[0].numel())
    if [(v["n"], v["p"]) for v in k1.values()] != [(N_VIEWS, SRC_HW[0] * SRC_HW[1]), (2 * window, crop_px)]:
        raise RuntimeError(f"K1 calls recorded at {[(v['n'], v['p']) for v in k1.values()]}")
    out["k1"] = k1
    return out


class _StepClock:
    """Times each train step of ``apps.train.main`` on the host clock, the
    device synchronised at the step's end, and each wait for the prefetch
    thread's next batch, by wrapping the module's ``make_train_step`` and
    ``PrefetchIterator`` while in use."""

    def __init__(self, app, sync: bool):
        self.app, self.sync = app, sync
        self.step_ms, self.wait_ms = [], []

    def __enter__(self):
        import torch

        real_step, real_iter = self.app.make_train_step, self.app.PrefetchIterator
        self._real = real_step, real_iter
        clock = self

        def make_train_step(*args, **kwargs):
            step = real_step(*args, **kwargs)

            def timed(state, batch, hand):
                t0 = time.perf_counter()
                out = step(state, batch, hand)
                if clock.sync:
                    torch.cuda.synchronize()
                clock.step_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            return timed

        class Timed(real_iter):
            def __next__(self):
                t0 = time.perf_counter()
                item = super().__next__()
                clock.wait_ms.append((time.perf_counter() - t0) * 1e3)
                return item

        self.app.make_train_step, self.app.PrefetchIterator = make_train_step, Timed
        return self

    def __exit__(self, *exc):
        self.app.make_train_step, self.app.PrefetchIterator = self._real


def _spread(xs) -> dict:
    """Median, min and max of a run's per-step times after its first (the
    first step warms cuDNN's algorithm choice and the allocator)."""
    rest = xs[1:] if len(xs) > 1 else xs
    return dict(median=float(np.median(rest)), min=float(np.min(rest)), max=float(np.max(rest)),
                first=float(xs[0]), n=len(xs))


def _states_equal(a, b) -> bool:
    """Two train states bit for bit: params, the guard's fields, count, moments, step."""
    import torch

    pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
    ga, gb = a.opt_state, b.opt_state
    tensors = [(pa[k], pb[k]) for k in pa] + [(ga.inner_state.mu[k], gb.inner_state.mu[k]) for k in pa]
    tensors += [(ga.inner_state.nu[k], gb.inner_state.nu[k]) for k in pa]
    tensors += [(getattr(ga, f), getattr(gb, f)) for f in ("notfinite_count", "last_finite", "total_notfinite")]
    tensors += [(ga.inner_state.count, gb.inner_state.count), (a.step, b.step)]
    return sorted(pa) == sorted(pb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in tensors)


def train_phase(seed: int, device: str = "cuda", tiny: bool = False) -> dict:
    """Training through ``apps.train.main`` at full ``ModelConfig()`` width
    with TF32 off (``tiny`` and ``device="cpu"``: its CPU rehearsal, the
    rendered mode at ``--tiny-arch`` 32x32, fewer and smaller steps; the
    packed mode always trains the full model): packed windows from a tree
    that the phase packs itself (2 recordings, windows of 8), ``--branch
    both``, ``TRAIN_STEPS`` steps of 4 windows from a reference-named
    ``.pt`` (K1 at N=16 on the prefetch thread, 4 launches a step), the
    train-state file read back bit-equal to the state in memory, then
    ``--resume`` for ``TRAIN_RESUME_STEPS`` more; rendered windows
    (``--rendered --input-size 96 --window 2``) from a label tree of
    recording_00/02/11 of ``TRAIN_RENDERED_FRAMES`` mesh frames, the cache
    in a fresh directory (K1 at N=128, uint8 frames, once a recording). On
    the card also: a synchronised breakdown of a step, the device's busy
    time over two steps, one step against the port's CPU on the same batch
    (B=2, T=2) and the card's own spread, and K1 at the rendered shape
    against its plain version, with its times."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    import torch

    from absolutetrack_tpu_torch.apps import pack_sample_data as pack
    from absolutetrack_tpu_torch.apps import train as app
    from absolutetrack_tpu_torch.models import checkpoint
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops import warp_kernel

    on_card = device == "cuda"
    steps, resume_steps, batch, window = (2, 1, 2, 2) if tiny else (TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_BATCH, TRAIN_WINDOW)
    r_steps, r_frames = (2, 10) if tiny else (TRAIN_RENDERED_STEPS, TRAIN_RENDERED_FRAMES)
    size = 32 if tiny else ModelConfig().input_size[0]
    crop_px = ModelConfig().input_size[0] * ModelConfig().input_size[1]
    dev = ["--torch-device", device]
    out = dict(device=device, tiny=tiny)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        n_frames = 2 * window
        data, generic = protocol_tree(root, build_scene(seed, n_frames + 1, mesh=True), 2, n_frames)
        with redirect_stdout(io.StringIO()):
            pack.main(["--input-dir", str(data), "--generic-hand-model", str(generic), "--window", str(window),
                       "--views", "1", "2", "--max-frames", str(n_frames), "--renderer", "mesh",
                       "--output-dir", str(root / "packed")] + dev)
        pt = root / "reference.pt"
        torch.save(reference_state_dict(ModelConfig(), seed), pt)

        def k1_counts(name, allowed):
            shapes = dict(warp_kernel.K1.shapes)
            ok = (all(shape in allowed for shape in shapes) and shapes) if on_card else not shapes
            if not ok:
                raise RuntimeError(f"train {name}: K1 launches by shape {shapes}; want shapes {allowed}")
            return {f"N={n} P={p}": k for (n, p), k in sorted(shapes.items())}

        # 1. packed training, the step clocked
        warp_kernel.K1.reset_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        argv = ["--data-root", str(root / "packed"), "--branch", "both", "--batch", str(batch),
                "--checkpoint", str(pt)] + dev
        with _StepClock(app, on_card) as clock:
            wall, lines, res = _cli(app, argv + ["--steps", str(steps), "--save-every", str(max(steps // 2, 1)),
                                                 "--save", str(root / "ck.msgpack")])
        launches = k1_counts("packed", {(2 * window, crop_px)})
        n_k1 = sum(launches.values())
        # the prefetch thread builds up to 4 batches past the last step: 2
        # queued, 1 waiting to be queued, 1 begun when close() drains the queue
        if on_card and not steps * batch <= n_k1 <= (steps + 4) * batch:
            raise RuntimeError(f"train packed: {n_k1} K1 launches for {steps} steps of {batch} windows")
        losses = [float(m["total"]) for m in res["metrics"]]
        if not np.isfinite(losses).all():
            raise RuntimeError(f"train packed: losses {losses}")
        back = checkpoint.load_train_state(str(root / "ck.msgpack.train"), res["state"])
        if not _states_equal(back, res["state"]):
            raise RuntimeError("train packed: the train-state file does not hold the state in memory")
        crops = batch * window * 2
        out["packed"] = dict(
            steps=steps, batch=batch, window=window, crops_per_step=crops, wall_s=wall, loop_s=res["seconds"],
            steps_per_s=steps / res["seconds"], crops_per_s=steps * crops / res["seconds"],
            step_ms=_spread(clock.step_ms), wait_ms=_spread(clock.wait_ms),
            step_plus_wait_ms=_spread([a + b for a, b in zip(clock.step_ms, clock.wait_ms)]),
            losses=losses, k1_launches=launches, train_state_bit_equal=True,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated() if on_card else None,
            printed=[line for line in lines if line.startswith(("step", "saved"))],
        )

        # 2. resume: the step counter and the moments go on
        warp_kernel.K1.reset_counts()
        _, lines, resumed = _cli(app, argv + ["--steps", str(resume_steps), "--resume", str(root / "ck.msgpack.train"),
                                              "--save", str(root / "resumed.msgpack")])
        want = f"resumed from {root / 'ck.msgpack.train'} at step {steps}"
        if want not in lines or int(resumed["state"].step) != steps + resume_steps:
            raise RuntimeError(f"train resume: {lines[:2]}, step {int(resumed['state'].step)}")
        out["resume"] = dict(step_before=steps, steps=resume_steps, step_after=int(resumed["state"].step),
                             k1_launches=k1_counts("resume", {(2 * window, crop_px)}),
                             losses=[float(m["total"]) for m in resumed["metrics"]])
        del resumed

        # 3. rendered windows through the tracker's crop path, a fresh cache
        rroot = root / "rendered"
        rroot.mkdir()
        scene = build_scene(seed + 1, r_frames + 2, mesh=True)
        for i, name in enumerate(("recording_00", "recording_02", "recording_11")):
            (rroot / f"{name}.json").write_text(json.dumps(labels_json(scene, i, r_frames)))
        rgeneric = rroot / "generic_hand_model.json"
        rgeneric.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
        rpt = pt
        if tiny:
            rpt = root / "tiny.pt"
            torch.save(reference_state_dict(ModelConfig.tiny(input_size=(size, size)), seed), rpt)
        n_windows = min(len(range(0, r_frames - TRAIN_RENDERED_WINDOW, 4)), 16)
        warp_kernel.K1.reset_counts()
        recorder = _RecordCalls(warp_kernel.K1)
        warp_kernel.K1 = recorder
        try:
            with _StepClock(app, on_card) as rclock:
                wall, lines, rres = _cli(app, [
                    "--rendered", "--rendered-root", str(rroot), "--generic-hand-model", str(rgeneric),
                    "--input-size", str(size), "--window", str(TRAIN_RENDERED_WINDOW), "--steps", str(r_steps),
                    "--batch", str(TRAIN_BATCH), "--checkpoint", str(rpt), "--cache-dir", str(root / "cache"),
                    "--save", str(root / "rendered.msgpack")] + (["--tiny-arch"] if tiny else []) + dev)
        finally:
            warp_kernel.K1 = recorder.kernel
        n_slots = 4 * n_windows * TRAIN_RENDERED_WINDOW
        rlaunches = k1_counts("rendered", {(n_slots, size * size)})
        if on_card and sum(rlaunches.values()) != 3:  # one chunk a recording
            raise RuntimeError(f"train rendered: K1 launches {rlaunches}")
        if not np.isfinite(rres["heldout"]).all():
            raise RuntimeError(f"train rendered: held-out MPJPE {rres['heldout']}")
        rsteps = [float(m["total"]) for m in rres["metrics"]]
        out["rendered"] = dict(
            steps=r_steps, batch=TRAIN_BATCH, window=TRAIN_RENDERED_WINDOW, frames_per_recording=r_frames,
            windows_per_recording=n_windows, wall_s=wall, loop_s=rres["seconds"],
            steps_per_s=r_steps / rres["seconds"],
            crops_per_s=r_steps * TRAIN_BATCH * TRAIN_RENDERED_WINDOW * 2 / rres["seconds"],
            step_ms=_spread(rclock.step_ms), wait_ms=_spread(rclock.wait_ms), losses=rsteps,
            heldout_mm=list(rres["heldout"]), k1_launches=rlaunches,
            printed=[line for line in lines if line.startswith(("rendered", "held-out"))],
        )
        del rres
        if on_card:
            out.update(_train_on_card(root, pt, window))
            images, ii, xs, ys, valid_hw, _ = recorder.calls[0]
            if xs.shape != (n_slots, size, size) or images.dtype != torch.uint8:
                raise RuntimeError(f"train rendered: K1 called at {tuple(xs.shape)}, {images.dtype}")
            err = {warp_kernel.ROW_MODE_NAMES[m]: k1_error(images, ii, xs, ys, valid_hw, m) for m in row_modes(images.dtype)}
            if max(err.values()) > K1_TOL:
                raise RuntimeError(f"K1 at the rendered shape: max |err| {err} > {K1_TOL}")
            out["k1"] = dict(k1_timings(images, ii, xs, ys, iters=50), max_abs_err=max(err.values()),
                             max_abs_err_by_rows=err, source_dtype=str(images.dtype), n=n_slots, p=size * size)
        del recorder
    out["k1_launches"] = sum(sum(out[name]["k1_launches"].values()) for name in ("packed", "resume", "rendered"))
    return out


def _train_on_card(root, pt, window) -> dict:
    """The train phase's measurements and checks that need the card, on
    batches of the phase's packed tree: a synchronised breakdown of a step
    (4 windows of T=8) into forward, backward and optimizer; the device's
    busy time over two steps; one step (2 windows, T=2) against the port's
    CPU with ``tests/test_torch_training.py``'s rules, and the card's
    spread over two identical steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.apps import train as app
    from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders
    from absolutetrack_tpu_torch.data.transform import preprocess_packed
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.training.optimizer import apply_updates
    from absolutetrack_tpu_torch.training.train import (
        SequenceBatch, init_train_state, loss_fn, make_optimizer, make_train_step, to_device,
    )

    cfg = ModelConfig()
    ds = PackedDataset(find_dataset_folders(str(root / "packed"), ["mono", "labels"]), ["mono", "labels"])
    seqs = [preprocess_packed(np.asarray(ds[i]["mono"]), ds[i]["labels"], device="cuda") for i in range(TRAIN_BATCH)]
    batch, hand = app.windows_to_batch(seqs)
    out = {}

    # a synchronised breakdown of one step (after a warm-up step)
    state = init_train_state(eval_lib.build_model(str(pt), cfg, device="cuda"), make_optimizer(TRAIN_LR))
    step = make_train_step(cfg, make_optimizer(TRAIN_LR), branch="both")
    state, _ = step(state, batch, hand)
    model, opt = state.params, make_optimizer(TRAIN_LR)
    params = dict(model.named_parameters())
    parts = {"forward": [], "backward": [], "optimizer": []}
    opt_state = state.opt_state
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch, hand, cfg, "both")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        updates, opt_state = opt.update(dict(zip(params, grads)), opt_state, params)
        apply_updates(params, updates)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[name].append(dt * 1e3)
    out["breakdown_ms"] = {k: float(np.median(v)) for k, v in parts.items()}
    out["breakdown_ms"]["crops"] = TRAIN_BATCH * window * 2

    # the device's busy time over two steps, beside their wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        state, _ = step(state, batch, hand)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch, hand)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out["device"] = dict(busy_ms_two_steps=busy, wall_ms_two_steps=wall_ms, idle_share=1 - busy / wall_ms,
                         kernels_per_step=sum(e.count for e in kernels) / 2)
    del state, step, model, params, opt_state

    # one step, card against CPU, on the same 2 windows of T=2
    time_major = {"images", "intrinsics", "extrinsics", "use_memory", "sample_mask", "gt_joint_angles", "gt_wrist"}
    small = SequenceBatch(**{k: (v[:2, :2] if k in time_major else v[:2]) for k, v in batch._asdict().items()})
    small_hand = hand.map(lambda x: x[:2])

    def one_step(dev):
        model = eval_lib.build_model(str(pt), cfg, device=dev).requires_grad_(True)
        b, h = to_device(small, small_hand, dev)
        ps = dict(model.named_parameters())
        loss, _ = loss_fn(model, b, h, cfg, "both")
        grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(ps.items(), grads)}
        opt = make_optimizer(TRAIN_LR)
        updates, _ = opt.update(grads, opt.init(ps), ps)
        apply_updates(ps, updates)
        flat = lambda t: {k: v.detach().cpu().numpy() for k, v in t.items()}  # noqa: E731
        return float(loss.detach()), flat(grads), flat(ps)

    t0 = time.perf_counter()
    cpu = one_step("cpu")
    cpu_s = time.perf_counter() - t0
    card, again = one_step("cuda"), one_step("cuda")

    def grad_errors(a, b):
        """(max |a - b| over the largest |b| of all leaves, the whole
        gradient's relative error in norm, the worst leaf by its own largest |b|)."""
        gmax = max(float(np.abs(g).max()) for g in b.values())
        worst = max((float(np.abs(a[k] - g).max() / max(np.abs(g).max(), 1e-30)), k) for k, g in b.items())
        norm = math.sqrt(sum(float(((a[k] - g) ** 2).sum()) for k, g in b.items()))
        return max(float(np.abs(a[k] - g).max()) for k, g in b.items()) / gmax, norm / math.sqrt(
            sum(float((g ** 2).sum()) for g in b.values())), worst

    grad_err, grad_norm_err, leaf_worst = grad_errors(card[1], cpu[1])
    gmax = max(float(np.abs(g).max()) for g in cpu[1].values())
    strong_err, weak_err = 0.0, 0.0
    for k, p in cpu[2].items():
        strong = np.abs(cpu[1][k]) > TRAIN_GRAD_TOL * gmax
        d = np.abs(card[2][k] - p)
        strong_err, weak_err = max(strong_err, float(d[strong].max(initial=0.0))), max(weak_err, float(d.max()))
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    spread = grad_errors(again[1], card[1])
    out["vs_cpu"] = dict(
        windows=2, frames=2, loss=card[0], cpu_loss=cpu[0], loss_rel_err=loss_rel, grad_err_of_largest=grad_err,
        grad_norm_rel_err=grad_norm_err, grad_worst_leaf=dict(name=leaf_worst[1], err_of_its_largest=leaf_worst[0]),
        params_err_strong=strong_err, params_err_all=weak_err, cpu_step_s=cpu_s,
        card_spread=dict(loss_rel=abs(again[0] - card[0]) / abs(card[0]), grad_err_of_largest=spread[0],
                         grad_norm_rel_err=spread[1], params_max=max(float(np.abs(again[2][k] - p).max())
                                                                    for k, p in card[2].items())),
        tolerances=dict(loss_rel=TRAIN_LOSS_REL, grad_err_of_largest=TRAIN_GRAD_TOL, grad_norm_rel=TRAIN_GRAD_NORM_REL,
                        params_strong=TRAIN_PARAM_TOL, params_all=2 * TRAIN_LR),
    )
    if not (loss_rel <= TRAIN_LOSS_REL and grad_err <= TRAIN_GRAD_TOL and grad_norm_err <= TRAIN_GRAD_NORM_REL
            and strong_err <= TRAIN_PARAM_TOL and weak_err <= 2 * TRAIN_LR):
        raise RuntimeError(f"train step, card against CPU: {out['vs_cpu']}")
    return out


# --------------------------------------------------------------------------
# the parallel phase: worlds of ranks over torch.distributed
# --------------------------------------------------------------------------


def spawn_world(target: str, kwargs: dict, world: int, workdir, backend: str, device: str,
                timeout: float = PARALLEL_TIMEOUT_S, threads=None) -> list:
    """Run ``target`` (a function of this script) on ``world`` ranks: each
    a fresh ``python3 chip_smoke.py --rank R <spec>`` process that joins a
    process group over a file store in ``workdir`` (no port to collide),
    with ``backend``, on ``device``, and calls ``target(**kwargs)``.
    Returns each rank's return value in rank order, with the seconds its
    ``init_distributed`` took as ``init_s``. If a rank fails or the
    ``timeout`` passes, every rank is killed and the error carries each
    rank's log. ``threads`` caps each rank's intra-op threads."""
    import pickle

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.pkl"
    spec.write_bytes(pickle.dumps(dict(
        target=target, kwargs=kwargs, world=world, store=f"file://{(workdir / 'store').resolve()}",
        backend=backend, device=device, threads=threads,
    )))
    procs, logs, failed = [], [], None
    try:
        for r in range(world):
            logs.append(open(workdir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), str(spec)],
                stdout=logs[-1], stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + timeout
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((f"rank {r} exited {p.returncode}" for r, p in enumerate(procs) if p.poll()), None)
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout} s"
            time.sleep(0.05)
        failed = failed or next((f"rank {r} exited {p.returncode}" for r, p in enumerate(procs) if p.returncode), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = "".join(f"\n--- rank {r} ---\n" + (workdir / f"rank{r}.log").read_text()[-4000:] for r in range(world))
        raise RuntimeError(f"{target} on {world} ranks: {failed}{tails}")
    return [pickle.loads((workdir / f"rank{r}.out").read_bytes()) for r in range(world)]


def _rank_main(rank: int, spec_path: str) -> int:
    """One rank of ``spawn_world``."""
    import pickle

    import torch

    from absolutetrack_tpu_torch.parallel import distributed

    spec = pickle.loads(Path(spec_path).read_bytes())
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    t0 = time.perf_counter()
    distributed.init_distributed(spec["store"], spec["world"], rank, spec["backend"], spec["device"])
    init_s = time.perf_counter() - t0
    out = dict(globals()[spec["target"]](**spec["kwargs"]), init_s=init_s)
    Path(spec_path).with_name(f"rank{rank}.out").write_bytes(pickle.dumps(out))
    if distributed.initialized():
        torch.distributed.destroy_process_group()
    return 0


def parallel_batch(cfg, b: int, t: int, seed: int):
    """The sharded steps' batch: ``synthetic_sequence_batch(b, t)`` (numpy)
    with sample masks that differ between the halves of the batch (the
    first half has fewer valid samples, so a mean of per-half means is
    not the batch's mean), and the scene's hand model in meters, (b,)."""
    from absolutetrack_tpu_torch.kinematics.hand_model import hand_model_from_dict, scaled_hand_model
    from absolutetrack_tpu_torch.training.synthetic import synthetic_sequence_batch

    batch = synthetic_sequence_batch(b, t=t, cfg=cfg, seed=seed)
    mask = np.ones((t, b), bool)
    mask[:, 0] = False  # the first half has fewer valid samples than the second
    mask[0, 1] = False
    hand = scaled_hand_model(hand_model_from_dict(synthetic_hand_model()), 0.001)
    return batch._replace(sample_mask=mask), hand.map(lambda x: x.expand((b,) + x.shape))


def _steps_model(cfg, seed: int, checkpoint, device):
    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel

    if checkpoint:
        return eval_lib.build_model(checkpoint, cfg, device=device)
    return UmeTrackModel(cfg, device=device, generator=torch.Generator().manual_seed(seed))


def steps_drill(seed: int, layouts, batch: int, t: int, tiny: bool, device: str, checkpoint=None,
                branch: str = "known") -> dict:
    """One rank's sharded train and eval steps, for each (data, model)
    layout of the world: from the model of ``checkpoint`` (else seeded)
    on ``parallel_batch``, the
    whole batch's loss, metrics and gradients before the optimizer
    (``loss_and_grads``), the eval step's outputs in the known and unknown
    branches, and the params after one train step. Rank 0 returns them all;
    every rank returns its loss and a digest of its params after the step,
    which must agree across ranks."""
    import hashlib

    import torch

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.parallel import make_mesh
    from absolutetrack_tpu_torch.training import train

    set_conv_precision("highest")
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    whole, hand = parallel_batch(cfg, batch, t, seed)
    out = {}
    for data, model_ax in layouts:
        mesh = make_mesh(data=data, model=model_ax, devices=device)
        model = _steps_model(cfg, seed, checkpoint, mesh.device)
        b, h = train.local_batch(mesh, whole, hand)
        loss, metrics, grads = train.loss_and_grads(model.requires_grad_(True), b, h, cfg, branch, mesh=mesh)
        evals = {br: train.make_eval_step(cfg, br, mesh)(model, b, h) for br in ("known", "unknown")}
        opt = train.make_optimizer(TRAIN_LR)
        state = train.init_train_state(model, opt)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step_metrics = train.make_train_step(cfg, opt, branch, mesh=mesh)(state, b, h)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        params = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
        digest = hashlib.sha1(b"".join(params[k].tobytes() for k in sorted(params))).hexdigest()
        res = dict(loss=float(loss), step_loss=float(step_metrics["total"]), params_digest=digest, step_s=step_s)
        if mesh.rank == 0:
            res.update(
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: g.cpu().numpy() for k, g in grads.items()},
                evals={br: {k: None if v is None else v.cpu().numpy() for k, v in ev.items()} for br, ev in evals.items()},
                params=params,
            )
        out[(data, model_ax)] = res
    return out


def one_process_steps(seed: int, batch: int, t: int, tiny: bool, device: str, checkpoint=None,
                      branch: str = "known") -> dict:
    """``steps_drill``'s numbers from one process without a mesh."""
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.training import train

    set_conv_precision("highest")
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    b, h = parallel_batch(cfg, batch, t, seed)
    model = _steps_model(cfg, seed, checkpoint, device)
    loss, metrics, grads = train.loss_and_grads(model.requires_grad_(True), b, h, cfg, branch)
    evals = {br: train.make_eval_step(cfg, br)(model, b, h) for br in ("known", "unknown")}
    opt = train.make_optimizer(TRAIN_LR)
    train.make_train_step(cfg, opt, branch)(train.init_train_state(model, opt), b, h)
    return dict(
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        grads={k: g.cpu().numpy() for k, g in grads.items()},
        evals={br: {k: None if v is None else v.cpu().numpy() for k, v in ev.items()} for br, ev in evals.items()},
        params={k: v.detach().cpu().numpy() for k, v in model.named_parameters()},
    )


class _ViewsInProcess:
    """A mesh's model axis acted out in one process, for one model index:
    ``local_views`` keeps that rank's views, ``gather_views`` adds the
    other ranks' features, computed by the same backbone at the same
    shapes without gradients (what the rank all-gathers)."""

    def __init__(self, model, n: int, index: int):
        self.model, self.n, self.index = model, n, index

    def local_views(self, x):
        self._images = x
        k = x.shape[1] // self.n
        return x[:, self.index * k : (self.index + 1) * k]

    def gather_views(self, feats):
        import torch

        k = self._images.shape[1] // self.n
        parts = []
        for m in range(self.n):
            if m == self.index:
                parts.append(feats)
                continue
            images = self._images[:, m * k : (m + 1) * k]
            b, v, hh, ww = images.shape
            with torch.no_grad():
                other = self.model.backbone(images.reshape(b * v, 1, hh, ww).to(self.model.backbone.stem.weight.dtype))
            parts.append(other.reshape((b, v) + other.shape[1:]))
        return torch.cat(parts, dim=1)


def partition_grads(seed: int, layout, batch: int, t: int, tiny: bool, device: str, checkpoint=None,
                    branch: str = "known") -> dict:
    """The gradients that a (data, model) ``layout`` sums, computed in one
    process with no collective: each data block's loss over the whole
    batch's valid count, each model index's views through the backbone
    (the others' features gathered in without gradients, ``_ViewsInProcess``),
    combined as ``loss_and_grads`` combines the ranks' (float64 here). On
    the card cuDNN picks its algorithms by shape, so a data block's or a
    view's gradients differ from the whole batch's in the last bits (and a
    ReLU at rounding distance of 0 may flip): this, not the whole batch, is
    what the ranks' sum must equal to the summation order."""
    import torch

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.parallel import Mesh
    from absolutetrack_tpu_torch.training import train

    set_conv_precision("highest")
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    whole, hand = parallel_batch(cfg, batch, t, seed)
    model = _steps_model(cfg, seed, checkpoint, device).requires_grad_(True)
    total = torch.tensor(float(whole.sample_mask.sum()), device=model.device)
    data, n_model = layout
    params = dict(model.named_parameters())
    grads = {n: np.zeros(p.shape) for n, p in params.items()}
    loss = 0.0
    for d in range(data):
        # data rank d's block (no process group: the mesh only places it)
        b, h = train.local_batch(Mesh(data, n_model, d * n_model, model.device), whole, hand)
        for m in range(n_model):
            shard = _ViewsInProcess(model, n_model, m) if n_model > 1 else None
            with torch.enable_grad():
                part, _ = train.loss_fn(model, b, h, cfg, branch, mask_total=total, view_shard=shard)
                gs = torch.autograd.grad(part, list(params.values()), allow_unused=True)
            for (n, p), g in zip(params.items(), gs):
                if g is not None and (m == 0 or n.startswith("backbone.")):
                    grads[n] += g.double().cpu().numpy()
            if m == 0:
                loss += float(part.detach())
    return dict(loss=loss, grads=grads)


def grad_errors(got: dict, want: dict) -> dict:
    """Gradients against gradients: the largest error over the largest |g|
    of all leaves, the worst leaf over its own largest, and in norm."""
    gmax = max(float(np.abs(g).max()) for g in want.values())
    norm = math.sqrt(sum(float(((got[k] - g) ** 2).sum()) for k, g in want.items()))
    return dict(
        of_largest=max(float(np.abs(got[k] - g).max()) for k, g in want.items()) / gmax,
        worst_leaf_of_its_largest=max(
            float(np.abs(got[k] - g).max() / max(np.abs(g).max(), 1e-30)) for k, g in want.items()
        ),
        norm_rel=norm / math.sqrt(sum(float((g ** 2).sum()) for g in want.values())),
    )


def steps_errors(got: dict, want: dict) -> dict:
    """A sharded layout's numbers against one process's: the loss's
    relative error, the gradients' largest error over the largest |g| of
    all leaves, over each leaf's own largest (the worst leaf) and in norm,
    the params after the step over each leaf's largest value, and the eval
    step's sums and outputs."""
    g = grad_errors(got["grads"], want["grads"])
    ek, wk = got["evals"]["known"], want["evals"]["known"]
    eu, wu = got["evals"]["unknown"], want["evals"]["unknown"]
    return dict(
        loss_rel=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        grad_err_of_largest=g["of_largest"],
        grad_worst_leaf_of_its_largest=g["worst_leaf_of_its_largest"],
        grad_norm_rel=g["norm_rel"],
        params_err_of_leaf_largest=max(
            float(np.abs(got["params"][k] - p).max() / max(np.abs(p).max(), 1e-30)) for k, p in want["params"].items()
        ),
        err_sum_rel=abs(float(ek["err_sum_m"]) - float(wk["err_sum_m"])) / abs(float(wk["err_sum_m"])),
        err_count_equal=float(ek["err_count"]) == float(wk["err_count"]),
        joint_angles_max=float(np.abs(ek["joint_angles"] - wk["joint_angles"]).max()),
        wrist_xfs_max=float(np.abs(ek["wrist_xfs"] - wk["wrist_xfs"]).max()),
        unknown_scales_rel=float(np.abs(eu["scales"] - wu["scales"]).max() / np.abs(wu["scales"]).max()),
    )


def eval_drill(label_files, checkpoint: str, max_frames: int, tiny: bool, device: str) -> dict:
    """One rank of ``multiprocess_eval.run_distributed_eval`` in the
    world it joined, K1's launches counted from 0 before it, the time of
    the group's first collective (a barrier: NCCL brings its communicator
    up there) and of one ``allreduce_metrics`` of its four sums."""
    import torch

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.ops import warp_kernel
    from absolutetrack_tpu_torch.parallel import allreduce_metrics, multiprocess_eval

    set_conv_precision("highest")
    t0 = time.perf_counter()
    torch.distributed.barrier()
    first_collective_s = time.perf_counter() - t0
    warp_kernel.K1.reset_counts()
    t0 = time.perf_counter()
    merged = multiprocess_eval.run_distributed_eval(
        label_files, cfg=ModelConfig.tiny() if tiny else None, checkpoint=checkpoint, max_frames=max_frames,
        device=device,
    )
    wall = time.perf_counter() - t0
    shapes = {f"N={n}": k for (n, _), k in sorted(warp_kernel.K1.shapes.items())}
    reduce_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        allreduce_metrics({k: merged[k] for k in ("err_sum", "err_count", "n_frames", "n_recordings")})
        reduce_ms.append((time.perf_counter() - t1) * 1e3)
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(merged=merged, wall_s=wall, k1_launches=shapes, allreduce_ms=float(np.median(reduce_ms)),
                first_collective_s=first_collective_s)


def lockstep_drill(seed: int, recordings: int, frames: int, tiny: bool, device: str) -> dict:
    """One rank of ``eval_lib.track_recordings_batched(mesh=)`` over a
    data mesh of the whole world: the lockstep phase's recordings (each
    rank tracks its contiguous block), K1's launches counted from 0 before
    it, its wall time, and the results of all recordings."""
    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.ops import warp_kernel
    from absolutetrack_tpu_torch.parallel import make_mesh

    set_conv_precision("highest")
    mesh = make_mesh(devices=device)
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    net = damped(UmeTrackModel(cfg, device=mesh.device, generator=torch.Generator().manual_seed(seed)))
    recs = scene_recordings(build_scene(seed + 1, n_frames=frames + recordings - 1), range(recordings), frames)
    run = lambda **kw: eval_lib.track_recordings_batched(  # noqa: E731
        net, recs, chunk_size=LOCKSTEP_CHUNK, pipelined=True, mesh=mesh, **kw
    )
    run(max_frames=LOCKSTEP_CHUNK)  # warm-up: cuDNN plans, the allocator
    warp_kernel.K1.reset_counts()
    t0 = time.perf_counter()
    results = run()
    wall = time.perf_counter() - t0
    shapes = {f"N={n}": k for (n, _), k in sorted(warp_kernel.K1.shapes.items())}
    return dict(results=results, wall_s=wall, k1_launches=shapes, frames_per_s=recordings * frames / wall)


def world_drill(parts: dict, tiny: bool, device: str) -> dict:
    """One rank's drills, in order: ``parts`` maps "eval", "lockstep",
    "steps", "allreduce" or "cli" to their keyword arguments. "allreduce"
    reduces ``values[rank]`` with ``allreduce_metrics``; "cli" is a list of
    (module, argv) whose ``main(argv)`` runs, with its printed lines."""
    import contextlib
    import importlib
    import io

    import torch

    from absolutetrack_tpu_torch.parallel import allreduce_metrics

    drills = {"eval": eval_drill, "lockstep": lockstep_drill, "steps": steps_drill}
    out = {}
    for name, kw in parts.items():
        if name == "allreduce":
            out[name] = allreduce_metrics(kw["values"][torch.distributed.get_rank()])
        elif name == "cli":
            out[name] = []
            for module, argv in kw:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    ret = importlib.import_module(module).main(argv)
                out[name].append(dict(lines=buf.getvalue().splitlines(), ret=ret))
        else:
            out[name] = drills[name](tiny=tiny, device=device, **kw)
    return out


def _launch_sum(shapes: dict) -> int:
    return sum(shapes.values())


def _sum_counts(counts) -> dict:
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def parallel_phase(seed: int, device: str = "cuda", tiny: bool = False, frames: int = PROTOCOL_FRAMES,
                   recordings: int = LOCKSTEP_RECORDINGS, lockstep_frames: int = LOCKSTEP_FRAMES,
                   threads=None) -> dict:
    """Sharding over processes, at full ``ModelConfig()`` width on the card
    (``tiny`` and ``device="cpu"``: its CPU rehearsal), each world spawned
    by ``spawn_world``: ``multiprocess_eval`` over the protocol phase's
    label tree from its reference-named ``.pt``, in one process without a
    group, at world 1 (NCCL on the card, with its init time and
    ``allreduce_metrics``'s) and over 2 gloo ranks (both on ``cuda:0``:
    NCCL refuses two ranks on one card), merged metrics against the
    group-less run; in the same 2-rank world the sharded lockstep
    (``track_recordings_batched(mesh=)``, the lockstep phase's recordings,
    each rank its half: K1 at N = 384 a chunk on the card) against one
    process, and one train step at (data, model) = (2, 1) and (1, 2)
    against one process (loss, gradients before the optimizer, params,
    the eval step, and the gradients against one process computing the
    same partition, ``partition_grads``); on the card also K1 at N = 384
    against its plain version, with its times; last, the demo's frame ring
    (``ring_transport``). K1's launches are every rank's together."""
    import tempfile

    import torch

    from absolutetrack_tpu_torch.apps import eval_lib
    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.models.layers import set_conv_precision
    from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
    from absolutetrack_tpu_torch.ops import warp_kernel
    from absolutetrack_tpu_torch.parallel import multiprocess_eval

    set_conv_precision("highest")
    on_card = device == "cuda"
    cfg = ModelConfig.tiny() if tiny else ModelConfig()
    r = PROTOCOL_RECORDINGS
    report = dict(world=PARALLEL_WORLD, backend_world1="nccl" if on_card else "gloo", backend_world2="gloo")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pt = root / "reference.pt"
        torch.save(reference_state_dict(cfg, seed), pt)
        data, _ = protocol_tree(root, build_scene(seed, frames + r - 1, mesh=True), r, frames)
        files = sorted(str(p) for p in data.rglob("*.json"))

        # 1. multiprocess_eval: without a group, at world 1, at world 2
        t0 = time.perf_counter()
        alone = multiprocess_eval.run_distributed_eval(
            files, cfg=cfg if tiny else None, checkpoint=str(pt), max_frames=frames, device=device
        )
        alone_s = time.perf_counter() - t0
        eval_kw = dict(label_files=files, checkpoint=str(pt), max_frames=frames)
        (w1,) = spawn_world("world_drill", dict(parts={"eval": eval_kw}, tiny=tiny, device=device), 1,
                            root / "w1", report["backend_world1"], device, threads=threads)
        steps_kw = dict(seed=seed, layouts=PARALLEL_LAYOUTS, batch=PARALLEL_BATCH, t=PARALLEL_T, checkpoint=str(pt))
        lock_kw = dict(seed=seed, recordings=recordings, frames=lockstep_frames)
        w2 = spawn_world("world_drill", dict(parts={"eval": eval_kw, "lockstep": lock_kw, "steps": steps_kw},
                                             tiny=tiny, device=device),
                         PARALLEL_WORLD, root / "w2", "gloo", device, threads=threads)
        one = one_process_steps(seed, PARALLEL_BATCH, PARALLEL_T, tiny, device, checkpoint=str(pt))
        partitions = {layout: partition_grads(seed, layout, PARALLEL_BATCH, PARALLEL_T, tiny, device, str(pt))
                      for layout in PARALLEL_LAYOUTS}
    want = {k: alone[k] for k in ("err_sum", "err_count", "n_frames", "n_recordings")}
    for name, merged in [("world1", w1["eval"]["merged"])] + [(f"world2_rank{i}", w["eval"]["merged"]) for i, w in enumerate(w2)]:
        counts_equal = all(merged[k] == want[k] for k in ("err_count", "n_frames", "n_recordings"))
        rel = abs(merged["err_sum"] - want["err_sum"]) / abs(want["err_sum"])
        if not counts_equal or rel > PARALLEL_EVAL_REL or want["err_count"] == 0:
            raise RuntimeError(f"multiprocess_eval {name}: {merged} against one process {alone}")
    report["eval"] = dict(
        recordings=r, frames_per_recording=frames, alone=alone, alone_s=alone_s,
        world1=dict(merged=w1["eval"]["merged"], init_s=w1["init_s"], wall_s=w1["eval"]["wall_s"],
                    first_collective_s=w1["eval"]["first_collective_s"],
                    allreduce_ms=w1["eval"]["allreduce_ms"], k1_launches=w1["eval"]["k1_launches"]),
        world2=[dict(merged=w["eval"]["merged"], init_s=w["init_s"], wall_s=w["eval"]["wall_s"],
                     first_collective_s=w["eval"]["first_collective_s"],
                     allreduce_ms=w["eval"]["allreduce_ms"], k1_launches=w["eval"]["k1_launches"]) for w in w2],
        err_sum_rel_tol=PARALLEL_EVAL_REL,
        frames_per_s=dict(alone=r * frames / alone_s, world1=r * frames / w1["eval"]["wall_s"],
                          world2=r * frames / max(w["eval"]["wall_s"] for w in w2)),
    )

    # 2. the sharded lockstep against one process
    net = damped(UmeTrackModel(cfg, device=device, generator=torch.Generator().manual_seed(seed)))
    recs = scene_recordings(build_scene(seed + 1, n_frames=lockstep_frames + recordings - 1), range(recordings),
                            lockstep_frames)
    whole = eval_lib.track_recordings_batched(net, recs, chunk_size=LOCKSTEP_CHUNK, pipelined=True)
    lm = 0.0
    for w in w2:
        got = w["lockstep"]["results"]
        if len(got) != recordings:
            raise RuntimeError(f"sharded lockstep: a rank returned {len(got)} of {recordings} results")
        for a, b in zip(got, whole):
            if not np.array_equal(a.valid_tracking, b.valid_tracking) or not a.valid_tracking.any():
                raise RuntimeError("sharded lockstep: validity differs from one process, or no hand tracked")
            v = a.valid_tracking
            lm = max(lm, float(np.linalg.norm(a.tracked_keypoints - b.tracked_keypoints, axis=-1)[v].max()))
    if lm > PARALLEL_LANDMARK_MM:
        raise RuntimeError(f"sharded lockstep against one process: {lm} mm")
    report["lockstep"] = dict(
        recordings=recordings, frames_per_recording=lockstep_frames, chunk=LOCKSTEP_CHUNK,
        ranks=[dict(wall_s=w["lockstep"]["wall_s"], frames_per_s_of_all=w["lockstep"]["frames_per_s"],
                    k1_launches=w["lockstep"]["k1_launches"]) for w in w2],
        vs_one_process_landmark_max_err_mm=lm, tolerance_mm=PARALLEL_LANDMARK_MM,
    )

    # 3. the train and eval steps against one process
    steps = {}
    for layout in PARALLEL_LAYOUTS:
        ranks = [w["steps"][layout] for w in w2]
        if len({x["params_digest"] for x in ranks}) != 1:
            raise RuntimeError(f"layout {layout}: the ranks' params differ after the step")
        errs = steps_errors(ranks[0], one)
        part = partitions[layout]
        same_partition = dict(grad_errors(ranks[0]["grads"], part["grads"]),
                              loss_rel=abs(ranks[0]["loss"] - part["loss"]) / abs(part["loss"]))
        steps[f"{layout[0]}x{layout[1]}"] = dict(errs, step_s=[x["step_s"] for x in ranks],
                                                 vs_one_process_same_partition=same_partition)
        if not (same_partition["loss_rel"] <= PARALLEL_PARTITION_REL
                and same_partition["of_largest"] <= PARALLEL_PARTITION_REL
                and same_partition["norm_rel"] <= PARALLEL_PARTITION_REL):
            raise RuntimeError(f"sharded step {layout} against one process on the same partition: {same_partition}")
        if not (errs["loss_rel"] <= TRAIN_LOSS_REL and errs["grad_err_of_largest"] <= TRAIN_GRAD_TOL
                and errs["err_count_equal"]
                and errs["err_sum_rel"] <= PARALLEL_EVAL_STEP_REL and errs["joint_angles_max"] <= PARALLEL_OUTPUT_TOL
                and errs["wrist_xfs_max"] <= PARALLEL_OUTPUT_TOL and errs["params_err_of_leaf_largest"] <= 1e-2):
            raise RuntimeError(f"sharded step {layout} against one process: {errs}")
    report["steps"] = dict(
        batch=PARALLEL_BATCH, frames=PARALLEL_T, layouts=steps,
        tolerances=dict(loss_rel=TRAIN_LOSS_REL, grad_err_of_largest=TRAIN_GRAD_TOL,
                        err_sum_rel=PARALLEL_EVAL_STEP_REL, outputs=PARALLEL_OUTPUT_TOL, params_of_leaf_largest=1e-2,
                        same_partition_loss_grads_largest_and_norm=PARALLEL_PARTITION_REL),
    )

    if on_card:  # the card's f32 frames and models sample with f32 rows
        p = cfg.input_size[0] * cfg.input_size[1]
        chunks = -(-frames // LOCKSTEP_CHUNK)
        want = {f"N={LOCKSTEP_CHUNK * 4}": r * chunks}
        got = [w1["eval"]["k1_launches"], _sum_counts(w["eval"]["k1_launches"] for w in w2)]
        per_rank = recordings // PARALLEL_WORLD * LOCKSTEP_CHUNK * 4
        lock_want = {f"N={per_rank}": -(-lockstep_frames // LOCKSTEP_CHUNK)}
        if got != [want, want] or any(w["lockstep"]["k1_launches"] != lock_want for w in w2):
            raise RuntimeError(f"parallel K1 launches: eval {got}, want {want} in each world; lockstep "
                               f"{[w['lockstep']['k1_launches'] for w in w2]}, want {lock_want} a rank (P={p})")
    launches = {"parallel_eval_world1": _launch_sum(w1["eval"]["k1_launches"]),
                "parallel_eval_world2": sum(_launch_sum(w["eval"]["k1_launches"]) for w in w2),
                "parallel_lockstep_world2": sum(_launch_sum(w["lockstep"]["k1_launches"]) for w in w2)}
    report["k1_launches_by_path"] = launches
    report["k1_launches"] = sum(launches.values())

    # 4. K1 at the sharded chunk's shape, N = 384, against its plain version
    if on_card:
        half = recs[: recordings // PARALLEL_WORLD]
        recorder = _RecordCalls(warp_kernel.K1)
        warp_kernel.K1 = recorder
        try:
            eval_lib.track_recordings_batched(net, half, chunk_size=LOCKSTEP_CHUNK, pipelined=True,
                                              max_frames=LOCKSTEP_CHUNK)
        finally:
            warp_kernel.K1 = recorder.kernel
        images, ii, xs, ys, valid_hw, _ = recorder.calls[0]
        del recorder
        err = max(k1_error(images, ii, xs, ys, valid_hw, mode) for mode in row_modes(images.dtype))
        if err > K1_TOL:
            raise RuntimeError(f"K1 at N={xs.shape[0]}: max |err| {err} > {K1_TOL}")
        report["k1_n384"] = dict(k1_timings(images, ii, xs, ys, iters=20), max_abs_err=err, n=int(xs.shape[0]))
        del images, ii, xs, ys
        torch.cuda.empty_cache()
    report["ring"] = ring_transport()
    return report


def ring_transport(frames: int = RING_FRAMES) -> dict:
    """The demo's frame ring (``apps/demo/multiprocess.py``, the native
    library built from ``native/abstrack_host.cpp`` on this machine): a
    spawned capture process pushes one static (2, 480, 640) uint8 frame
    ``frames`` times without a pause; this process pops. The ms a frame
    between the first frame received and the last, and the frames that
    drop-oldest skipped."""
    from absolutetrack_tpu_torch.apps.demo.multiprocess import run_multiprocess_demo
    from absolutetrack_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.HOST.build()
    build_s = time.perf_counter() - t0
    seen = []
    n = run_multiprocess_demo(max_frames=frames, source_kind="synthetic_static", throttle_s=0.0,
                              on_frame=lambda i, mono: seen.append((i, mono.shape, mono.dtype, time.perf_counter())))
    idx = [s[0] for s in seen]
    if n < 2 or idx != sorted(set(idx)) or any(s[1:3] != ((2, 480, 640), np.uint8) for s in seen):
        raise RuntimeError(f"frame ring: {n} frames, indices {idx[:10]}...")
    return dict(frames_pushed=frames, frames_received=n, skipped=idx[-1] + 1 - n, build_s=build_s,
                transport_ms_per_frame=(seen[-1][3] - seen[0][3]) / (n - 1) * 1e3)


def main(seed: int = 0) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import absolutetrack_tpu_torch

    # the port must come from this checkout, not from elsewhere on sys.path
    port_root = Path(absolutetrack_tpu_torch.__file__).resolve().parents[1]
    if port_root != Path(__file__).resolve().parent:
        print(f"chip_smoke: the port was imported from {port_root}, not beside this script", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from absolutetrack_tpu_torch.models.config import ModelConfig
    from absolutetrack_tpu_torch.ops import warp_kernel

    t0 = time.perf_counter()
    warp_kernel.K1.build()
    print(f"K1 built in {time.perf_counter() - t0:.1f} s", flush=True)

    scene = build_scene(seed)
    ts = torch_scene(scene, "cuda")
    k = kernel_phase(ts, ModelConfig().input_size)
    path = path_phase(scene, ts, seed)
    del ts
    lockstep = lockstep_phase(seed)
    demo = demo_phase(seed)
    protocol = protocol_phase(seed)
    data = data_phase(seed)
    train = train_phase(seed)
    parallel = parallel_phase(seed)

    n768 = lockstep["k1_n768"]
    print(json.dumps({"path": path, "card": smi}))
    print(json.dumps({"lockstep": lockstep, "card": smi}))
    print(json.dumps({"demo": demo, "card": smi}))
    print(json.dumps({"protocol": protocol, "card": smi}))
    print(json.dumps({"data": data, "card": smi}))
    print(json.dumps({"train": train, "card": smi}))
    print(json.dumps({"parallel": parallel, "card": smi}))
    print(json.dumps({"kernels": [{
        "name": "bilinear_sample",
        "route": "cuda",
        "source": "absolutetrack_tpu_torch/csrc/bilinear_sample.cu",
        "replaces": "absolutetrack_tpu/ops/pallas_warp.py:224 (_fused_warp_kernel); "
                    ":195 (_narrow_warp_kernel); :281 (_overflow_warp_kernel); "
                    ":307 (_banded_warp_kernel); :322 (_covering_warp_kernel); "
                    "pallas_warp.py:127-173 (int8 row mix, row f); "
                    "pallas_warp.py:174-186 (bf16 row mix, row g)",
        "launches": path["k1_launches"] + lockstep["k1_launches"]
        + demo["parity"]["k1_launches"] + demo["serving"]["k1_launches"] + protocol["k1_launches"]
        + data["k1_launches"] + train["k1_launches"] + parallel["k1_launches"],
        "launches_by_path": {
            "sequential": path["k1_launches"], "lockstep": lockstep["k1_launches"],
            "demo_parity_f32_rows": demo["parity"]["k1_launches"],
            "demo_serving_bf16_rows": demo["serving"]["k1_launches"],
            **{f"protocol_{name}": run["k1_launches"] for name, run in protocol["runs"].items()},
            "protocol_serving_bf16_rows": protocol["serving"]["k1_launches"],
            "data_rectify": sum(data["pack"]["k1_launches"].values()),
            "data_windows": sum(data["w_batch"]["k1_launches"].values()) + sum(data["w1"]["k1_launches"].values()),
            "data_windows_serving_bf16_rows": sum(data["serving"]["k1_launches"].values()),
            "train_packed": sum(train["packed"]["k1_launches"].values()) + sum(train["resume"]["k1_launches"].values()),
            "train_rendered": sum(train["rendered"]["k1_launches"].values()),
            **parallel["k1_launches_by_path"],
        },
        "max_abs_err": max(
            k["max_abs_err"], n768["max_abs_err"], n768["n1024_max_abs_err"],
            n768["bf16_rows_f32_bf16_views_max_abs_err"],
            *(v["max_abs_err"] if isinstance(v, dict) else v for v in protocol["k1"].values()),
            *(v["max_abs_err"] for v in data["k1"].values()),
            train["k1"]["max_abs_err"], parallel["k1_n384"]["max_abs_err"],
        ),
        "tolerance": K1_TOL,
        "checked": "every row-weight mode (f32, bf16, int8 on uint8 views), every dtype, cases "
        + ", ".join(k["cases"]),
        **k["n4"],
        "shape": "N=4 P=9216 uint8 512x640 (valid 480x636): the sequential path",
        "n96": dict(k["n96"], shape="N=96: the non-pipelined lockstep frame"),
        "n768": dict(n768, shape="N=768: the pipelined lockstep chunk (24 recordings x 8 frames x 4 slots)"),
        "n32": dict(protocol["k1"]["n32"], shape="N=32: the eval protocol's chunk, one recording (8 frames x 4 slots)"),
        "n128": dict(protocol["k1"]["n128"], shape="N=128: the eval protocol's lockstep chunk (4 recordings)"),
        "n4_full_frame": dict(data["k1"]["n4_full_frame"], shape="N=4 P=305,280 f32 480x636: pack_sample_data's rectify, 4 whole frames"),
        "n16_windows": dict(data["k1"]["n16_windows"], shape="N=16 P=9,216 f32 480x636 views: a packed window's homography warp (8 frames x 2 views)"),
        "n128_rendered": dict(train["k1"], shape="N=128 P=9,216 uint8 480x636 mesh frames: a rendered training chunk (16 windows x 2 frames x 4 slots)"),
        "n384": dict(parallel["k1_n384"], shape="N=384 P=9,216 uint8 512x640 (valid 480x636): a rank's chunk of the lockstep sharded over 2 ranks (12 recordings x 8 frames x 4 slots)"),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of spawn_world
        sys.exit(_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
