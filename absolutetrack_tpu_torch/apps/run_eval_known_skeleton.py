"""Known-skeleton evaluation over recordings (port of
``absolutetrack_tpu/apps/run_eval_known_skeleton.py``).

Walks a data root for ``*.json`` label files (with an optional sibling
``.mp4``; without one the frames are rendered), tracks each sequence with
crops from its GT poses and the user's own hand model, and writes one
result ``.npy`` file (a pickled dict) per sequence for ``load_eval``.
Sequences shard across processes by (rank, world size); within a
process ``--batch-recordings N`` tracks N sequences in lockstep on the
card. ``--torch-device`` picks the device (``cuda`` unless given).

``--mesh-data D`` splits each lockstep group over D ranks of a
``torch.distributed`` world, one rank per card (each tracks N / D of the
group; rank 0 writes the results). Launch the D ranks with torchrun;
``--backend gloo`` lets several ranks share one card (NCCL refuses that)
or run on the CPU. The mesh is separate from ``--rank``/``--world-size``,
which split the label files between independent runs.

Usage:
  python -m absolutetrack_tpu_torch.apps.run_eval_known_skeleton \
      --input-dir /path/to/raw_data/real --output-dir tmp/eval_known \
      [--checkpoint pretrained_weights.torch] [--rank 0 --world-size 1]
  torchrun --nproc-per-node 2 -m absolutetrack_tpu_torch.apps.run_eval_known_skeleton \
      --input-dir ... --batch-recordings 8 --mesh-data 2
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import pickle

import numpy as np

from . import eval_lib
from ..models.config import ModelConfig
from ..models.layers import set_conv_precision
from ..parallel import init_distributed, make_mesh
from ..tracker.video_data import load_labels


def find_label_files(input_dir: str, test_only: bool = True):
    out = []
    for cur, _dirs, files in sorted(os.walk(input_dir)):
        if test_only and "testing" not in cur:
            continue
        for f in sorted(fnmatch.filter(files, "*.json")):
            if f.startswith("."):  # AppleDouble/hidden files (._foo.json)
                continue
            out.append(os.path.join(cur, f))
    return out


def add_common_args(ap: argparse.ArgumentParser, output_dir: str) -> None:
    """The flags both eval CLIs share."""
    ap.add_argument("--input-dir", default="sample_data")
    ap.add_argument("--output-dir", default=output_dir)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--precision", choices=["parity", "serving"], default="parity",
        help="serving = bf16 conv trunk, f32 geometry and solvers (ModelConfig.serving())",
    )
    ap.add_argument("--torch-device", default="cuda", help="the device the tracker runs on")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--override", action="store_true")
    ap.add_argument(
        "--tiny-arch", action="store_true",
        help="ModelConfig.tiny(): full topology at reduced width and crop size",
    )
    ap.add_argument(
        "--batch-recordings", type=int, default=1,
        help="track N sequences in lockstep per chunk",
    )
    ap.add_argument(
        "--mesh-data", type=int, default=1,
        help="split each lockstep group over this many ranks of a torch.distributed world (torchrun)",
    )
    ap.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="--mesh-data's process group backend (nccl on cards, gloo on the CPU unless given; "
        "ranks that share one card need gloo)",
    )
    ap.add_argument(
        "--renderer", choices=["mesh", "blobs"], default="mesh",
        help="synthetic frames when the mp4 is absent (mesh silhouettes or landmark blobs)",
    )


def setup(args):
    """(label files of this rank, the model, the mesh or None) for parsed
    common flags; ``--mesh-data > 1`` joins the process group that
    torchrun describes, and raises without one of that many ranks."""
    mesh, device = None, args.torch_device
    if args.mesh_data > 1:
        init_distributed(backend=args.backend, device=device)
        mesh = make_mesh(data=args.mesh_data, model=1, devices=device)
        device = mesh.device
    label_files = find_label_files(args.input_dir, args.test_only)[args.rank :: args.world_size]
    if args.tiny_arch:
        mcfg = ModelConfig.tiny(compute_dtype="bfloat16") if args.precision == "serving" else ModelConfig.tiny()
    else:
        mcfg = ModelConfig.serving() if args.precision == "serving" else ModelConfig()
    set_conv_precision("highest")  # f32 convs and matmuls without TF32, as the JAX package's HIGHEST
    return label_files, eval_lib.build_model(args.checkpoint, cfg=mcfg, device=device), mesh


def pending_outputs(args, label_files, mesh=None):
    """[(label file, relative name, output path)] whose result is still to
    write; under a mesh every rank lists them before rank 0 writes any."""
    pending = []
    for lf in label_files:
        rel = os.path.relpath(lf, args.input_dir)[:-5]
        out_path = os.path.join(args.output_dir, rel + ".npy")
        if not args.override and os.path.exists(out_path):
            if is_writer(mesh):
                print(f"skip {rel} (exists)")
            continue
        pending.append((lf, rel, out_path))
    if mesh is not None:
        mesh.barrier()
    return pending


def is_writer(mesh) -> bool:
    """Rank 0 of a mesh writes and prints; without one, the process."""
    return mesh is None or mesh.rank == 0


def write_result(out_path: str, res, write: bool = True, **extra) -> np.ndarray:
    """Pickle a sequence's result as the reference does (if ``write``);
    returns the mean keypoint error of each valid hand-frame."""
    if write:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump(
                {
                    "tracked_keypoints": res.tracked_keypoints,
                    "gt_keypoints": res.gt_keypoints,
                    "valid_tracking": res.valid_tracking,
                    **extra,
                },
                f,
            )
    return np.linalg.norm((res.gt_keypoints - res.tracked_keypoints)[res.valid_tracking], axis=-1).mean(-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "tmp/eval_results_known_skeleton")
    args = ap.parse_args(argv)

    label_files, model, mesh = setup(args)
    log = print if is_writer(mesh) else (lambda *a, **k: None)
    log(f"[rank {args.rank}] {len(label_files)} sequences")
    errors = []

    def save_result(rel, out_path, res):
        err = write_result(out_path, res, is_writer(mesh))
        errors.append(err)
        log(f"{rel}: mean keypoint error {err.mean():.2f} mm ({res.valid_tracking.sum()} tracked)")

    pending = pending_outputs(args, label_files, mesh)
    b = max(1, args.batch_recordings)
    for i in range(0, len(pending), b):
        group = pending[i : i + b]
        if len(group) == 1 or b == 1:
            for lf, rel, out_path in group:
                labels = load_labels(lf)
                frames = eval_lib.frames_for(labels, lf[:-5] + ".mp4", args.renderer)
                res = eval_lib.track_recording(model, labels, frames, min_num_crops=1, max_frames=args.max_frames)
                save_result(rel, out_path, res)
        else:
            recs = []
            for lf, _rel, _out in group:
                labels = load_labels(lf)
                recs.append((labels, eval_lib.frames_for(labels, lf[:-5] + ".mp4", args.renderer)))
            results = eval_lib.track_recordings_batched(
                model, recs, min_num_crops=1, max_frames=args.max_frames, mesh=mesh
            )
            for (lf, rel, out_path), res in zip(group, results):
                save_result(rel, out_path, res)

    if errors:
        log(f"Final mean error: {np.concatenate(errors).mean():.3f} mm")


if __name__ == "__main__":
    main()
