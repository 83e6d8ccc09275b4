"""Inference on packed torch_data (port of
``absolutetrack_tpu/apps/run_inference_torch_data.py``).

Discover packed folders, shard them over (rank, world size), preprocess
each window on a prefetch thread (crop cameras and the homography warp on
the device: K1 on the card), scan the known-skeleton network over the
window's frames (``use_memory`` off only at t = 0) one window at a time or
W windows in lockstep, then FK and the mm landmark error. ``--torch-device``
picks the device (``cuda`` unless given).

``--mesh-data D`` splits each group of W windows over D ranks of a
``torch.distributed`` world, one rank per card: each preprocesses and runs
its contiguous W / D, the per-window errors are gathered in order and rank
0 prints. Launch the D ranks with torchrun; ``--backend gloo`` lets
several ranks share one card (NCCL refuses that) or run on the CPU.

Usage:
  python -m absolutetrack_tpu_torch.apps.run_inference_torch_data \
      --data-root tmp/torch_data [--checkpoint weights.torch] [--batch-windows 16]
  torchrun --nproc-per-node 2 -m absolutetrack_tpu_torch.apps.run_inference_torch_data \
      --data-root tmp/torch_data --batch-windows 16 --mesh-data 2
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from . import eval_lib
from ..data import PackedDataset, PrefetchIterator, ShardSampler, find_dataset_folders
from ..data.transform import PackedSequence, preprocess_packed
from ..kinematics.hand_model import HandModel, stack_hand_models
from ..kinematics.skinning import skin_landmarks
from ..models.config import ModelConfig
from ..models.layers import set_conv_precision
from ..models.umetrack import FrameInputs, SkeletonInputs
from ..parallel import init_distributed, make_mesh

M_TO_MM = 1000.0


def eval_window(model, seq: PackedSequence, use_memory_t0: bool = False, n_views: int | None = None) -> torch.Tensor:
    """One preprocessed window -> (T,) per-frame landmark error in mm.
    ``n_views`` below the stored view count runs the single-view path (the
    other view slots masked out and their images zeroed)."""
    return eval_windows_batched(model, stack_windows([seq]), use_memory_t0, n_views)[0]


@torch.no_grad()
def eval_windows_batched(model, seqs: PackedSequence, use_memory_t0: bool = False,
                         n_views: int | None = None) -> torch.Tensor:
    """W windows stacked on a leading axis (fields (W, T, ...)), stepped in
    lockstep over T -> (W, T) per-frame landmark errors in mm. Each
    window's result is that of its own run: the windows share no state."""
    imgs = seqs.left_images  # (W, T, V, h, w)
    b, t, v = imgs.shape[:3]
    dev = imgs.device
    state = model.init_state(b)
    skel = SkeletonInputs(
        joint_rotation_axes=seqs.gt_hand_model.joint_rotation_axes,
        joint_rest_positions=seqs.gt_hand_model.joint_rest_positions,
    )
    view_mask = torch.arange(v, device=dev) < (v if n_views is None else n_views)  # (V,)
    vm_b = view_mask.expand(b, v)
    angles, wrists = [], []
    for i in range(t):
        use_memory = i > (0 if not use_memory_t0 else -1)
        frame = FrameInputs(
            left_images=torch.where(view_mask[None, :, None, None], imgs[:, i], 0.0),
            intrinsics=seqs.intrinsics[:, i],
            extrinsics=seqs.extrinsics[:, i],
            view_mask=vm_b,
            hand_idx=seqs.hand_idx,
            use_memory=torch.full((b,), use_memory, device=dev),
            sample_mask=torch.ones(b, dtype=torch.bool, device=dev),
        )
        state, out = model.regress_pose_use_skeleton(state, frame, skel)
        angles.append(out.joint_angles)
        wrists.append(out.wrist_xfs)
    # the model's wrist is world-space with the right-hand mirror; the
    # labels are left-canonical, so undo the mirror before FK
    wrist_left = torch.stack(wrists).clone()  # (T, W, 4, 4)
    wrist_left[..., :, 0] = wrist_left[..., :, 0] * torch.where(seqs.hand_idx == 1, -1.0, 1.0)[:, None]
    hand_tb = seqs.gt_hand_model.map(lambda x: x.expand((t,) + x.shape))
    pred_lm = skin_landmarks(hand_tb, torch.stack(angles), wrist_left)
    gt_lm = skin_landmarks(hand_tb, seqs.gt_joint_angles.transpose(0, 1), seqs.gt_wrist.transpose(0, 1))
    err = torch.linalg.norm(pred_lm - gt_lm, dim=-1).mean(-1)  # (T, W)
    return err.T * M_TO_MM


def stack_windows(seqs) -> PackedSequence:
    """Uniform-T PackedSequences -> one PackedSequence with a leading W axis."""
    t0 = seqs[0].left_images.shape[0]
    if not all(s.left_images.shape[0] == t0 for s in seqs):
        raise ValueError("batched window eval needs uniform window length")
    return PackedSequence(*(
        stack_hand_models(list(xs)) if isinstance(xs[0], HandModel) else torch.stack(xs)
        for xs in zip(*seqs)
    ))


def main(argv=None):
    """Returns (the (n, T) per-frame errors in mm of the windows run, the
    seconds of the evaluation loop), beside the printed lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="tmp/torch_data")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--precision", choices=["parity", "serving"], default="parity",
        help="serving = bf16 conv trunk and bf16 row weights in the crop warp, "
        "f32 geometry (ModelConfig.serving())",
    )
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--prefetch", type=int, default=4)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--views", type=int, default=None,
                    help="restrict to the first N views (1 = single-view path)")
    ap.add_argument("--batch-windows", type=int, default=1,
                    help="evaluate W windows per step in lockstep (the reference runs bs=160)")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="split each group of windows over this many ranks of a torch.distributed world "
                    "(torchrun; requires --batch-windows divisible by it)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="--mesh-data's process group backend (nccl on cards, gloo on the CPU unless given; "
                    "ranks that share one card need gloo)")
    ap.add_argument("--torch-device", default="cuda", help="the device the network runs on")
    args = ap.parse_args(argv)
    mesh, device = None, args.torch_device
    if args.mesh_data is not None and args.mesh_data > 1:
        if args.batch_windows % args.mesh_data:
            raise ValueError("--batch-windows % --mesh-data != 0")
        init_distributed(backend=args.backend, device=device)
        mesh = make_mesh(data=args.mesh_data, model=1, devices=device)
        device = mesh.device
    log = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    folders = find_dataset_folders(args.data_root, ["mono", "labels"])
    if not folders:
        raise SystemExit(
            f"no packed folders under {args.data_root}; run "
            "`python -m absolutetrack_tpu_torch.apps.pack_sample_data` first"
        )
    ds = PackedDataset(folders, ["mono", "labels"])
    sampler = ShardSampler(len(ds), args.rank, args.world_size)
    log(f"[rank {args.rank}] {len(sampler)} windows from {len(folders)} folders")

    mcfg = ModelConfig.serving() if args.precision == "serving" else ModelConfig()
    set_conv_precision("highest")  # f32 convs and matmuls without TF32, as the JAX package's HIGHEST
    model = eval_lib.build_model(args.checkpoint, cfg=mcfg, device=device)
    device = model.device
    # the prefetch thread launches the warp on the stream that the network
    # runs on, so the network reads the crops after they are written
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

    def load(i):
        s = ds[i]
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            return preprocess_packed(
                np.asarray(s["mono"]), s["labels"], device=device, bf16_rows=args.precision == "serving"
            )

    indices = list(sampler)[: args.limit]
    errors = []
    t0 = time.time()
    if args.batch_windows > 1:
        w = args.batch_windows

        # this rank's contiguous block of each group padded to W (all of it without a mesh)
        lo, hi = (0, w) if mesh is None else (mesh.data_index * w // mesh.data, (mesh.data_index + 1) * w // mesh.data)

        def load_group(g):
            seqs = [load(i) for i in g[lo:hi]] or [load(g[-1])]
            return stack_windows(seqs + [seqs[-1]] * (hi - lo - len(seqs))), len(g)

        groups = [indices[i : i + w] for i in range(0, len(indices), w)]
        n_frames = 0
        for stacked, n_real in PrefetchIterator(map(load_group, groups), max_prefetch=args.prefetch):
            err = eval_windows_batched(model, stacked, n_views=args.views).cpu()  # (W or W / D, T)
            if mesh is not None:
                err = torch.cat(list(mesh.grid(err)[:, 0]))
            err = err[:n_real].numpy()  # (n_real, T)
            errors.extend(err)
            n_frames += err.size
            log(f"group of {n_real}: {err.mean():.2f} mm")
        dt = time.time() - t0
        log(f"throughput: {len(errors) / dt:.1f} windows/s "
              f"({n_frames / dt:.0f} frames/s) at W={w}")
    else:
        for seq in PrefetchIterator(map(load, indices), max_prefetch=args.prefetch):
            err = eval_window(model, seq, n_views=args.views).cpu().numpy()
            errors.append(err)
            log(f"window error: {err.mean():.2f} mm")
    seconds = time.time() - t0
    if errors:
        log(f"Mean landmark error: {np.concatenate(errors).mean():.3f} mm "
              f"over {len(errors)} windows")
    return np.asarray(errors), seconds


if __name__ == "__main__":
    main()
