"""Training entry point (port of ``absolutetrack_tpu/apps/train.py``).

Trains UmeTrack on packed windows (the default: each window preprocessed
on the prefetch thread, K1 on the card), on windows rendered from label
JSONs through the tracker's crop/warp path (``--rendered``: K1 once a
chunk of windows), or on the synthetic blob task (``--synthetic``), with
the sequence loss and the optimizer of ``training/``. Saves the params
and the whole train state (``<save>.train``, which ``--resume`` reads), in
the JAX package's bytes. Runs on ``cuda`` unless ``--torch-device`` says
otherwise.

Several cards run one rank each in a ``torch.distributed`` world launched
by torchrun, as a (world / M, M) mesh with M = ``--model-axis`` when it
divides the world (else 1), as JAX's trainer lays its devices: every rank
draws the same windows from ``default_rng(seed)`` and takes its block of
the batch ('data'), and of each sample's views ('model'); rank 0 prints
and saves. ``--backend gloo`` lets several ranks share one card (NCCL
refuses that) or run on the CPU. One process with several visible cards
raises: launch one rank per card.

Usage:
  python -m absolutetrack_tpu_torch.apps.train --data-root tmp/torch_data \
      --steps 100 --batch 8 [--checkpoint init.msgpack] [--save out.msgpack]
  torchrun --nproc-per-node 2 -m absolutetrack_tpu_torch.apps.train --data-root tmp/torch_data \
      --steps 100 --batch 8 [--model-axis 2]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from . import eval_lib
from ..data import PackedDataset, PrefetchIterator, find_dataset_folders
from ..data.transform import preprocess_packed
from ..kinematics.hand_model import HandModel, stack_hand_models
from ..models.checkpoint import load_any, load_train_state, save_params, save_train_state
from ..models.config import ModelConfig
from ..models.layers import set_conv_precision
from ..models.params import load_jax_params
from ..parallel import init_distributed, make_mesh
from ..training import make_eval_step, make_train_step
from ..training.synthetic import GENERIC_HAND_MODEL
from ..training.train import SequenceBatch, init_train_state, local_batch, make_optimizer, to_device

RENDERED_ROOT = "/root/reference/sample_data/user05"


def windows_to_batch(seqs) -> tuple[SequenceBatch, HandModel]:
    """Stack preprocessed PackedSequences into a time-major SequenceBatch."""
    t, b = seqs[0].left_images.shape[0], len(seqs)
    dev = seqs[0].left_images.device

    def stack(field):
        return torch.stack([getattr(s, field) for s in seqs], dim=1)  # (T, B, ...)

    use_mem = torch.ones((t, b), dtype=torch.bool, device=dev)
    use_mem[0] = False
    hand = stack_hand_models([s.gt_hand_model for s in seqs])
    batch = SequenceBatch(
        images=stack("left_images"),
        intrinsics=stack("intrinsics"),
        extrinsics=stack("extrinsics"),
        use_memory=use_mem,
        sample_mask=torch.ones((t, b), dtype=torch.bool, device=dev),
        hand_idx=torch.stack([s.hand_idx for s in seqs]),
        skel_axes=hand.joint_rotation_axes,
        skel_rest=hand.joint_rest_positions,
        gt_joint_angles=stack("gt_joint_angles"),
        gt_wrist=stack("gt_wrist"),
        gt_log_scale=torch.zeros(b, device=dev),
    )
    return batch, hand


def _device(name: str) -> torch.device:
    """The device of a one-process run."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --torch-device cpu to train on the CPU")
        if torch.cuda.device_count() > 1:
            n = torch.cuda.device_count()
            raise RuntimeError(
                f"{n} cards are visible to one process; the port trains with one rank per card: "
                f"`torchrun --nproc-per-node {n} -m absolutetrack_tpu_torch.apps.train ...`, "
                "or make one card visible (CUDA_VISIBLE_DEVICES)"
            )
    return device


def _block(mesh, n: int) -> slice:
    """This rank's contiguous block of a batch of ``n`` (all of it without a mesh)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.data:
        raise ValueError(f"a batch of {n} does not split over a data axis of {mesh.data}")
    k = n // mesh.data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def main(argv=None):
    """Returns {"state": the final TrainState, "metrics": each step's metric
    dict (tensors), "seconds": the training loop's wall seconds, "heldout":
    (init, final) held-out MPJPE in mm or None}, beside the printed lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="tmp/torch_data")
    ap.add_argument(
        "--synthetic", action="store_true",
        help="train on the synthetic-blob vision task (no packed data needed); prints held-out tracked MPJPE "
        "before/after",
    )
    ap.add_argument(
        "--rendered", action="store_true",
        help="train on windows built by the tracker's crop/warp path over frames rendered from the label JSONs "
        "of --rendered-root (training/rendered.py); recording_11 held out",
    )
    ap.add_argument("--rendered-root", default=RENDERED_ROOT,
                    help="directory of recording_00.json, recording_02.json (training) and recording_11.json (held out)")
    ap.add_argument("--generic-hand-model", default=GENERIC_HAND_MODEL,
                    help="the generic hand model JSON (--synthetic's hand; --rendered's scale reference)")
    ap.add_argument("--cache-dir", default="tmp", help="where --rendered caches its windows (.npz)")
    ap.add_argument("--rendered-stride", type=int, default=4,
                    help="window start stride for --rendered (4 -> ~90 windows/recording)")
    ap.add_argument("--augment", type=int, default=0,
                    help="extra augmented replicas per recording for --rendered (scale 0.8-1.2 + pose perturbation)")
    ap.add_argument("--crop-jitter", action="store_true",
                    help="build augmented replicas' crops from jittered poses (serving's imperfect crops)")
    ap.add_argument("--augment-trans-mm", type=float, default=25.0,
                    help="wrist translation perturbation scale for --augment replicas")
    ap.add_argument("--augment-rot-deg", type=float, default=10.0,
                    help="wrist rotation perturbation scale for --augment replicas")
    ap.add_argument("--augment-head-rot-deg", type=float, default=0.0,
                    help="rig-trajectory rotation perturbation (novel viewing trajectories)")
    ap.add_argument("--augment-head-trans-mm", type=float, default=0.0,
                    help="rig-trajectory translation perturbation")
    ap.add_argument("--renderer", choices=["mesh", "blobs"], default="mesh",
                    help="--rendered frame renderer: 'mesh' = LBS-skinned mesh silhouettes, 'blobs' = landmark gaussians")
    ap.add_argument("--window", type=int, default=2, help="synthetic window T")
    ap.add_argument("--input-size", type=int, default=32, help="synthetic crop size (32 = tiny recipe, 96 = full)")
    ap.add_argument("--tiny-arch", action="store_true",
                    help="ModelConfig.tiny(): reduced-width topology matching the eval apps' --tiny-arch")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--branch", choices=["known", "unknown", "both"], default="known",
                    help="'both' trains regressor_k AND regressor_u in one step (the eval protocol chain needs both)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--save", default="tmp/checkpoints/latest.msgpack")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", default=None, help="train-state checkpoint to resume from")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="views over this many ranks of a torch.distributed world (when it divides the world)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the process group's backend under torchrun (nccl on cards, gloo on the CPU unless "
                    "given; ranks that share one card need gloo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-device", default="cuda", help="the device that trains")
    args = ap.parse_args(argv)
    _, world = init_distributed(backend=args.backend, device=args.torch_device)
    mesh = None
    if world > 1:
        model_ax = args.model_axis if world % args.model_axis == 0 else 1
        mesh = make_mesh(data=world // model_ax, model=model_ax, devices=args.torch_device)
        _block(mesh, args.batch)  # the batch must split over the data axis
    device = _device(args.torch_device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0  # prints and saves
    print_ = print if lead else (lambda *a, **k: None)
    save = args.save if lead else None

    if args.synthetic or args.rendered:
        size = (args.input_size, args.input_size)
        cfg = ModelConfig.tiny(input_size=size) if args.tiny_arch else ModelConfig(input_size=size)
        ds = None
    else:
        folders = find_dataset_folders(args.data_root, ["mono", "labels"])
        if not folders:
            raise SystemExit(f"no packed data under {args.data_root}")
        ds = PackedDataset(folders, ["mono", "labels"])
        print_(f"{len(ds)} windows from {len(folders)} folders")
        cfg = ModelConfig()
    set_conv_precision("highest")  # f32 convs and matmuls without TF32, as the JAX package's HIGHEST
    model = eval_lib.build_model(args.checkpoint, cfg, seed=args.seed, device=device)
    opt = make_optimizer(args.lr)
    state = init_train_state(model, opt)
    if args.resume:
        state = load_train_state(args.resume, state)
        print_(f"resumed from {args.resume} at step {int(state.step)}")

    if args.rendered:
        from ..training.rendered import materialize, rendered_dataset, slice_windows

        root = args.rendered_root
        base_tag = os.path.join(
            args.cache_dir,
            f"rendered_ds_{args.input_size}_T{args.window}_s{args.rendered_stride}"
            + ("" if args.renderer == "mesh" else f"_{args.renderer}"),
        )
        tag = base_tag
        aug_kwargs = {}
        if args.augment:
            tag += f"_a{args.augment}" + ("j" if args.crop_jitter else "")
            if args.augment_trans_mm != 25.0:
                aug_kwargs["wrist_trans_mm"] = args.augment_trans_mm
                tag += f"_t{args.augment_trans_mm:g}"
            if args.augment_rot_deg != 10.0:
                aug_kwargs["wrist_rot_deg"] = args.augment_rot_deg
                tag += f"_r{args.augment_rot_deg:g}"
            if args.augment_head_rot_deg or args.augment_head_trans_mm:
                aug_kwargs["head_rot_deg"] = args.augment_head_rot_deg
                aug_kwargs["head_trans_mm"] = args.augment_head_trans_mm
                tag += "_h"
        common = dict(window_t=args.window, stride=args.rendered_stride, cfg=cfg, renderer=args.renderer,
                      generic_hand_model=args.generic_hand_model, device=device)
        train_b, train_h = rendered_dataset(
            [f"{root}/recording_00.json", f"{root}/recording_02.json"], cache_path=f"{tag}_train.npz",
            augment=args.augment, crop_jitter=args.crop_jitter, seed=args.seed, augment_kwargs=aug_kwargs, **common,
        )
        held_b, held_h = rendered_dataset(
            [f"{root}/recording_11.json"], max_windows_per_recording=64, cache_path=f"{base_tag}_held.npz", **common,
        )
        n_train = train_b.hand_idx.shape[0]
        print_(f"rendered windows: train {n_train} samples, "
               f"held-out {held_b.hand_idx.shape[0]} samples (recording_11)")
        rows = _block(mesh, min(args.batch, n_train))

        def batches():
            rng = np.random.default_rng(args.seed)
            while True:
                idx = np.sort(rng.choice(n_train, size=min(args.batch, n_train), replace=False))
                yield slice_windows(train_b, train_h, idx[rows])
    elif args.synthetic:
        from ..training.synthetic import learnable_windows

        def batches():
            i = args.seed
            while True:
                batch, hand = learnable_windows(args.batch, t=args.window, cfg=cfg, seed=i,
                                                generic_hand_model=args.generic_hand_model)
                yield (batch, hand) if mesh is None else local_batch(mesh, batch, hand)
                i += 1
    else:
        # the prefetch thread launches the warp on the stream that the
        # network runs on, so the network reads the crops after they are written
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

        rows = _block(mesh, args.batch)

        def batches():
            rng = np.random.default_rng(args.seed)
            while True:
                idx = rng.integers(0, len(ds), args.batch)[rows]
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    seqs = [preprocess_packed(np.asarray(ds[int(i)]["mono"]), ds[int(i)]["labels"], device=device)
                            for i in idx]
                yield windows_to_batch(seqs)

    has_eval = args.synthetic or args.rendered
    step = make_train_step(cfg, opt, branch=args.branch, mesh=mesh)
    e0 = None
    if has_eval:
        # the held-out batch runs whole on every rank, as JAX's step takes it unsharded
        ev = make_eval_step(cfg, branch="unknown" if args.branch == "unknown" else "known")
        if args.rendered:
            held_batch, held_hand = to_device(materialize(held_b), held_h, device)
        else:
            held_batch, held_hand = to_device(
                *learnable_windows(max(args.batch, 16), t=args.window, cfg=cfg, seed=999_999,
                                   generic_hand_model=args.generic_hand_model),
                device,
            )

        def heldout_mpjpe_mm(m):
            out = ev(m, held_batch, held_hand)
            return float(out["err_sum_m"]) / float(out["err_count"]) * 1e3

        e0 = heldout_mpjpe_mm(state.params)
        print_(f"held-out tracked MPJPE at init: {e0:.1f} mm")
        best_heldout = e0
        # .best is the canonical artifact: seed it from this stage's init,
        # or score a previous stage's file so that a resumed stage never
        # overwrites a better earlier .best nor leaves a stale one
        if save:
            best_path = save + ".best"
            if os.path.exists(best_path):
                try:
                    e_prev = heldout_mpjpe_mm(load_jax_params(load_any(best_path, cfg), cfg, device=device))
                    print_(f"existing .best scores {e_prev:.1f} mm")
                    if e_prev < best_heldout:
                        best_heldout = e_prev
                    else:
                        save_params(best_path, state.params)
                except ValueError as exc:  # the architecture changed between stages
                    print_(f".best unreadable ({exc}); reseeding")
                    save_params(best_path, state.params)
            else:
                save_params(best_path, state.params)

    it = PrefetchIterator(batches(), max_prefetch=2)
    history = []
    t0 = time.time()
    try:
        for i in range(args.steps):
            batch, hand = next(it)
            state, metrics = step(state, batch, hand)
            history.append(metrics)
            if i % 10 == 0 or i == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                extra = ""
                if has_eval and (i % args.eval_every == 0 or i == args.steps - 1):
                    e_now = heldout_mpjpe_mm(state.params)
                    extra = f" heldout={e_now:.1f}mm"
                    # keep the best-generalizing params beside the latest
                    if save and e_now < best_heldout:
                        best_heldout = e_now
                        save_params(save + ".best", state.params)
                        extra += " (best)"
                print_(f"step {i}: loss={m['total']:.4f} lm={m['landmark_l2_m'] * 1e3:.1f}mm{extra} ({dt:.1f}s)")
            if save and (i + 1) % args.save_every == 0:
                save_params(save, state.params)
                save_train_state(save + ".train", state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.time() - t0
    finally:
        it.close()
    heldout = None
    if has_eval:
        e1 = heldout_mpjpe_mm(state.params)
        heldout = (e0, e1)
        print_(f"held-out tracked MPJPE: {e0:.1f} mm (init) -> {e1:.1f} mm ({e0 / max(e1, 1e-9):.1f}x better)")
    if save:
        save_params(save, state.params)
        save_train_state(save + ".train", state)
        print_(f"saved {save} (+.train resume state)")
    return dict(state=state, metrics=history, seconds=seconds, heldout=heldout)


if __name__ == "__main__":
    main()
