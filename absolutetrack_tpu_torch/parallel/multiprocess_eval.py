"""Multi-process distributed eval (port of
``absolutetrack_tpu/parallel/multiprocess_eval.py``).

The reference parallelizes eval with a single-node ``Pool(8)`` over
recording sequences (run_eval_known_skeleton.py:116-119) and left a
stripped DistributedSampler seam behind (async_dataset.py:458-606). Here
each process is one rank of a ``torch.distributed`` group:

  * each process calls ``init_distributed`` (a ``tcp://`` or ``file://``
    rendezvous, or torchrun's environment);
  * the recording list shards across ranks with ``ShardSampler``
    (rank, world size, dropping the remainder);
  * each rank tracks its shard (full crop/warp/network/FK eval, K1 on a
    card);
  * the per-rank metric sums merge with ``allreduce_metrics``: a float32
    all-gather in rank order summed by numpy, as JAX's
    ``process_allgather`` branch does.

Every rank computes identical merged metrics, so rank 0's output is the
global result.

Usage (two ranks; one card each under NCCL, or two ranks on one card or
on the CPU under gloo):
  torchrun --nproc-per-node 2 -m absolutetrack_tpu_torch.parallel.multiprocess_eval \
      --label-files a.json b.json --checkpoint weights.pt --output merged.json
  python -m absolutetrack_tpu_torch.parallel.multiprocess_eval --label-files ... \
      --coordinator file:///tmp/store --num-processes 2 --process-id 0 --backend gloo
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from .distributed import allreduce_metrics, init_distributed, initialized, rank_device


def tiny_eval_config():
    """A small-but-complete architecture for CPU-speed distributed drills
    (full model topology -- backbone/FTL/fusion/ConvRNN/regressor -- at
    reduced width)."""
    from ..models.config import ModelConfig

    return ModelConfig.tiny()


def eval_shard_metrics(
    label_files: Sequence[str],
    rank: int,
    world_size: int,
    cfg=None,
    checkpoint: Optional[str] = None,
    max_frames: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Track this process's recording shard on ``device`` (``cuda`` unless
    given); return local metric sums.

    Metric definition matches run_eval_known_skeleton's reporting (mean
    keypoint error over valid hand-frames) split into reduction-friendly
    sums: ``err_sum`` (sum of per-hand-frame mean landmark errors, mm),
    ``err_count`` (valid hand-frames), ``n_frames``, ``n_recordings``.
    Sums are float64 on host so the merged result is independent of how
    recordings were sharded (f32 partial-sum ordering would not be).
    """
    from ..apps import eval_lib
    from ..data.dataset import ShardSampler
    from ..models.config import ModelConfig
    from ..tracker.tracker import TrackerConfig
    from ..tracker.video_data import SyntheticFrameSource, load_labels

    cfg = cfg if cfg is not None else ModelConfig()
    opts = TrackerConfig(crop_size=cfg.input_size)
    model = eval_lib.build_model(checkpoint, cfg=cfg, seed=seed, device=device)

    sampler = ShardSampler(len(label_files), rank=rank, world_size=world_size, drop_remainder=True)
    err_sum = 0.0
    err_count = 0
    n_frames = 0
    n_recordings = 0
    for i in sampler:
        labels = load_labels(label_files[i])
        frames = SyntheticFrameSource(labels, eval_lib.gt_landmark_sequence(labels))
        res = eval_lib.track_recording(model, labels, frames, opts=opts, max_frames=max_frames)
        err = np.linalg.norm((res.gt_keypoints - res.tracked_keypoints), axis=-1).mean(-1)  # (2, T)
        valid = res.valid_tracking
        err_sum += float(err[valid].astype(np.float64).sum())
        err_count += int(valid.sum())
        n_frames += res.tracked_keypoints.shape[1]
        n_recordings += 1
    return {
        "err_sum": err_sum,
        "err_count": float(err_count),
        "n_frames": float(n_frames),
        "n_recordings": float(n_recordings),
    }


def run_distributed_eval(
    label_files: Sequence[str],
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cfg=None,
    checkpoint: Optional[str] = None,
    max_frames: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Join the process group, eval the local shard, merge globally.

    Returns the merged metrics dict (identical on every process), with
    ``mean_err_mm`` derived from the reduced sums.
    """
    rank, world = init_distributed(coordinator_address, num_processes, process_id, backend, device)
    local = eval_shard_metrics(
        label_files, rank, world, cfg=cfg, checkpoint=checkpoint, max_frames=max_frames, device=rank_device(device)
    )
    merged = allreduce_metrics(local)
    merged["mean_err_mm"] = merged["err_sum"] / merged["err_count"] if merged["err_count"] else 0.0
    merged["world_size"] = float(world)
    return merged


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Returns the merged metrics, beside the printed line."""
    from ..models.layers import set_conv_precision

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label-files", nargs="+", required=True)
    ap.add_argument("--coordinator", default=None,
                    help="the rendezvous: host:port, tcp://, file:// (torchrun's environment when omitted)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--tiny-arch", action="store_true", help="CPU-speed drill config (tiny_eval_config)")
    ap.add_argument("--torch-device", default="cuda", help="the device each rank tracks on (cpu selects gloo)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the process group's backend (nccl for a card, gloo for the CPU unless given; "
                    "ranks that share one card need gloo)")
    ap.add_argument("--output", default=None, help="rank-0 metrics JSON path")
    args = ap.parse_args(argv)

    set_conv_precision("highest")  # f32 convs and matmuls without TF32, as the JAX package's HIGHEST
    cfg = tiny_eval_config() if args.tiny_arch else None
    merged = run_distributed_eval(
        args.label_files,
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        cfg=cfg,
        checkpoint=args.checkpoint,
        max_frames=args.max_frames,
        backend=args.backend,
        device=args.torch_device,
    )
    rank = dist.get_rank() if initialized() else 0
    print(f"rank {rank}: {json.dumps(merged)}", flush=True)
    if args.output and rank == 0:
        with open(args.output, "w") as f:
            json.dump(merged, f)
    if initialized():
        dist.destroy_process_group()
    return merged


if __name__ == "__main__":
    main()
