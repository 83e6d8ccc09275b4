"""How far a data-sharded gradient may lie from the one-process gradient on
one card, with no collective involved.

    python3 scripts/sharded_step_noise.py [--device cuda]

At full ``ModelConfig()`` width, from ``chip_smoke.py``'s reference-named
weights, on ``chip_smoke.parallel_batch`` (4 samples x T=2): the gradient
of the whole batch, the same again (the device's own spread), and the sum
of the two halves' gradients, each half divided by the whole batch's
valid count (what two data ranks sum), all in one process; then the same
three with cuDNN off (PyTorch's own convolutions). Prints one JSON line:
each pair's error in norm, over the largest |g| of all leaves, and the
worst leaf over its own largest |g|.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from absolutetrack_tpu_torch.apps import eval_lib  # noqa: E402
from absolutetrack_tpu_torch.models.config import ModelConfig  # noqa: E402
from absolutetrack_tpu_torch.models.layers import set_conv_precision  # noqa: E402
from absolutetrack_tpu_torch.parallel import Mesh  # noqa: E402
from absolutetrack_tpu_torch.training import train  # noqa: E402


def grads(model, batch, hand, cfg, half=None, mask_total=None):
    """{name: gradient} of the loss of half ``half`` of the samples (all of
    them without), divided by ``mask_total`` valid samples (the samples'
    own without)."""
    if half is None:
        b, h = train.to_device(batch, hand, model.device)
    else:  # data rank ``half``'s block of 2 (no process group: the mesh only places it)
        b, h = train.local_batch(Mesh(2, 1, half, model.device), batch, hand)
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, _ = train.loss_fn(model, b, h, cfg, mask_total=mask_total)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).double().cpu().numpy() for (n, p), g in zip(params.items(), gs)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    set_conv_precision("highest")
    cfg = ModelConfig()
    ck = Path(__file__).resolve().parents[1] / "tmp" / "sharded_step_noise.pt"
    ck.parent.mkdir(exist_ok=True)
    torch.save(chip_smoke.reference_state_dict(cfg, 0), ck)
    model = eval_lib.build_model(str(ck), cfg, device=args.device).requires_grad_(True)
    batch, hand = chip_smoke.parallel_batch(cfg, chip_smoke.PARALLEL_BATCH, chip_smoke.PARALLEL_T, 0)
    total = torch.tensor(float(batch.sample_mask.sum()), device=model.device)
    out = {}
    for name, cudnn in (("cudnn", True), ("no_cudnn", False)):
        torch.backends.cudnn.enabled = cudnn
        whole, again = grads(model, batch, hand, cfg), grads(model, batch, hand, cfg)
        halves = [grads(model, batch, hand, cfg, i, total) for i in range(2)]
        summed = {k: halves[0][k] + halves[1][k] for k in whole}
        out[name] = dict(whole_again=chip_smoke.grad_errors(again, whole),
                         halves_summed=chip_smoke.grad_errors(summed, whole))
    torch.backends.cudnn.enabled = True
    smi = ""
    if model.device.type == "cuda":
        import subprocess

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(out, device=str(model.device), card=smi)))


if __name__ == "__main__":
    main()
