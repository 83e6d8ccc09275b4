"""The training step in plain PyTorch: the window unrolled through the
network, UmeTrack's losses of both heads, autograd, and AdamW with a clip
of the global gradient norm and a guard that drops a non-finite update.

Losses, each masked by sample validity and divided by the count of valid
samples (metres): the mean landmark distance of the forward kinematics,
the landmarks' Gaussian negative log-likelihood under the predicted
sigmas (x 0.1), the joint angles' squared error on the 20 finger angles
(x 0.1), the mean distance of the 7 wrist template points mapped through
the predicted and the true wrist, and, for the unknown-skeleton head, the
squared error of the log scale. The step's loss is the sum of both heads'.
The optimizer: if the global norm g reaches the clip c, every gradient is
scaled by c / g; Adam's moments with bias correction; the update
m / (sqrt(v) + eps) + weight_decay * p; p -= lr * update.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import kinematics as kin
from .network import Net, decode

B1, B2, EPS = 0.9, 0.999, 1e-8


def distance(a, b):
    d = a - b
    return torch.sqrt((d * d).sum(-1))


def window_loss(net: Net, batch: dict, hand: dict) -> torch.Tensor:
    """The summed loss of both heads over a (T, B) window (``batch``'s
    fields are the harness's, time-major)."""
    t_len, b = batch["use_memory"].shape
    c = net.cfg
    m_ch = c["n_temporal_memory_channels"]
    fh, fw = c["input_size"][0] // 16, c["input_size"][1] // 16
    dev = batch["images"].device
    skel = net.skeleton(batch["skel_axes"], batch["skel_rest"])
    view_mask = torch.ones(batch["images"].shape[1:3], dtype=torch.bool, device=dev)
    feats = [net.trunk(batch["images"][t], batch["intrinsics"][t], batch["extrinsics"][t], view_mask)
             for t in range(t_len)]
    mask = batch["sample_mask"].float()  # (T, B)
    denom = mask.sum().clamp(min=1.0)
    tmpl = net.template
    total = 0.0
    for known in (True, False):
        mem = torch.zeros(b, m_ch, fh, fw, device=dev)
        prev = torch.zeros(b, 4, 4, device=dev)
        for t in range(t_len):
            ext0 = batch["extrinsics"][t][:, 0]
            use = batch["use_memory"][t] & batch["sample_mask"][t]
            mem, fused = net.memory(mem, prev, feats[t], ext0, use)
            prev = ext0
            out = decode(net, fused, skel, ext0, known)
            gt_a, gt_w, m = batch["gt_joint_angles"][t], batch["gt_wrist"][t], mask[t]
            err = distance(kin.landmarks(hand, out.angles, out.wrist_world), kin.landmarks(hand, gt_a, gt_w))
            term = err.mean(-1)
            term = term + 0.1 * (torch.log(out.sigmas) + 0.5 * (err / out.sigmas) ** 2).mean(-1)
            term = term + 0.1 * ((out.angles[:, :20] - gt_a[:, :20]) ** 2).mean(-1)
            pw = (out.wrist_world[:, None, :3, :3] @ tmpl[..., None])[..., 0] + out.wrist_world[:, None, :3, 3]
            gw = (gt_w[:, None, :3, :3] @ tmpl[..., None])[..., 0] + gt_w[:, None, :3, 3]
            term = term + distance(pw, gw).mean(-1)
            if not known:
                term = term + (torch.log(out.scale) - batch["gt_log_scale"]) ** 2
            total = total + (term * m).sum() / denom
    return total


class AdamW:
    """The clipped AdamW with its non-finite guard, over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float, clip: float):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the gradients as clipped."""
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            return grads  # the update is dropped
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if norm >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1 - B1**self.count, 1 - B2**self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS) + self.wd * p
            p -= self.lr * u
        return grads


def train_steps(cfg: dict, params, batches, hand_for, lr=1e-4, weight_decay=1e-5, clip=1.0):
    """Run the steps over ``batches`` from ``params`` (updated in place) ->
    (each step's loss, the first step's clipped gradients)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = AdamW(leaves, lr, weight_decay, clip)
    losses, first = [], None
    for batch in batches:
        net = Net(cfg, leaves)
        loss = window_loss(net, batch, hand_for(batch))
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)}
        clipped = opt.step(leaves, grads)
        if first is None:
            first = {k: g.detach().clone() for k, g in clipped.items()}
        losses.append(float(loss.detach()))
        del loss, grads, clipped, net
    for k, v in leaves.items():
        params[k].copy_(v.detach())
    return losses, first
