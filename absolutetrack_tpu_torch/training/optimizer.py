"""The JAX package's optimizer, written out (``training/train.py::make_optimizer``:
``optax.apply_if_finite(chain(clip_by_global_norm(c), adamw(lr, weight_decay=wd)), n)``).

It keeps optax 0.2.6's arithmetic in its order, which torch's stock pieces
do not:

* the clip divides by the global norm, then multiplies by the limit, and
  only when the norm reaches the limit (``clip_grad_norm_`` scales every
  gradient by ``limit / (norm + 1e-6)``);
* the weight decay is added to the Adam update, ``u + wd * p``, before the
  step ``p + (-lr) * u`` (``torch.optim.AdamW`` decays ``p`` first);
* a non-finite gradient (any leaf) drops the whole update, moments and
  count included, until ``n`` such steps in a row; the next one is applied,
  NaN and all, as optax applies it.

The guard's decision stays on the device (``torch.where``, as ``lax.cond``
keeps it there): the update is computed every step and selected, so a step
never waits for the host. A parameter without a gradient (``None``, as
``regressor_u`` under the known-skeleton loss) takes zeros, as JAX's
gradient of an unused leaf is zeros: its moments decay and the weight
decay still moves it. Parameters, gradients and moments are dicts of
tensors keyed by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]
INT32_MAX = 2**31 - 1
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package keeps


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``."""

    count: torch.Tensor  # int32, 0-d
    mu: Tensors
    nu: Tensors


class GuardState(NamedTuple):
    """optax's ``ApplyIfFiniteState``; ``inner_state`` is the Adam state
    (the clip, the decay and the scale carry none)."""

    notfinite_count: torch.Tensor  # int32, 0-d
    last_finite: torch.Tensor  # bool, 0-d
    total_notfinite: torch.Tensor  # int32, 0-d
    inner_state: AdamState


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, saturating at the int32 maximum (``optax.safe_increment``)."""
    return torch.where(count < INT32_MAX, count + 1, count)


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """``apply_if_finite(chain(clip_by_global_norm(clip_norm), adamw(lr,
    weight_decay=weight_decay)), max_consecutive_nonfinite)``, with optax's
    ``init``/``update`` and ``apply_updates`` below."""

    lr: float = 1e-4
    weight_decay: float = 1e-5
    clip_norm: float = 1.0
    max_consecutive_nonfinite: int = 10

    def init(self, params: Tensors) -> GuardState:
        p0 = next(iter(params.values()))

        def scalar(value, dtype):
            return torch.tensor(value, dtype=dtype, device=p0.device)

        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return GuardState(
            notfinite_count=scalar(0, torch.int32),
            last_finite=scalar(True, torch.bool),
            total_notfinite=scalar(0, torch.int32),
            inner_state=AdamState(
                count=scalar(0, torch.int32),
                mu=zeros,
                nu={k: z.clone() for k, z in zeros.items()},
            ),
        )

    @torch.no_grad()
    def update(
        self, grads: Dict[str, Optional[torch.Tensor]], state: GuardState, params: Tensors
    ) -> tuple[Tensors, GuardState]:
        """(updates to add to ``params``, the new state), as optax's ``update``."""
        g = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k] for k, p in params.items()}
        isfinite = torch.stack([torch.isfinite(x).all() for x in g.values()]).all()
        notfinite_count = torch.where(isfinite, torch.zeros_like(state.notfinite_count),
                                      safe_increment(state.notfinite_count))
        apply = isfinite | (notfinite_count > self.max_consecutive_nonfinite)

        # clip_by_global_norm
        g_norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        trigger = g_norm < self.clip_norm
        g = {k: torch.where(trigger, x, (x / g_norm) * self.clip_norm) for k, x in g.items()}

        # scale_by_adam
        inner = state.inner_state
        mu = {k: (1 - B1) * x + B1 * inner.mu[k] for k, x in g.items()}
        nu = {k: (1 - B2) * (x * x) + B2 * inner.nu[k] for k, x in g.items()}
        count = safe_increment(inner.count)
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1 - torch.pow(one * B1, count.float())
        bc2 = 1 - torch.pow(one * B2, count.float())
        updates = {}
        for k, p in params.items():
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
            u = u + self.weight_decay * p  # add_decayed_weights
            updates[k] = torch.where(apply, -self.lr * u, 0.0)  # scale_by_learning_rate

        new_inner = AdamState(
            count=torch.where(apply, count, inner.count),
            mu={k: torch.where(apply, mu[k], inner.mu[k]) for k in mu},
            nu={k: torch.where(apply, nu[k], inner.nu[k]) for k in nu},
        )
        return updates, GuardState(
            notfinite_count=notfinite_count,
            last_finite=isfinite,
            total_notfinite=torch.where(isfinite, state.total_notfinite, safe_increment(state.total_notfinite)),
            inner_state=new_inner,
        )


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p + u`` in place, as ``optax.apply_updates`` adds them."""
    for k, p in params.items():
        p.add_(updates[k])
