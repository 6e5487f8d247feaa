"""The train state: the model, its Adam optimizer and the gradient clip.

Counterpart of ``sqtpu/training/state.py``. ``make_optimizer`` picks Adam,
or AdamW when ``weight_decay`` is set, as the JAX package does; optax's
``adam``/``adamw`` and ``torch.optim.Adam``/``AdamW`` share their defaults
(β = (0.9, 0.999), ε = 1e-8 added outside the square root) and their
update rule, decoupled weight decay included. The optional global-norm
clip is optax's ``clip_by_global_norm``: g·c/‖g‖ when ‖g‖ ≥ c, written out
because ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    grad_clip: float = 0.0            # global-norm clip, 0 = off

    def apply_gradients(self) -> None:
        """Clip (if set) and take one optimizer step on the gradients the
        last backward left in ``.grad``."""
        if self.grad_clip:
            clip_by_global_norm([p.grad for p in self.model.parameters()
                                 if p.grad is not None], self.grad_clip)
        self.optimizer.step()


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam, or AdamW with decoupled ``weight_decay`` when it is set
    (reference: Adam(lr=1e-4, weight_decay=0), ``torch/train.py:51``)."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=learning_rate,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate)


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to global norm ``max_norm`` when their
    norm is at least that, as (t / ‖g‖) · c in optax's order; returns
    ‖g‖. No host sync: the choice is made on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def create_train_state(model: torch.nn.Module, config) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               config.learning_rate,
                                               config.weight_decay),
                      grad_clip=getattr(config, "grad_clip", 0.0))


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
