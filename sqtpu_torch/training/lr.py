"""Learning-rate control, copied from ``sqtpu/training/lr.py`` (plain
Python, no framework).

* :class:`ReduceLROnPlateau` — torch-semantics plateau scheduler
  (``torch.optim.lr_scheduler.ReduceLROnPlateau(patience=25)`` used at
  ``torch/train.py:52``): factor 0.1, relative threshold 1e-4, min mode.
* :func:`step_schedule_2019` — the Keras step schedule 1e-3/1e-4/1e-5 at
  epochs 250/500 (``py/train_isometry.py:6-12``).
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, lr: float, patience: int = 25, factor: float = 0.1,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed the epoch's validation loss; returns the (possibly reduced)
        learning rate."""
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "bad_epochs": self.bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.bad_epochs = state["bad_epochs"]


def step_schedule_2019(epoch: int) -> float:
    if epoch < 250:
        return 1e-3
    if epoch < 500:
        return 1e-4
    return 1e-5
