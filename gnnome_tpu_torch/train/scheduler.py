"""ReduceLROnPlateau with torch semantics (reference train.py:260 uses
``torch.optim.lr_scheduler.ReduceLROnPlateau(mode='min', factor=decay,
patience=patience)``; torch defaults threshold=1e-4 rel, cooldown=0)."""
from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "min", factor: float = 0.95,
                 patience: int = 2, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1.0 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1.0 + self.threshold)
        return current > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, d: dict) -> None:
        self.__dict__.update(d)
