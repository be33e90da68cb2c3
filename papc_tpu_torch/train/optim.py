"""Optimizer pieces in optax's semantics that PyTorch does not ship.

``RMSProp`` is ``optax.rmsprop`` (with ``optax.add_decayed_weights`` in
front), not ``torch.optim.RMSprop``: optax puts ``eps`` inside the
square root and scales by the learning rate before the momentum trace,
so a changing rate reaches the trace one step at a time. ``ScheduledLR``
sets each step's rate from a schedule of the step count as optax does:
the count before the step, so the first step takes ``schedule(0)``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


class RMSProp(torch.optim.Optimizer):
    """``chain(add_decayed_weights(weight_decay), rmsprop(lr, decay, eps,
    momentum))`` of optax, per parameter: ``g += weight_decay·p``, ``nu =
    (1 - decay)·g² + decay·nu``, ``u = -lr·g·rsqrt(nu + eps)``, ``trace =
    u + momentum·trace``, ``p += trace``. State: ``nu`` and ``trace``,
    zero at the start (optax's ``initial_scale`` 0)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 momentum: float = 0.9, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, momentum=momentum,
                                      eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, wd = group["decay"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu, trace = state["nu"], state["trace"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                u = -group["lr"] * (torch.rsqrt(nu + group["eps"]) * g)
                trace.copy_(u + group["momentum"] * trace)
                p.add_(trace)
        return loss


class ScheduledLR(torch.optim.lr_scheduler.LRScheduler):
    """Every parameter group's rate is ``schedule(count)``, ``count`` the
    optimizer steps taken so far (``last_epoch``): ``schedule(0)`` from
    construction, ``schedule(n)`` after the ``n``-th ``step()``. Call
    ``step()`` after each ``optimizer.step()``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self) -> list[float]:
        return [float(self.schedule(self.last_epoch))
                for _ in self.optimizer.param_groups]

    def set_count(self, count: int) -> None:
        """Resume at ``count`` steps taken (a restored optimizer state)."""
        self.last_epoch = count
        for group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            group["lr"] = lr
        self._last_lr = self.get_lr()
