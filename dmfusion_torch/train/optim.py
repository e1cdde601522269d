"""Optimizer and learning-rate schedule factories.

Port of ``dmfusion/train/optim.py``: optimizers ADAM / SGD / RMSprop and
the eight schedules, gated by ``schedule.if_scheduler``.  The semantics
of the optax versions are kept:
  * a schedule is a function of the number of updates applied before the
    current one (0 for the first), and maps it to an epoch with
    ``count // steps_per_epoch``; optax calls it on an int32 count, so the
    arithmetic runs in float32 where JAX's does (``0.98 ** e`` and the
    like; ``math.cos`` sees the float32 argument, as dmfusion's does);
  * every optimizer here carries that count in each parameter group
    (``group["count"]``, part of ``state_dict()``, so a resumed run goes on
    with the schedule), and a step pre-hook sets ``group["lr"]`` to
    ``schedule(count)`` before every ``optimizer.step()``; torch's
    ``LambdaLR`` would scale the base lr and count epochs instead;
  * ``optax.adam`` is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)``
    up to float32 rounding, and ``optax.sgd(momentum=0.9)`` is torch SGD
    without dampening or Nesterov;
  * ``optax.rmsprop`` puts eps *inside* the root (``g * rsqrt(nu + eps)``,
    initial ``nu`` 0) where ``torch.optim.RMSprop`` puts it outside, so
    :class:`RMSprop` here is the port's own;
  * state starts as optax's ``init`` makes it: zero moments for every
    parameter (``make_optimizer`` fills it), so ``state_dict()`` is
    complete before the first step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

_F = np.float32


def make_schedule(cfg: Mapping[str, Any],
                  steps_per_epoch: int) -> Callable[[int], float] | None:
    sch = cfg["schedule"]
    if not sch.get("if_scheduler"):
        return None
    lr = float(sch["lr"])
    base_lr = float(sch["base_lr"])
    name = sch["scheduler"]
    epochs = int(cfg["epoch"])
    spe = np.int32(steps_per_epoch)

    def per_epoch(fn):
        return lambda count: float(fn(np.int32(count) // spe))

    def warm(e):  # 0.1 + 0.9 * min(e, 10) / 10
        return _F(0.1) + _F(0.9) * _F(min(e, 10)) / _F(10)

    if name == "StepLR":
        gamma = base_lr / lr
        return per_epoch(lambda e: _F(lr) * _F(gamma) ** _F(e // 50))
    if name == "LinearLR":
        return per_epoch(lambda e: _F(lr) * warm(e))
    if name == "CosineAnnealingLR":
        # torch closed form (T_max=50, eta_min=base_lr), continuing past
        # T_max with period 100.
        return per_epoch(
            lambda e: base_lr + (lr - base_lr)
            * (1 + math.cos(_F(math.pi) * _F(e) / _F(50))) / 2)
    if name == "CyclicLR":
        def cyclic(e):
            pos = e % 50
            if pos < 10:
                return _F(base_lr) + _F(lr - base_lr) * _F(pos) / _F(10)
            return _F(lr) - _F(lr - base_lr) * _F(pos - 10) / _F(40)
        return per_epoch(cyclic)
    if name == "OneCycleLR":
        # torch OneCycleLR(max_lr=lr, pct_start=0.5, total_steps=epoch,
        # div_factor=final_div_factor=lr/base_lr), cos anneal.
        min_lr = base_lr * base_lr / lr

        def anneal_cos(start, end, pct):
            return end + (start - end) / 2 * (1 + math.cos(_F(math.pi) * pct))

        up_end = 0.5 * epochs - 1
        dn_end = epochs - 1

        def onecycle(e):
            e = min(e, dn_end)
            if e <= up_end:
                return anneal_cos(base_lr, lr, _F(e) / _F(max(up_end, 1e-12)))
            return anneal_cos(lr, min_lr, _F(e - up_end)
                              / _F(max(dn_end - up_end, 1e-12)))
        return per_epoch(onecycle)
    if name == "ConstantLR":
        factor = base_lr / lr
        return per_epoch(lambda e: lr * (factor if e < 10 else 1.0))
    if name == "ChainedScheduler":
        return per_epoch(lambda e: _F(lr) * warm(e) * _F(0.98) ** _F(e))
    if name == "ExponentialLR":
        return per_epoch(lambda e: _F(lr) * _F(0.98) ** _F(e))
    raise ValueError(f"unknown scheduler {name!r}")


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=alpha)``: ``nu = (1 - alpha) g^2 + alpha nu``
    then ``p -= lr * g * rsqrt(nu + eps)``, eps inside the root."""

    def __init__(self, params, lr: float, alpha: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "alpha": alpha, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            a, eps, lr = group["alpha"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                g = p.grad
                nu = (1 - a) * g.square() + a * state["nu"]
                state["nu"].copy_(nu)
                p.add_(torch.rsqrt(nu + eps) * g * -lr)


def _zero_state(opt: torch.optim.Optimizer) -> None:
    """Fill every parameter's state with zeros, as optax's ``init`` does."""
    for group in opt.param_groups:
        for p in group["params"]:
            zeros = lambda: torch.zeros_like(  # noqa: E731
                p, memory_format=torch.preserve_format)
            if isinstance(opt, torch.optim.Adam):
                opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": zeros(), "exp_avg_sq": zeros()}
            elif isinstance(opt, torch.optim.SGD):
                opt.state[p] = {"momentum_buffer": zeros()}
            else:
                opt.state[p] = {"nu": zeros()}


def _set_scheduled_lr(opt, _args, _kwargs) -> None:
    for group in opt.param_groups:
        group["lr"] = opt.schedule(group["count"])


def _count_update(opt, _args, _kwargs) -> None:
    for group in opt.param_groups:
        group["count"] += 1


def make_optimizer(cfg: Mapping[str, Any],
                   params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 1) -> torch.optim.Optimizer:
    """The configured optimizer over ``params``, its state zeroed, its
    update count at 0, and its lr driven by the schedule when one is on."""
    sch = cfg["schedule"]
    lr = float(sch["lr"])
    opt_type = sch["optimizer"]
    if opt_type == "ADAM":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif opt_type == "SGD":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(sch.get("momentum", 0.9)))
    elif opt_type == "RMSprop":
        opt = RMSprop(params, lr=lr, alpha=float(sch.get("alpha", 0.99)))
    else:
        raise ValueError(f"unknown optimizer {opt_type!r}")
    return _finish(opt, make_schedule(cfg, steps_per_epoch))


def reset_state(opt: torch.optim.Optimizer) -> None:
    """Zero moments and an update count of 0, as after optax's ``init``."""
    _zero_state(opt)
    for group in opt.param_groups:
        group["count"] = 0


def _finish(opt: torch.optim.Optimizer,
            schedule: Callable[[int], float] | None) -> torch.optim.Optimizer:
    reset_state(opt)
    opt.schedule = schedule
    if schedule is not None:
        opt.register_step_pre_hook(_set_scheduled_lr)
    opt.register_step_post_hook(_count_update)
    return opt


def adam_beta(params: Iterable[torch.nn.Parameter], lr: float,
              b1: float = 0.5, b2: float = 0.999) -> torch.optim.Optimizer:
    """Adam with GAN betas (reference tostagesolver.py:73-82)."""
    return _finish(torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8),
                   None)
