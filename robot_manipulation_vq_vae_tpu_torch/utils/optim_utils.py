"""Optimizers and learning-rate schedules from the ``optim_params`` config
blocks (counterpart of the JAX package's ``utils/optim_utils.py``:13-81,
which builds them with optax).

* ``adam``: ``torch.optim.Adam``, with ``regularization.L2`` added to the
  gradient (torch's ``weight_decay``, optax's ``add_decayed_weights`` before
  ``adam``);
* ``adamw``: ``torch.optim.AdamW`` with decoupled weight decay;
* optional global-norm clipping of the gradients before the step
  (``train.max_grad_norm``), with optax's rule: scale by max / norm when the
  norm reaches max;
* the ``constant``, ``constant_with_warmup``, ``linear``, ``multistep`` and
  ``cosine`` schedules, stepped once per gradient step. As in optax, the
  rate of update k (k = 0, 1, ...) is the schedule at k, so
  ``constant_with_warmup`` gives rate 0 to the first update. ``multistep``
  counts its ``epoch_schedule`` milestones in gradient steps too, as the
  JAX package does; ``cosine`` is optax's ``warmup_cosine_decay_schedule(0,
  lr, warmup, num_training_steps, end_value=0)``, whose decay horizon
  includes the warmup, and needs ``num_training_steps``
  (``train.num_epochs * experiment.epoch_every_n_steps``).

Another schedule type raises ``ValueError``.
"""

import math

import torch


def lr_factor_from_optim_params(optim_params, num_training_steps=None):
    """The schedule as a factor of the initial rate: step k -> factor."""
    lr_cfg = optim_params["learning_rate"]
    sched_type = lr_cfg.get("scheduler_type", "constant_with_warmup")
    warmup = int(lr_cfg.get("num_warmup_steps", 10000))
    decay = float(lr_cfg.get("decay_factor", 1.0))
    if sched_type is None or sched_type == "constant":
        return lambda k: 1.0
    if sched_type == "constant_with_warmup":
        # linear 0 -> 1 over the warmup, then constant
        return lambda k: min(k / warmup, 1.0)
    if sched_type == "linear":
        # 1 -> decay_factor over the warmup, then constant
        return lambda k: 1.0 + (decay - 1.0) * min(k / warmup, 1.0)
    if sched_type == "multistep":
        milestones = [int(m) for m in lr_cfg.get("epoch_schedule", [])]
        if not milestones:
            raise ValueError("the multistep schedule needs an epoch_schedule")
        return lambda k: decay ** sum(k >= m for m in milestones)
    if sched_type == "cosine":
        if num_training_steps is None:
            raise ValueError("the cosine schedule needs num_training_steps "
                             "(train.num_epochs * experiment.epoch_every_n_steps)")
        horizon = int(num_training_steps) - warmup
        if horizon <= 0:
            raise ValueError(f"the cosine schedule's {num_training_steps} steps do "
                             f"not outlast its {warmup} warmup steps")

        def cosine(k):
            if k < warmup:
                return k / warmup
            return 0.5 * (1.0 + math.cos(math.pi * min(k - warmup, horizon) / horizon))

        return cosine
    raise ValueError(f"Invalid LR scheduler type: {sched_type}")


def optimizer_from_optim_params(params, optim_params, num_training_steps=None):
    """(optimizer, LambdaLR scheduler) over @params; step the scheduler once
    after each optimizer step. @num_training_steps is the cosine schedule's
    horizon."""
    params = list(params)
    opt_type = optim_params.get("optimizer_type", "adam")
    lr = float(optim_params["learning_rate"]["initial"])
    weight_decay = float(optim_params.get("regularization", {}).get("L2", 0.0))
    if opt_type == "adam":
        optimizer = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    elif opt_type == "adamw":
        optimizer = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer type {opt_type}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lr_factor_from_optim_params(optim_params, num_training_steps)
    )
    return optimizer, scheduler


def global_norm(tensors):
    """sqrt of the sum of squares over every element of @tensors (a 0-d
    tensor; no host synchronization)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors])
    )


def clip_by_global_norm_(grads, max_norm):
    """Scale @grads in place by max_norm / norm when their global norm
    reaches @max_norm (optax's ``clip_by_global_norm``)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
