"""Loss helpers (counterpart of the JAX package's ``utils/loss_utils.py``
:7-24): the two that the transformer policies' action losses use."""

import torch


def cosine_loss(preds, labels, eps=1e-8):
    """-mean(cos_sim - 1) over the last axis; each norm clamped at @eps, as
    torch's ``CosineSimilarity`` does."""
    dot = (preds * labels).sum(-1)
    norms = (torch.linalg.vector_norm(preds, dim=-1).clamp_min(eps)
             * torch.linalg.vector_norm(labels, dim=-1).clamp_min(eps))
    return -(dot / norms - 1.0).mean()


def smooth_l1_loss(pred, target, beta=1.0):
    """``torch.nn.SmoothL1Loss`` with mean reduction."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta).mean()
