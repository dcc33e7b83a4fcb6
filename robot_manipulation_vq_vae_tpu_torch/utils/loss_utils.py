"""Loss helpers (counterpart of the JAX package's ``utils/loss_utils.py``
:7-24, 25-52, 77-82): the transformer policies' action losses, and the KL
terms and Gaussian log densities of the VAE actor and ACT."""

import math

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


def kld_0_1_loss(mu, logvar):
    """D_KL(N(mu, exp(logvar)) || N(0, 1)): summed over the last axis, mean
    over the rest."""
    return -0.5 * (1.0 + logvar - mu ** 2 - logvar.exp()).sum(-1).mean()


def kld_gaussian_loss(mu_1, logvar_1, mu_2, logvar_2):
    """D_KL(N1 || N2) of two diagonal Gaussians: summed over the last axis,
    mean over the rest."""
    term = (logvar_2 - logvar_1
            + (logvar_1.exp() + (mu_1 - mu_2) ** 2) / logvar_2.exp() - 1.0)
    return 0.5 * term.sum(-1).mean()


def log_normal(x, m, v):
    """log N(@x; @m, diag(@v)), summed over the last axis."""
    return (-0.5 * (math.log(2.0 * math.pi) + v.log() + (x - m) ** 2 / v)).sum(-1)


def log_normal_mixture(x, m, v, log_w):
    """log of the mixture with log weights @log_w [..., M] of the diagonal
    Gaussians (@m, @v) [..., M, D] at @x [..., D]."""
    return torch.logsumexp(log_normal(x[..., None, :], m, v) + log_w, dim=-1)
