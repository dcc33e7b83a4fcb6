"""Action distributions (counterpart of the JAX package's
``models/distributions.py``:19-75, 159-173): a mixture of diagonal Gaussians
and a diagonal Gaussian, with explicit tensor math."""

import math
from dataclasses import dataclass

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class GMMActionDistribution:
    """Mixture of diagonal Gaussians over actions.

    means:  [..., M, A]
    scales: [..., M, A]
    logits: [..., M]
    batch shape is [...] (e.g. [B, T]); event shape is [A].
    """

    means: torch.Tensor
    scales: torch.Tensor
    logits: torch.Tensor

    def log_prob(self, actions):
        """actions [..., A] -> log prob [...], as
        MixtureSameFamily(Categorical(logits), Independent(Normal, 1))."""
        x = actions[..., None, :]  # [..., 1, A]
        comp_lp = -0.5 * (
            (x - self.means) ** 2 / self.scales ** 2
            + 2.0 * torch.log(self.scales) + _LOG_2PI
        ).sum(-1)  # [..., M]
        mix_lp = torch.log_softmax(self.logits, dim=-1)
        return torch.logsumexp(comp_lp + mix_lp, dim=-1)

    def index_time(self, t):
        """The distribution at time step @t of a [B, T] batch."""
        return GMMActionDistribution(
            means=self.means[:, t], scales=self.scales[:, t],
            logits=self.logits[:, t],
        )

    def sample(self, generator=None, mode=None, eps=None):
        """One action per batch element. ``mode`` (the mixture component,
        [...] int) and ``eps`` (the standard-normal draw, [..., A]) may be
        injected, so that a test can feed both frameworks the same noise;
        otherwise they are drawn from @generator."""
        if mode is None:
            probs = torch.softmax(self.logits, dim=-1)
            flat = probs.reshape(-1, probs.shape[-1])
            mode = torch.multinomial(flat, 1, generator=generator).reshape(
                probs.shape[:-1]
            )
        index = mode.long()[..., None, None].expand(
            *mode.shape, 1, self.means.shape[-1]
        )
        mean = self.means.gather(-2, index).squeeze(-2)
        scale = self.scales.gather(-2, index).squeeze(-2)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device, dtype=mean.dtype)
        return mean + scale * eps



@dataclass
class DiagGaussian:
    """Independent Normal over actions (the Gaussian policy heads).

    mean, scale: [..., A]; batch shape [...], event shape [A].
    """

    mean: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, actions):
        """actions [..., A] -> log prob [...], summed over the action."""
        return (-0.5 * ((actions - self.mean) ** 2 / self.scale ** 2
                        + 2.0 * torch.log(self.scale) + _LOG_2PI)).sum(-1)

    def sample(self, generator=None, eps=None):
        """mean + scale * eps; the standard-normal ``eps`` [..., A] may be
        injected (as ``GMMActionDistribution.sample``'s), else it is drawn
        from @generator."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.scale * eps
