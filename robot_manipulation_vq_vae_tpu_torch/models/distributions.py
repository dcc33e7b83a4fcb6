"""Action distributions (counterpart of the JAX package's
``models/distributions.py``): a mixture of diagonal Gaussians, a diagonal
Gaussian, and the tanh-squashed wrappers of both (y = tanh(x) * scale), with
explicit tensor math.

The tanh wrappers keep the reference's forms (robomimic's
``TanhWrappedDistribution``): atanh recovered through ``1 +- v`` clamped at
epsilon, and the squash correction ``log(1 - v^2 + epsilon)`` with epsilon
added (1e-6)."""

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


def _atanh(value, eps):
    """atanh(@value) as 0.5 log((1 + v) / (1 - v)), each side clamped at @eps."""
    return 0.5 * torch.log((1.0 + value).clamp_min(eps) / (1.0 - value).clamp_min(eps))


def _squash_correction(value, eps):
    """sum over the action of log(1 - v^2 + @eps)."""
    return torch.log(1.0 - value ** 2 + eps).sum(-1)


@dataclass
class TanhWrappedGMM:
    """The GMM @base squashed: y = tanh(x) * @scale."""

    base: GMMActionDistribution
    scale: float = 1.0
    tanh_epsilon: float = 1e-6

    def log_prob(self, value):
        value = value / self.scale
        pre_tanh = 0.5 * (torch.log((1.0 + value).clamp_min(self.tanh_epsilon))
                          - torch.log((1.0 - value).clamp_min(self.tanh_epsilon)))
        return (self.base.log_prob(pre_tanh) - _squash_correction(value, self.tanh_epsilon)
                - value.shape[-1] * math.log(self.scale))

    def sample(self, generator=None, mode=None, eps=None):
        return torch.tanh(self.base.sample(generator, mode, eps)) * self.scale


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


@dataclass
class TanhWrappedGaussian:
    """The diagonal Gaussian @base squashed: y = tanh(x) * @scale.
    ``log_prob`` takes the pre-tanh value where the caller has it (a
    reparameterized sample's), else recovers it by atanh; a @scale other
    than 1 adds A log(scale) to the correction."""

    base: DiagGaussian
    scale: float = 1.0
    tanh_epsilon: float = 1e-6

    def log_prob(self, value, pre_tanh_value=None):
        value = value / self.scale
        if pre_tanh_value is None:
            pre_tanh_value = _atanh(value, self.tanh_epsilon)
        correction = _squash_correction(value, self.tanh_epsilon)
        if self.scale != 1.0:
            correction = correction + value.shape[-1] * math.log(self.scale)
        return self.base.log_prob(pre_tanh_value) - correction

    def sample(self, generator=None, eps=None):
        return torch.tanh(self.base.sample(generator, eps)) * self.scale

    def rsample_with_pretanh(self, sample_shape=(), eps=None, generator=None):
        """(tanh(z) * scale, z) with z = mean + scale_base * eps, a sample
        that carries the gradient; the standard-normal @eps of shape
        ``sample_shape + mean.shape`` may be injected, else it is drawn
        from @generator."""
        mean = self.base.mean
        if eps is None:
            eps = torch.randn(tuple(sample_shape) + tuple(mean.shape), generator=generator,
                              device=mean.device, dtype=mean.dtype)
        z = mean + self.base.scale * eps
        return torch.tanh(z) * self.scale, z

    @property
    def mean(self):
        return self.base.mean
