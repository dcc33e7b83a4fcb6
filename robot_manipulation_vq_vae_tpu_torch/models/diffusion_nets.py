"""The diffusion policy's denoiser and noise schedule (counterpart of the JAX
package's ``models/diffusion_nets.py``): ``cosine_beta_schedule``,
``DiffusionSchedule`` (``diffusers``' DDPM and DDIM stepping with
epsilon prediction) and the conditional 1-D UNet ``ConditionalUnet1D``.

The UNet keeps the reference ``ConditionalUnet1D``'s modules and key names
(``diffusion_step_encoder``, ``down_modules.{i}.{0,1,2}``, ``mid_modules``,
``up_modules.{j}.{0,1,2}``, ``final_conv.{0,1}``; in a residual block
``blocks.{0,1}.block.{0,1}``, ``cond_encoder.1`` and ``residual_conv``) and
its quirks, as the JAX package does: the shallowest skip is computed and
never used, every up level ends in a learned ``ConvTranspose1d(4, 2, 1)``,
the final block always normalizes over 8 groups, and the sequence length
must divide by 2 ** (levels - 1). Its GroupNorms take torch's epsilon,
1e-5. Sequences enter and leave channels-last ([B, T, C]), as in JAX.
"""

import math

import numpy as np
import torch
import torch.nn as nn

_ONE = np.float32(1.0)


def cosine_beta_schedule(num_steps, s=0.008, max_beta=0.999):
    """``squaredcos_cap_v2`` betas [num_steps], float32 (computed in
    float64)."""
    t = np.arange(num_steps + 1) / num_steps
    f = np.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    alphas_bar = f / f[0]
    betas = 1 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0, max_beta).astype(np.float32)


class DiffusionSchedule:
    """The DDPM / DDIM schedule with ``diffusers``' stepping: the strided
    inference grid ``arange(n) * (n_train // n)`` reversed (plus
    ``steps_offset`` for DDIM), ``prev_t = t - n_train // n``, the DDPM
    posterior with the "fixed_small" variance clamped at 1e-20, the
    predicted x0 clipped to [-1, 1] with ``clip_sample``, and DDIM with
    eta = 0 (its direction term takes the unclipped eps). The tables are
    numpy float32, as the JAX package's."""

    def __init__(self, num_train_timesteps=100, beta_schedule="squaredcos_cap_v2",
                 clip_sample=True, set_alpha_to_one=True, steps_offset=0):
        if beta_schedule != "squaredcos_cap_v2":
            raise NotImplementedError(f"beta_schedule {beta_schedule} is not ported")
        self.num_train_timesteps = num_train_timesteps
        self.clip_sample = clip_sample
        self.set_alpha_to_one = set_alpha_to_one
        self.steps_offset = steps_offset
        self.betas = cosine_beta_schedule(num_train_timesteps)
        self.alphas = 1.0 - self.betas
        self.alphas_bar = np.cumprod(self.alphas)
        self.sqrt_ab = np.sqrt(self.alphas_bar)
        self.sqrt_1mab = np.sqrt(1.0 - self.alphas_bar)

    def add_noise(self, x0, noise, t):
        """q(x_t | x_0) of @x0 [B, T, A] at the integer timesteps @t [B]."""
        a = torch.as_tensor(self.sqrt_ab, device=x0.device)[t].to(x0.dtype)
        b = torch.as_tensor(self.sqrt_1mab, device=x0.device)[t].to(x0.dtype)
        return a[:, None, None] * x0 + b[:, None, None] * noise

    def inference_timesteps(self, num_inference_steps, ddim=False):
        """The descending grid of ``set_timesteps`` (numpy int64)."""
        n = min(num_inference_steps, self.num_train_timesteps)
        ts = (np.arange(0, n) * (self.num_train_timesteps // n)).round()[::-1].astype(np.int64)
        return ts + self.steps_offset if ddim else ts

    def _ab_prev(self, t_prev, ddim):
        """alphas_bar at the previous grid step: past the chain's end 1 for
        DDPM, ``final_alpha_cumprod`` for DDIM."""
        if t_prev >= 0:
            return self.alphas_bar[t_prev]
        return _ONE if (not ddim or self.set_alpha_to_one) else self.alphas_bar[0]

    def _pred_x0(self, x_t, eps, ab_t):
        x0 = (x_t - float(np.sqrt(_ONE - ab_t)) * eps) / float(np.sqrt(ab_t))
        return x0.clamp(-1.0, 1.0) if self.clip_sample else x0

    # The steps' coefficients are float32 scalars computed in float32, as the
    # JAX package computes them from its float32 tables (so that a float64
    # test agrees to the bit); each multiplies the sequence in its own dtype.
    def ddpm_step(self, x_t, eps, t, t_prev, noise):
        """One reverse DDPM step from the integer timestep @t to @t_prev,
        with the standard-normal @noise (unused at t = 0)."""
        ab_t = self.alphas_bar[t]
        ab_prev = self._ab_prev(t_prev, ddim=False)
        beta_t = _ONE - ab_t / ab_prev
        x0 = self._pred_x0(x_t, eps, ab_t)
        coef_x0 = np.sqrt(ab_prev) * beta_t / (_ONE - ab_t)
        coef_xt = np.sqrt(ab_t / ab_prev) * (_ONE - ab_prev) / (_ONE - ab_t)
        mean = float(coef_x0) * x0 + float(coef_xt) * x_t
        var = max((_ONE - ab_prev) / (_ONE - ab_t) * beta_t, np.float32(1e-20))
        return mean + (float(np.sqrt(var)) if t > 0 else 0.0) * noise

    def ddim_step(self, x_t, eps, t, t_prev):
        """One DDIM step (eta = 0) from @t to @t_prev."""
        ab_t = self.alphas_bar[t]
        ab_prev = self._ab_prev(t_prev, ddim=True)
        x0 = self._pred_x0(x_t, eps, ab_t)
        return float(np.sqrt(ab_prev)) * x0 + float(np.sqrt(_ONE - ab_prev)) * eps


class SinusoidalPosEmb(nn.Module):
    """[B] timesteps -> [B, dim]: sines then cosines."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=t.dtype)
                          * (-math.log(10000) / (half - 1)))
        emb = t[:, None] * freqs[None]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm (eps 1e-5) -> Mish, channels-first."""

    JAX_NAMES = {"conv": "block.0", "gn": "block.1"}

    def __init__(self, in_channels, out_channels, kernel_size, n_groups=8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(in_channels, out_channels, kernel_size, padding=kernel_size // 2),
            nn.GroupNorm(n_groups, out_channels, eps=1e-5),
            nn.Mish(),
        )

    def forward(self, x):
        return self.block(x)


class ConditionalResidualBlock1D(nn.Module):
    """Two conv blocks with FiLM between them (scale * h + bias, the two
    halves of ``cond_encoder``'s projection of mish(cond)) and a residual,
    through a 1x1 conv where the channels change."""

    def __init__(self, in_channels, out_channels, cond_dim, kernel_size=5, n_groups=8):
        super().__init__()
        self.out_channels = out_channels
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_channels, out_channels, kernel_size, n_groups),
            Conv1dBlock(out_channels, out_channels, kernel_size, n_groups),
        ])
        self.cond_encoder = nn.Sequential(nn.Mish(), nn.Linear(cond_dim, 2 * out_channels))
        self.residual_conv = (nn.Conv1d(in_channels, out_channels, 1)
                              if in_channels != out_channels else nn.Identity())

    def jax_names(self):
        names = {"block1": "blocks.0", "block2": "blocks.1", "cond_proj": "cond_encoder.1"}
        if isinstance(self.residual_conv, nn.Conv1d):
            names["res_conv"] = "residual_conv"
        return names

    def forward(self, x, cond):
        """x [B, C_in, T], cond [B, D] -> [B, C_out, T]."""
        h = self.blocks[0](x)
        scale, bias = self.cond_encoder(cond)[:, :, None].chunk(2, dim=1)
        h = self.blocks[1](scale * h + bias)
        return h + self.residual_conv(x)


class Downsample1d(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample1d(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class ConditionalUnet1D(nn.Module):
    """The FiLM-conditioned 1-D UNet over the action sequence (see the
    module docstring): x [B, T, A], integer timesteps [B] and the
    observation condition [B, D] -> the predicted noise [B, T, A]."""

    def __init__(self, input_dim, global_cond_dim, diffusion_step_embed_dim=256,
                 down_dims=(256, 512, 1024), kernel_size=5, n_groups=8):
        super().__init__()
        dsed = diffusion_step_embed_dim
        self.levels = len(down_dims)
        self.diffusion_step_encoder = nn.Sequential(
            SinusoidalPosEmb(dsed), nn.Linear(dsed, 4 * dsed), nn.Mish(),
            nn.Linear(4 * dsed, dsed))
        cond_dim = dsed + global_cond_dim
        dims = [input_dim, *down_dims]
        in_out = list(zip(dims[:-1], dims[1:]))
        block = lambda i, o: ConditionalResidualBlock1D(  # noqa: E731
            i, o, cond_dim, kernel_size, n_groups)
        self.down_modules = nn.ModuleList([
            nn.ModuleList([block(i, o), block(o, o),
                           Downsample1d(o) if k < len(in_out) - 1 else nn.Identity()])
            for k, (i, o) in enumerate(in_out)])
        mid = down_dims[-1]
        self.mid_modules = nn.ModuleList([block(mid, mid), block(mid, mid)])
        self.up_modules = nn.ModuleList([
            nn.ModuleList([block(2 * o, i), block(i, i), Upsample1d(i)])
            for i, o in reversed(in_out[1:])])
        # the reference builds the final block without n_groups: 8 groups
        self.final_conv = nn.Sequential(
            Conv1dBlock(down_dims[0], down_dims[0], kernel_size, 8),
            nn.Conv1d(down_dims[0], input_dim, 1))

    def jax_names(self):
        names = {"temb1": "diffusion_step_encoder.1", "temb2": "diffusion_step_encoder.3",
                 "mid1": "mid_modules.0", "mid2": "mid_modules.1",
                 "final_block": "final_conv.0", "final_conv": "final_conv.1"}
        for i in range(self.levels):
            names[f"down{i}_r1"] = f"down_modules.{i}.0"
            names[f"down{i}_r2"] = f"down_modules.{i}.1"
            if i < self.levels - 1:
                names[f"down{i}_pool"] = f"down_modules.{i}.2.conv"
        for j in range(self.levels - 1):
            names[f"up{j}_r1"] = f"up_modules.{j}.0"
            names[f"up{j}_r2"] = f"up_modules.{j}.1"
            names[f"up{j}_up"] = f"up_modules.{j}.2.conv"
        return names

    def forward(self, x, t, global_cond):
        if x.shape[1] % (2 ** (self.levels - 1)):
            raise ValueError(f"sequence length {x.shape[1]} must divide by "
                             f"2**{self.levels - 1} for the UNet's skips")
        # the timestep embedding is at least fp32, as JAX's (its first Dense
        # then computes in fp32 on bf16 parameters under mixed precision)
        temb = self.diffusion_step_encoder(
            t.to(torch.promote_types(global_cond.dtype, torch.float32)))
        cond = torch.cat([temb, global_cond], dim=-1)
        h = x.transpose(1, 2)
        skips = []
        for r1, r2, down in self.down_modules:
            h = r2(r1(h, cond), cond)
            skips.append(h)
            h = down(h)
        for blk in self.mid_modules:
            h = blk(h, cond)
        for j, (r1, r2, up) in enumerate(self.up_modules):
            # level j takes the skip of its resolution; skips[0] goes unused
            h = torch.cat([h, skips[self.levels - 1 - j]], dim=1)
            h = up(r2(r1(h, cond), cond))
        return self.final_conv(h).transpose(1, 2)
