"""LN-Act action tokenizer, the ``ln_act_enabled`` modality (counterpart of
the JAX package's ``models/tokenizers/ln_act.py``): a Mamba selective
state-space block over the prompt action sequence, then an MLP projection.

The JAX package computes the scan with ``lax.associative_scan``, outside any
Pallas kernel; here it is a loop over T on [B, Di, N] states in the input's
dtype (T is the context length, 16 at full width).

Checkpoint names (``...action_network.<name>``): ``mamba.in_proj.weight``,
``mamba.conv1d.{weight [Di, 1, k], bias}``, ``mamba.x_proj.weight``,
``mamba.dt_proj.*``, ``mamba.A_log`` [Di, N], ``mamba.D`` [Di],
``mamba.out_proj.weight``; ``fc{1,2,3}.*``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def selective_scan(u, dt, A, B, C, D):
    """The Mamba recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,
    y_t = C_t . h_t + D u_t.

    u, dt [Bt, T, Di]; A [Di, N]; B, C [Bt, T, N]; D [Di] -> y [Bt, T, Di].
    """
    h = u.new_zeros(u.shape[0], u.shape[2], A.shape[1])
    ys = []
    for t in range(u.shape[1]):
        dt_t = dt[:, t, :, None]                                  # [Bt, Di, 1]
        h = torch.exp(dt_t * A) * h + dt_t * B[:, t, None, :] * u[:, t, :, None]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1) + u * D


class MambaBlock(nn.Module):
    """One Mamba block (selective SSM + SiLU gate), the public mamba_ssm
    layer's architecture: x [B, T, d_model] -> [B, T, d_model], causal."""

    JAX_NAMES = {n: n for n in ("in_proj", "conv1d", "x_proj", "dt_proj", "out_proj")}
    JAX_PARAMS = ("A_log", "D")

    D_CONV, EXPAND = 4, 2

    def __init__(self, d_model, d_state=8):
        super().__init__()
        d_inner = self.EXPAND * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = nn.Conv1d(d_inner, d_inner, self.D_CONV, groups=d_inner)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner)
        nn.init.zeros_(self.dt_proj.bias)
        self.A_log = nn.Parameter(torch.log(
            torch.arange(1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        u, z = self.in_proj(x).chunk(2, dim=-1)                   # [B, T, Di]
        # depthwise causal convolution along T: k - 1 steps of left padding
        u = self.conv1d(F.pad(u.transpose(1, 2), (self.D_CONV - 1, 0)))
        u = F.silu(u.transpose(1, 2))
        dt, B, C = self.x_proj(u).split(
            [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt))
        y = selective_scan(u, dt, -torch.exp(self.A_log), B, C, self.D)
        return self.out_proj(y * F.silu(z))


class LNActEncoder(nn.Module):
    """Mamba block over [B, T, action_dim] + MLP -> [B*T, output_dim]."""

    JAX_NAMES = {n: n for n in ("mamba", "fc1", "fc2", "fc3")}

    def __init__(self, action_dim, output_dim):
        super().__init__()
        self.mamba = MambaBlock(action_dim, d_state=8)
        self.fc1 = nn.Linear(action_dim, 64)
        self.fc2 = nn.Linear(64, 128)
        self.fc3 = nn.Linear(128, output_dim)
        for lin in (self.fc1, self.fc2, self.fc3):
            nn.init.zeros_(lin.bias)

    def forward(self, actions_btd):
        h = self.mamba(actions_btd)
        h = h.reshape(-1, h.shape[-1])
        return self.fc3(F.gelu(self.fc2(F.gelu(self.fc1(h)))))
