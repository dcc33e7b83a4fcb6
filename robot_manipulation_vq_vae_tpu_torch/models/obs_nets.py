"""Observation encoder / decoder and the sequence assemblies (counterpart
of the JAX package's ``models/obs_nets.py``:220-461, 469-599, 602-694,
697-825): ``MIMO_Transformer`` over the observation groups, the in-context
``ICL_MIMO_Transformer`` with a GPT or a Mamba backbone (``Mamba_Backbone``),
and ``MIMO_MLP``.

Per-key encoder cores and randomizers are built from the same config-shaped
dicts as in the JAX package (``observation.encoder.*``); features are
concatenated in the order of the observation spec. Images are channels-last
at the public functions. In training, the randomizers draw from the
``torch.Generator`` passed down from the algo, key by key in spec order, the
query groups before the context group, as the JAX package draws its
``randomizer`` rng; the order also fixes the order of BatchNorm's updates.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_core
from robot_manipulation_vq_vae_tpu_torch.models.packed_film import PackedResNet18ConvFiLM
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.bin_action import (
    AdaptiveBinActionEmbedding,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.default_encoder import (
    DefaultActionEncoder,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import FastProjection
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.ln_act import (
    LNActEncoder,
    MambaBlock,
)
from robot_manipulation_vq_vae_tpu_torch.models.transformers import (
    GPT_Backbone,
    LN_EPS,
    sinusoidal_positional_encoding,
)
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils

LANG_EMB_KEY = ObsUtils.LANG_EMB_KEY


def _spec_items(obs_shapes):
    """dict or ((key, shape), ...) -> [(key, shape tuple), ...] in order."""
    items = obs_shapes.items() if isinstance(obs_shapes, dict) else obs_shapes
    return [(k, tuple(s)) for k, s in items]


def _key_encoder_config(key, encoder_kwargs):
    modality = ObsUtils.OBS_KEYS_TO_MODALITIES[key]
    if encoder_kwargs is not None and modality in encoder_kwargs:
        return dict(encoder_kwargs[modality])
    if ObsUtils.DEFAULT_ENCODER_KWARGS is not None:
        return dict(ObsUtils.DEFAULT_ENCODER_KWARGS.get(modality, {}))
    return {}


def _build_randomizers(cfg, shape):
    cls_list = cfg.get("obs_randomizer_class") or None
    kw_list = cfg.get("obs_randomizer_kwargs") or {}
    if not isinstance(cls_list, (list, tuple)):
        cls_list = [cls_list]
    if not isinstance(kw_list, (list, tuple)):
        kw_list = [kw_list]
    rands = []
    for cls_name, kw in zip(cls_list, kw_list):
        if cls_name is not None:
            rands.append(ObsUtils.OBS_RANDOMIZERS[cls_name](
                input_shape=tuple(shape), **dict(kw or {})
            ))
    return rands


class ObservationEncoder(nn.Module):
    """Per-key core + randomizer encoder; concatenates flat features in spec
    order. Keys without a core class pass through flattened.

    The randomizers run for every key in spec order before any core, so
    their draws are the same whether or not the cameras' trunks are packed
    (``set_packed``, ``train.packed_rgb_encoders``): then the eligible
    cameras (``packed_rgb_keys``) run through one ``PackedResNet18ConvFiLM``
    over their own trunks, their images concatenated on the channels in
    spec order, and each camera's features through its own core's head.
    With ``feature_activation="relu"`` (the MLP and RNN policies') each
    core's features pass through a ReLU; keys without a core do not. The
    randomizers' ``forward_out`` run in list order, as JAX's. @generator
    also draws the cores' SpatialSoftmax keypoint noise in training."""

    def __init__(self, obs_shapes, encoder_kwargs=None, feature_activation=None):
        super().__init__()
        if feature_activation not in (None, "relu"):
            raise ValueError(f"feature_activation {feature_activation} is not relu or None")
        self.spec = _spec_items(obs_shapes)
        self.encoder_kwargs = encoder_kwargs
        self.feature_activation = feature_activation
        shapes = dict(self.spec)
        self.randomizers = {}
        cores = {}
        self.output_dim = 0
        for key, shape in self.spec:
            cfg = _key_encoder_config(key, encoder_kwargs)
            rands = _build_randomizers(cfg, shape)
            self.randomizers[key] = rands
            core_class = cfg.get("core_class")
            if core_class is None:
                self.output_dim += int(np.prod(shape))
                continue
            in_shape = shape
            for rand in rands:
                in_shape = tuple(rand.output_shape_in(in_shape))
            core_cls = ObsUtils.OBS_ENCODER_CORES[core_class]
            # the kwargs the core takes, as JAX keeps its module's fields
            kwargs = obs_core._filter_kwargs(core_cls, cfg.get("core_kwargs"))
            kwargs.pop("input_shape", None)
            if core_class == "VisualCoreLanguageConditioned":
                kwargs["lang_emb_dim"] = shapes[LANG_EMB_KEY][0]
            core = core_cls(in_shape, **kwargs)
            cores[key] = core
            out_shape = core.output_shape(in_shape)
            for rand in rands:
                out_shape = rand.output_shape_out(out_shape)
            self.output_dim += int(np.prod(out_shape))
        self.obs_nets = nn.ModuleDict(cores)
        self.packed_keys = []
        self.packed = None

    def jax_names(self):
        return {f"core_{key}": f"obs_nets.{key}" for key in self.obs_nets}

    def packed_rgb_keys(self):
        """The keys that ``set_packed`` packs, in spec order: at least two
        rgb keys of one shape with one FiLM-ResNet18
        ``VisualCoreLanguageConditioned`` configuration, batch norm and no
        coord-conv (JAX ``_packed_rgb_keys``); else none."""
        keys, sig = [], None
        for key, shape in self.spec:
            if ObsUtils.OBS_KEYS_TO_MODALITIES.get(key) != "rgb":
                continue
            cfg = _key_encoder_config(key, self.encoder_kwargs)
            if cfg.get("core_class") != "VisualCoreLanguageConditioned":
                return []
            ckw = dict(cfg.get("core_kwargs") or {})
            if ckw.get("backbone_class", "ResNet18ConvFiLM") != "ResNet18ConvFiLM":
                return []
            bkw = dict(ckw.get("backbone_kwargs") or {})
            if bkw.get("norm", "batch") != "batch" or bkw.get("input_coord_conv", False):
                return []
            this = (tuple(shape), repr(sorted(ckw.items())), repr(sorted(cfg.items())))
            if sig is None:
                sig = this
            elif this != sig:
                return []
            keys.append(key)
        return keys if len(keys) >= 2 else []

    def set_packed(self, enabled):
        """Pack the eligible cameras' trunks (or unpack them); the packed
        trunk owns nothing, so the parameters stay where they are."""
        self.packed_keys = self.packed_rgb_keys() if enabled else []
        self.packed = (PackedResNet18ConvFiLM(
            [self.obs_nets[k].backbone for k in self.packed_keys])
            if self.packed_keys else None)

    def forward(self, obs_dict, generator=None):
        randomized = {}
        for key, _ in self.spec:
            x = obs_dict[key]
            for rand in self.randomizers[key]:
                x = rand.forward_in(x, generator, self.training)
            randomized[key] = x
        feats = {}
        if self.packed is not None:
            images = torch.cat([randomized[k] for k in self.packed_keys], dim=-1)
            trunk = self.packed(images.permute(0, 3, 1, 2).contiguous(),
                                obs_dict[LANG_EMB_KEY])
            for key, x in zip(self.packed_keys, trunk.chunk(len(self.packed_keys), 1)):
                feats[key] = self.obs_nets[key].head(x, generator)
        out = []
        for key, _ in self.spec:
            x = feats.get(key)
            if x is None and key in self.obs_nets:
                core = self.obs_nets[key]
                lang = isinstance(core, obs_core.VisualCoreLanguageConditioned)
                x = (core(randomized[key], obs_dict[LANG_EMB_KEY], generator) if lang
                     else core(randomized[key], generator=generator))
            if x is None:
                x = randomized[key]
            elif self.feature_activation == "relu":
                x = F.relu(x)
            for rand in self.randomizers[key]:
                x = rand.forward_out(x)
            out.append(x.reshape(x.shape[0], -1))
        return torch.cat(out, dim=-1)


def unported_in_mixed_precision(module):
    """The names of the modules and randomizers under @module that
    ``train.mixed_precision`` has not been held against the JAX bf16 step
    with (``MIXED_PRECISION`` False): the algo refuses the mode for them."""
    names = {type(m).__name__ for m in module.modules()
             if getattr(m, "MIXED_PRECISION", True) is False}
    for enc in module.modules():
        if isinstance(enc, ObservationEncoder):
            names.update(type(r).__name__ for rands in enc.randomizers.values()
                         for r in rands if not r.MIXED_PRECISION)
    return sorted(names)


def set_packed_rgb_encoders(module, enabled):
    """Pack (or unpack) the eligible cameras of every ObservationEncoder
    under @module (``train.packed_rgb_encoders``; see ``ObservationEncoder``)."""
    for m in [m for m in module.modules() if isinstance(m, ObservationEncoder)]:
        m.set_packed(enabled)


class ObservationDecoder(nn.Module):
    """Per-key linear heads from a flat feature."""

    def __init__(self, decode_shapes, input_dim):
        super().__init__()
        self.shapes = _spec_items(decode_shapes)
        self.nets = nn.ModuleDict({
            key: nn.Linear(input_dim, int(np.prod(shape)))
            for key, shape in self.shapes
        })
        for lin in self.nets.values():
            nn.init.zeros_(lin.bias)

    def jax_names(self):
        return {f"head_{key}": f"nets.{key}" for key in self.nets}

    def forward(self, feats):
        return {
            key: self.nets[key](feats).reshape(*feats.shape[:-1], *shape)
            for key, shape in self.shapes
        }


class ObservationGroupEncoder(nn.Module):
    """One ObservationEncoder per observation group; concatenates the
    groups' features in group order."""

    def __init__(self, observation_group_shapes, encoder_kwargs=None,
                 feature_activation=None):
        super().__init__()
        self.groups = [g for g, _ in observation_group_shapes]
        self.nets = nn.ModuleDict({
            group: ObservationEncoder(shapes, encoder_kwargs, feature_activation)
            for group, shapes in observation_group_shapes
        })
        self.output_dim = sum(enc.output_dim for enc in self.nets.values())

    def jax_names(self):
        return {f"enc_{g}": f"nets.{g}" for g in self.nets}

    def forward(self, inputs, generator=None):
        return torch.cat([self.nets[g](inputs[g], generator) for g in self.groups],
                         dim=-1)


class ICLObservationGroupEncoder(ObservationGroupEncoder):
    """Obs-group encoder + prompt-action tokenizer: at most one of FAST, bin,
    LipVQ (``vq_vae_enabled``) and LN-act, else the spectral-norm default
    encoder.

    forward returns (obs, context_obs, context_actions, vq_vae_loss);
    vq_vae_loss is None unless LipVQ is on. Every input is time-folded
    ([B*T, ...]) by the caller; the context actions are [B*T, A], or the
    host-encoded CLIP latents [B*T, 512] with FAST. LN-act reshapes them to
    [B, prompt_seq_len, A]. The query groups are encoded before the context
    group. A training forward (``self.training``) moves the bin statistics
    and the spectral-norm vectors and applies the default encoder's dropout.
    """

    def __init__(self, observation_group_shapes, action_input_shape=12,
                 fast_enabled=False, bin_enabled=False, vq_vae_enabled=False,
                 ln_act_enabled=False, encoder_kwargs=None, prompt_seq_len=10,
                 use_kernels=True):
        if sum([fast_enabled, bin_enabled, vq_vae_enabled, ln_act_enabled]) > 1:
            raise ValueError("at most one tokenizer modality may be enabled")
        super().__init__(observation_group_shapes, encoder_kwargs)
        self.vq_vae_enabled = vq_vae_enabled
        self.ln_act_enabled = ln_act_enabled
        self.prompt_seq_len = prompt_seq_len
        out_dim = self.output_dim
        if fast_enabled:
            self.action_network = FastProjection(out_dim)
        elif bin_enabled:
            self.action_network = AdaptiveBinActionEmbedding(action_input_shape, out_dim)
        elif vq_vae_enabled:
            self.action_network = LipVQVAE(
                feature_dim=action_input_shape, latent_dim=out_dim,
                use_kernel=use_kernels,
            )
        elif ln_act_enabled:
            self.action_network = LNActEncoder(action_input_shape, out_dim)
        else:
            self.action_network = DefaultActionEncoder(action_input_shape, out_dim)

    def jax_names(self):
        return {**super().jax_names(), "action_network": "action_network"}

    def forward(self, inputs, generator=None):
        obs = super().forward(inputs, generator)
        context_obs = self.nets["obs"](inputs["prompt"]["obs"], generator)
        prompt_actions = inputs["prompt"]["action"]
        vq_vae_loss = None
        if self.vq_vae_enabled:
            context_actions, vq_vae_loss = self.action_network(prompt_actions)
        elif self.ln_act_enabled:
            context_actions = self.action_network(prompt_actions.reshape(
                -1, self.prompt_seq_len, prompt_actions.shape[-1]))
        else:
            context_actions = self.action_network(prompt_actions)
        return obs, context_obs, context_actions, vq_vae_loss


class Mamba_Backbone(nn.Module):
    """Mamba blocks (d_state 16, d_conv 4, expand 2) as pre-LN residual
    layers, ``x + mamba_i(ln_i(x))``, then an output LayerNorm: the
    state-space twin of ``GPT_Backbone`` (JAX ``Mamba_Backbone``), causal by
    construction. Each block's selective scan is ``ln_act.selective_scan``,
    a loop over the T tokens in plain PyTorch: the JAX package computes it
    with ``lax.associative_scan``, outside any Pallas kernel."""

    D_STATE = 16

    def __init__(self, embed_dim, num_layers=6):
        super().__init__()
        self.ln = nn.ModuleList([nn.LayerNorm(embed_dim, eps=LN_EPS)
                                 for _ in range(num_layers)])
        self.mamba = nn.ModuleList([MambaBlock(embed_dim, d_state=self.D_STATE)
                                    for _ in range(num_layers)])
        self.output_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def jax_names(self):
        names = {"output_ln": "output_ln"}
        for i in range(len(self.ln)):
            names[f"ln{i}"] = f"ln.{i}"
            names[f"mamba{i}"] = f"mamba.{i}"
        return names

    def forward(self, x):
        for ln, mamba in zip(self.ln, self.mamba):
            x = x + mamba(ln(x))
        return self.output_ln(x)


class _TransformerEmbedding(nn.Module):
    """Shared input embedding: Linear + timestep embedding (a learned table,
    a zero-initialized parameter, or the fixed sinusoidal encoding) +
    LayerNorm + dropout."""

    JAX_NAMES = {"embed_encoder": "embed_encoder", "embed_ln": "embed_ln"}

    def __init__(self, input_dim, embed_dim, context_length, emb_dropout=0.1,
                 sinusoidal=False, nn_parameter_for_timesteps=False):
        super().__init__()
        self.sinusoidal = sinusoidal
        self.nn_parameter_for_timesteps = nn_parameter_for_timesteps
        self.embed_encoder = nn.Linear(input_dim, embed_dim)
        nn.init.zeros_(self.embed_encoder.bias)
        self.JAX_PARAMS = ()   # the sinusoidal encoding has no parameter
        if sinusoidal:
            pass
        elif nn_parameter_for_timesteps:
            self.embed_timestep = nn.Parameter(
                torch.zeros(1, context_length, embed_dim)
            )
            self.JAX_PARAMS = ("embed_timestep",)
        else:
            self.embed_timestep_table = nn.Parameter(
                0.02 * torch.randn(context_length, embed_dim)
            )
            self.JAX_PARAMS = ("embed_timestep_table",)
        self.embed_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.embed_drop = nn.Dropout(emb_dropout)

    def forward(self, x):
        emb = self.embed_encoder(x)
        t = emb.shape[1]
        if self.sinusoidal:
            time_emb = sinusoidal_positional_encoding(
                t, emb.shape[-1], emb.device)[None].to(emb.dtype)
        elif self.nn_parameter_for_timesteps:
            time_emb = self.embed_timestep[:, :t]
        else:
            time_emb = self.embed_timestep_table[None, :t]
        return self.embed_drop(self.embed_ln(emb + time_emb))


class MIMO_Transformer(nn.Module):
    """Observation groups -> time-folded encoder -> embedding -> GPT over the
    T steps -> per-step decoder heads."""

    JAX_NAMES = {"encoder": "encoder", "embedding": "embedding",
                 "transformer": "transformer", "decoder": "decoder"}

    def __init__(self, input_obs_group_shapes, output_shapes,
                 transformer_embed_dim, transformer_num_layers,
                 transformer_num_heads, transformer_context_length,
                 transformer_causal=True, transformer_emb_dropout=0.1,
                 transformer_attn_dropout=0.1,
                 transformer_block_output_dropout=0.1,
                 transformer_sinusoidal_embedding=False,
                 transformer_activation="gelu",
                 transformer_nn_parameter_for_timesteps=False,
                 encoder_kwargs=None):
        super().__init__()
        self.group_names = [g for g, _ in input_obs_group_shapes]
        self.encoder = ObservationGroupEncoder(input_obs_group_shapes, encoder_kwargs)
        self.embedding = _TransformerEmbedding(
            self.encoder.output_dim, transformer_embed_dim,
            transformer_context_length, transformer_emb_dropout,
            transformer_sinusoidal_embedding,
            transformer_nn_parameter_for_timesteps,
        )
        self.transformer = GPT_Backbone(
            embed_dim=transformer_embed_dim,
            context_length=transformer_context_length,
            causal=transformer_causal,
            attn_dropout=transformer_attn_dropout,
            block_output_dropout=transformer_block_output_dropout,
            num_layers=transformer_num_layers,
            num_heads=transformer_num_heads,
            activation=transformer_activation,
        )
        self.decoder = ObservationDecoder(output_shapes, transformer_embed_dim)

    def forward(self, generator=None, **inputs):
        """Each group's observations [B, T, ...]; @generator draws the
        randomizers' crops in training."""
        folded, b, t = TensorUtils.fold_time(
            {g: inputs[g] for g in self.group_names if inputs.get(g)}
        )
        seq = self.encoder(folded, generator).reshape(b, t, -1)
        hidden = self.transformer(self.embedding(seq))
        out = self.decoder(hidden)
        out["transformer_encoder_outputs"] = hidden
        return out


class ICL_MIMO_Transformer(nn.Module):
    """In-context assembly: interleave [ctx_obs_t, ctx_act_t] pairs, append
    the T query obs -> 3T tokens -> GPT (context 3T), or with
    ``backbone_type="mamba"`` a ``Mamba_Backbone`` of as many layers ->
    decode the last T. One embedding, with shared weights, embeds all three
    token kinds."""

    JAX_NAMES = {"encoder": "encoder", "embedding": "embedding",
                 "transformer": "transformer", "decoder": "decoder"}

    def __init__(self, input_obs_group_shapes, output_shapes,
                 transformer_embed_dim, transformer_num_layers,
                 transformer_num_heads, transformer_context_length,
                 transformer_causal=True, transformer_emb_dropout=0.1,
                 transformer_attn_dropout=0.1,
                 transformer_block_output_dropout=0.1,
                 transformer_sinusoidal_embedding=False,
                 transformer_activation="gelu",
                 transformer_fast_enabled=False, transformer_bin_enabled=False,
                 transformer_vq_vae_enabled=False,
                 transformer_ln_act_enabled=False,
                 transformer_nn_parameter_for_timesteps=False,
                 action_input_shape=12, backbone_type="gpt",
                 encoder_kwargs=None, use_kernels=True):
        super().__init__()
        if backbone_type not in ("gpt", "mamba"):
            raise ValueError(f"backbone {backbone_type} is neither gpt nor mamba")
        self.group_names = [g for g, _ in input_obs_group_shapes]
        self.encoder = ICLObservationGroupEncoder(
            input_obs_group_shapes,
            action_input_shape=action_input_shape,
            fast_enabled=transformer_fast_enabled,
            bin_enabled=transformer_bin_enabled,
            vq_vae_enabled=transformer_vq_vae_enabled,
            ln_act_enabled=transformer_ln_act_enabled,
            encoder_kwargs=encoder_kwargs,
            prompt_seq_len=transformer_context_length,
            use_kernels=use_kernels,
        )
        self.embedding = _TransformerEmbedding(
            self.encoder.output_dim, transformer_embed_dim,
            transformer_context_length, transformer_emb_dropout,
            transformer_sinusoidal_embedding,
            transformer_nn_parameter_for_timesteps,
        )
        if backbone_type == "mamba":
            self.transformer = Mamba_Backbone(transformer_embed_dim,
                                              transformer_num_layers)
        else:
            self.transformer = GPT_Backbone(
                embed_dim=transformer_embed_dim,
                # x3: interleaved [ctx_obs, ctx_act] pairs + query obs
                context_length=transformer_context_length * 3,
                causal=transformer_causal,
                attn_dropout=transformer_attn_dropout,
                block_output_dropout=transformer_block_output_dropout,
                num_layers=transformer_num_layers,
                num_heads=transformer_num_heads,
                activation=transformer_activation,
            )
        self.decoder = ObservationDecoder(output_shapes, transformer_embed_dim)

    def forward(self, generator=None, **inputs):
        """@generator draws the randomizers' crops in training."""
        present = {g: inputs[g] for g in self.group_names
                   if inputs.get(g) is not None}
        present["prompt"] = inputs["prompt"]
        folded, b, t = TensorUtils.fold_time(present)
        obs, ctx_obs, ctx_act, vq_loss = self.encoder(folded, generator)

        obs_emb = self.embedding(obs.reshape(b, t, -1))
        ctx_obs_emb = self.embedding(ctx_obs.reshape(b, t, -1))
        ctx_act_emb = self.embedding(ctx_act.reshape(b, t, -1))

        interleaved = torch.stack([ctx_obs_emb, ctx_act_emb], dim=2)
        tokens = torch.cat([interleaved.reshape(b, 2 * t, -1), obs_emb], dim=1)

        hidden = self.transformer(tokens)
        out = self.decoder(hidden[:, -t:])
        out["transformer_encoder_outputs"] = hidden
        out["vq_vae_loss"] = vq_loss
        return out


class MIMO_MLP(nn.Module):
    """Observation groups -> flat features (each core's through a ReLU) ->
    MLP (ReLU after every layer, the last included) -> per-key linear heads
    (JAX ``MIMO_MLP``). With no @layer_dims the heads read the features."""

    def __init__(self, input_obs_group_shapes, output_shapes, layer_dims,
                 encoder_kwargs=None):
        super().__init__()
        self.encoder = ObservationGroupEncoder(input_obs_group_shapes, encoder_kwargs,
                                               feature_activation="relu")
        dim = self.encoder.output_dim
        self.mlp = None
        if layer_dims:
            self.mlp = BaseNets.MLP(dim, layer_dims[-1], layer_dims[:-1],
                                    output_activation=nn.ReLU)
            dim = layer_dims[-1]
        self.decoder = ObservationDecoder(output_shapes, dim)

    def jax_names(self):
        names = {"encoder": "encoder", "decoder": "decoder"}
        if self.mlp is not None:
            names["mlp"] = "mlp"
        return names

    def forward(self, inputs, generator=None):
        """@inputs: {group: observations [B, ...]}; @generator draws the
        randomizers' crops in training."""
        flat = self.encoder(inputs, generator)
        if self.mlp is not None:
            flat = self.mlp(flat)
        return self.decoder(flat)
