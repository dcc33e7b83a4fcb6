"""Observation encoder / decoder and the transformer assemblies (counterpart
of the JAX package's ``models/obs_nets.py``:220-461, 469-578, 602-694,
697-792): ``MIMO_Transformer`` over the observation groups, and the in-context
``ICL_MIMO_Transformer``.

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

from robot_manipulation_vq_vae_tpu_torch.models import obs_core
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.models.transformers import (
    GPT_Backbone,
    LN_EPS,
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
    order. Keys without a core class pass through flattened."""

    def __init__(self, obs_shapes, encoder_kwargs=None):
        super().__init__()
        self.spec = _spec_items(obs_shapes)
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
            kwargs = dict(cfg.get("core_kwargs") or {})
            if core_class == "VisualCoreLanguageConditioned":
                kwargs["lang_emb_dim"] = shapes[LANG_EMB_KEY][0]
            core = ObsUtils.OBS_ENCODER_CORES[core_class](in_shape, **kwargs)
            cores[key] = core
            self.output_dim += core.proj.out_features
        self.obs_nets = nn.ModuleDict(cores)

    def jax_names(self):
        return {f"core_{key}": f"obs_nets.{key}" for key in self.obs_nets}

    def forward(self, obs_dict, generator=None):
        feats = []
        for key, _ in self.spec:
            x = obs_dict[key]
            for rand in self.randomizers[key]:
                x = rand.forward_in(x, generator, self.training)
            if key in self.obs_nets:
                core = self.obs_nets[key]
                lang = isinstance(core, obs_core.VisualCoreLanguageConditioned)
                x = core(x, obs_dict[LANG_EMB_KEY]) if lang else core(x)
            for rand in self.randomizers[key]:
                x = rand.forward_out(x)
            feats.append(x.reshape(x.shape[0], -1))
        return torch.cat(feats, dim=-1)


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

    def __init__(self, observation_group_shapes, encoder_kwargs=None):
        super().__init__()
        self.groups = [g for g, _ in observation_group_shapes]
        self.nets = nn.ModuleDict({
            group: ObservationEncoder(shapes, encoder_kwargs)
            for group, shapes in observation_group_shapes
        })
        self.output_dim = sum(enc.output_dim for enc in self.nets.values())

    def jax_names(self):
        return {f"enc_{g}": f"nets.{g}" for g in self.nets}

    def forward(self, inputs, generator=None):
        return torch.cat([self.nets[g](inputs[g], generator) for g in self.groups],
                         dim=-1)


class ICLObservationGroupEncoder(ObservationGroupEncoder):
    """Obs-group encoder + prompt-action tokenizer. Of the four tokenizer
    modalities only LipVQ (``vq_vae_enabled``) is ported; the others raise.

    forward returns (obs, context_obs, context_actions, vq_vae_loss); every
    input is time-folded ([B*T, ...]) by the caller. The query groups are
    encoded before the context group.
    """

    def __init__(self, observation_group_shapes, action_input_shape=12,
                 fast_enabled=False, bin_enabled=False, vq_vae_enabled=False,
                 ln_act_enabled=False, encoder_kwargs=None, use_kernels=True):
        if sum([fast_enabled, bin_enabled, vq_vae_enabled, ln_act_enabled]) > 1:
            raise ValueError("at most one tokenizer modality may be enabled")
        if not vq_vae_enabled:
            raise NotImplementedError(
                "only the LipVQ (vq_vae) action tokenizer is ported yet; the "
                "FAST, bin, LN-act and default modalities are queued in ROADMAP.md"
            )
        super().__init__(observation_group_shapes, encoder_kwargs)
        self.action_network = LipVQVAE(
            feature_dim=action_input_shape, latent_dim=self.output_dim,
            use_kernel=use_kernels,
        )

    def jax_names(self):
        return {**super().jax_names(), "action_network": "action_network"}

    def forward(self, inputs, generator=None):
        obs = super().forward(inputs, generator)
        context_obs = self.nets["obs"](inputs["prompt"]["obs"], generator)
        context_actions, vq_vae_loss = self.action_network(
            inputs["prompt"]["action"]
        )
        return obs, context_obs, context_actions, vq_vae_loss


class _TransformerEmbedding(nn.Module):
    """Shared input embedding: Linear + timestep embedding + LayerNorm +
    dropout."""

    JAX_NAMES = {"embed_encoder": "embed_encoder", "embed_ln": "embed_ln"}

    def __init__(self, input_dim, embed_dim, context_length, emb_dropout=0.1,
                 sinusoidal=False, nn_parameter_for_timesteps=False):
        super().__init__()
        if sinusoidal:
            raise NotImplementedError("sinusoidal embeddings are not ported yet")
        self.nn_parameter_for_timesteps = nn_parameter_for_timesteps
        self.embed_encoder = nn.Linear(input_dim, embed_dim)
        nn.init.zeros_(self.embed_encoder.bias)
        if nn_parameter_for_timesteps:
            self.embed_timestep = nn.Parameter(
                torch.zeros(1, context_length, embed_dim)
            )
        else:
            self.embed_timestep_table = nn.Parameter(
                0.02 * torch.randn(context_length, embed_dim)
            )
        self.embed_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.embed_drop = nn.Dropout(emb_dropout)
        self.JAX_PARAMS = (
            ("embed_timestep",) if nn_parameter_for_timesteps
            else ("embed_timestep_table",)
        )

    def forward(self, x):
        emb = self.embed_encoder(x)
        t = emb.shape[1]
        if self.nn_parameter_for_timesteps:
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
    the T query obs -> 3T tokens -> GPT (context 3T) -> decode the last T.
    One embedding, with shared weights, embeds all three token kinds."""

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
        if backbone_type != "gpt":
            raise NotImplementedError(f"backbone {backbone_type} is not ported yet")
        self.group_names = [g for g, _ in input_obs_group_shapes]
        self.encoder = ICLObservationGroupEncoder(
            input_obs_group_shapes,
            action_input_shape=action_input_shape,
            fast_enabled=transformer_fast_enabled,
            bin_enabled=transformer_bin_enabled,
            vq_vae_enabled=transformer_vq_vae_enabled,
            ln_act_enabled=transformer_ln_act_enabled,
            encoder_kwargs=encoder_kwargs,
            use_kernels=use_kernels,
        )
        self.embedding = _TransformerEmbedding(
            self.encoder.output_dim, transformer_embed_dim,
            transformer_context_length, transformer_emb_dropout,
            transformer_sinusoidal_embedding,
            transformer_nn_parameter_for_timesteps,
        )
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
