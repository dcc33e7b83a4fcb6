"""Observation-modality and encoder-core registries (counterpart of the JAX
package's ``utils/obs_utils.py``).

The port keeps its own registries: observation key -> modality, encoder core
and randomizer class name -> class, and the default per-modality encoder
kwargs from ``config.observation.encoder``. Images are channels-last
([..., H, W, C]) at every public function, as in the JAX package.
"""

from copy import deepcopy

import numpy as np

# obs key (e.g. "robot0_eye_in_hand_image") -> modality name (e.g. "rgb")
OBS_KEYS_TO_MODALITIES = None
# encoder core / randomizer class registries (name -> class)
OBS_ENCODER_CORES = {}
OBS_RANDOMIZERS = {}
# default per-modality encoder kwargs (set from config)
DEFAULT_ENCODER_KWARGS = None

LANG_EMB_KEY = "lang_emb"


def register_encoder_core(cls):
    assert cls.__name__ not in OBS_ENCODER_CORES
    OBS_ENCODER_CORES[cls.__name__] = cls
    return cls


def register_randomizer(cls):
    assert cls.__name__ not in OBS_RANDOMIZERS
    OBS_RANDOMIZERS[cls.__name__] = cls
    return cls


def initialize_obs_utils_with_obs_specs(obs_modality_specs):
    """obs_modality_specs: (list of) dict of dicts {group: {modality: [keys]}}."""
    global OBS_KEYS_TO_MODALITIES
    OBS_KEYS_TO_MODALITIES = {}
    if isinstance(obs_modality_specs, dict):
        obs_modality_specs = [obs_modality_specs]
    for spec in obs_modality_specs:
        for modalities in spec.values():
            for modality, keys in modalities.items():
                for k in keys:
                    prev = OBS_KEYS_TO_MODALITIES.get(k)
                    if prev is not None and prev != modality:
                        raise ValueError(
                            f"obs key {k} registered with conflicting "
                            f"modalities {prev} vs {modality}"
                        )
                    OBS_KEYS_TO_MODALITIES[k] = modality


def initialize_default_obs_encoder(obs_encoder_config):
    """Store per-modality encoder kwargs from ``config.observation.encoder``."""
    global DEFAULT_ENCODER_KWARGS
    DEFAULT_ENCODER_KWARGS = {
        modality: deepcopy(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg))
        for modality, cfg in obs_encoder_config.items()
    }


def observation_sections(config):
    """The observation sections of @config (a Config or its dict), the
    actor's last: ``observation`` itself, or for ``hbc`` its planner's and
    actor's, for ``iris`` its value planner's planner and value network's
    and its actor's (JAX ``utils/obs_utils.py:95-114``)."""
    obs = config["observation"]
    if config["algo_name"] == "hbc":
        return [obs["planner"], obs["actor"]]
    if config["algo_name"] == "iris":
        vp = obs["value_planner"]
        return [vp["planner"], vp["value"], obs["actor"]]
    return [obs]


def observation_specs(config):
    """Each observation section's modalities as a plain dict."""
    return [dict(s["modalities"].to_dict() if hasattr(s["modalities"], "to_dict")
                 else s["modalities"]) for s in observation_sections(config)]


def initialize_obs_utils_with_config(config):
    """Parse the observation sections of a full config; the encoder settings
    are the actor's section's."""
    initialize_obs_utils_with_obs_specs(observation_specs(config))
    initialize_default_obs_encoder(observation_sections(config)[-1]["encoder"])


def obs_encoder_kwargs_from_config(obs_encoder_config):
    """Flatten the observation.encoder config into plain dicts."""
    return deepcopy(
        obs_encoder_config.to_dict()
        if hasattr(obs_encoder_config, "to_dict")
        else dict(obs_encoder_config)
    )


def key_is_obs_modality(key, obs_modality):
    """Whether observation @key belongs to @obs_modality (e.g. "low_dim")."""
    if OBS_KEYS_TO_MODALITIES is None:
        raise RuntimeError("call initialize_obs_utils_with_config first")
    return OBS_KEYS_TO_MODALITIES[key] == obs_modality


def process_frame(frame, channel_dim, scale):
    """uint8 [0, scale] HWC -> float32 [0, 1] HWC (channels-last)."""
    if frame.shape[-1] != channel_dim:
        raise ValueError(f"expected {channel_dim} channels, got {frame.shape}")
    return np.clip(np.asarray(frame, dtype=np.float32) / scale, 0.0, 1.0)


# modality -> processor of a raw environment observation (the JAX package's
# Modality classes' defaults)
OBS_PROCESSORS = {
    "rgb": lambda obs: process_frame(obs, channel_dim=3, scale=255.0),
    "depth": lambda obs: process_frame(obs, channel_dim=1, scale=1.0),
}


def process_obs(obs, obs_modality=None, obs_key=None):
    """A raw observation as the networks take it: images float [0, 1],
    everything else float32."""
    if obs_key is not None:
        obs_modality = OBS_KEYS_TO_MODALITIES[obs_key]
    if obs_modality is None:
        raise ValueError("pass obs_modality or obs_key")
    processor = OBS_PROCESSORS.get(obs_modality)
    return processor(obs) if processor else np.asarray(obs, dtype=np.float32)


def process_obs_dict(obs_dict):
    return {k: process_obs(obs, obs_key=k) for k, obs in obs_dict.items()}


def get_processed_shape(obs_modality, input_shape):
    """The shape after processing: images stay channels-last [H, W, C], so
    every modality keeps its shape."""
    return list(input_shape)


def _offset_scale(stats):
    """(offset, scale) of one key's statistics, each [1, ...] -> [...]: the
    action statistics name them ``offset`` / ``scale``, the observation
    statistics of ``SequenceDataset.normalize_obs`` ``mean`` / ``std``."""
    if "offset" in stats:
        return np.asarray(stats["offset"])[0], np.asarray(stats["scale"])[0]
    return np.asarray(stats["mean"])[0], np.asarray(stats["std"])[0]


def normalize_dict(dict_to_norm, normalization_stats):
    """x -> (x - offset) / scale for each key that has statistics; the
    statistics broadcast over the leading dims of the values."""
    out = {}
    for k, v in dict_to_norm.items():
        if k in normalization_stats:
            offset, scale = _offset_scale(normalization_stats[k])
            out[k] = (v - offset) / scale
        else:
            out[k] = v
    return out


def unnormalize_dict(dict_to_unnorm, normalization_stats):
    """The inverse of ``normalize_dict``: x -> x * scale + offset."""
    out = {}
    for k, v in dict_to_unnorm.items():
        if k in normalization_stats:
            offset, scale = _offset_scale(normalization_stats[k])
            out[k] = v * scale + offset
        else:
            out[k] = v
    return out
