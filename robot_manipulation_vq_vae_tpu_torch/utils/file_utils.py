"""Dataset metadata and checkpoint files (the port's counterpart of the JAX
package's ``utils/file_utils.py``).

Files are opened through ``data.dataset.open_hdf5``. A checkpoint is one
``.pth`` file written with ``torch.save`` (to a temporary name, then moved into
place with ``os.replace``) in the reference's layout, which the JAX package
reads with ``load_reference_torch_checkpoint`` and
``ckpt_conversion.convert_flagship_checkpoint``:

    {"model": {"policy.<reference name>": tensor, ..., "vqvae.<name>": tensor,
               ["training_state": {...}]},
     "config": json string, "algo_name", "env_metadata", "shape_metadata"
     (images CHW, as the reference stores them),
     ["obs_normalization_stats"], ["action_normalization_stats"]}

(``algo.Algo.serialize`` makes ``model``.) The JAX package's other format,
orbax, is a TPU format and is not written or read here.
"""

import json
import os
from collections import OrderedDict

import numpy as np
import torch

import robot_manipulation_vq_vae_tpu_torch.algo as Algo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.data import dataset as DatasetUtils
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as LangUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils


# ---------------------------------------------------------------------------
# hdf5 metadata
# ---------------------------------------------------------------------------

def create_hdf5_filter_key(hdf5_path, demo_keys, key_name):
    """Write ``mask/<key_name>`` listing @demo_keys; returns their lengths."""
    with DatasetUtils.open_hdf5(hdf5_path, "a") as f:
        lengths = [f[f"data/{ep}"].attrs["num_samples"] for ep in demo_keys]
        k = f"mask/{key_name}"
        if k in f:
            del f[k]
        f[k] = np.array(demo_keys, dtype="S")
    return np.array(lengths)


def get_demos_for_filter_key(hdf5_path, filter_key):
    with DatasetUtils.open_hdf5(hdf5_path) as f:
        return [e.decode("utf-8") for e in np.array(f[f"mask/{filter_key}"][:])]


def get_env_metadata_from_dataset(dataset_path, ds_format="robomimic"):
    """The environment metadata JSON stored on the ``data`` group."""
    if ds_format != "robomimic":
        raise NotImplementedError(f"data format {ds_format!r} is not ported yet "
                                  "(ROADMAP.md Queue 1)")
    with DatasetUtils.open_hdf5(os.path.expanduser(dataset_path)) as f:
        return json.loads(f["data"].attrs["env_args"])


def get_shape_metadata_from_dataset(dataset_path, action_keys, all_obs_keys=None,
                                    ds_format="robomimic", verbose=False):
    """ac_dim and the processed observation shapes (images HWC). The
    language embedding, which the dataset's language encoder makes where the
    file holds none, has the encoder's width."""
    if ds_format != "robomimic":
        raise NotImplementedError(f"data format {ds_format!r} is not ported yet "
                                  "(ROADMAP.md Queue 1)")
    shape_meta = {}
    with DatasetUtils.open_hdf5(os.path.expanduser(dataset_path)) as f:
        demo = f[f"data/{list(f['data'].keys())[0]}"]
        for key in action_keys:
            if len(demo[key].shape) != 2:
                raise ValueError(f"action key {key} must be 2-D")
        shape_meta["ac_dim"] = int(sum(demo[key].shape[1] for key in action_keys))
        all_shapes = OrderedDict()
        if all_obs_keys is None:
            all_obs_keys = list(demo["obs"].keys())
        for k in sorted(all_obs_keys):
            if k == ObsUtils.LANG_EMB_KEY and f"obs/{k}" not in demo:
                initial_shape = (LangUtils.EMB_DIM,)
            else:
                initial_shape = demo[f"obs/{k}"].shape[1:]
            if verbose:
                print(f"obs key {k} with shape {initial_shape}")
            all_shapes[k] = ObsUtils.get_processed_shape(
                obs_modality=ObsUtils.OBS_KEYS_TO_MODALITIES[k],
                input_shape=initial_shape,
            )
    shape_meta["all_shapes"] = all_shapes
    shape_meta["all_obs_keys"] = all_obs_keys
    shape_meta["use_images"] = any(
        ObsUtils.OBS_KEYS_TO_MODALITIES[k] == "rgb" for k in all_obs_keys)
    return shape_meta


def atomic_write_json(path, obj, indent=None):
    """Write JSON to a temporary name and move it into place: a reader never
    sees a torn file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _rgb_keys(config):
    return {k for spec in ObsUtils.observation_specs(config)
            for k in spec["obs"].get("rgb", [])}


def shape_metadata_to_reference(shape_meta, config):
    """The reference stores image shapes CHW; the port's are HWC."""
    rgb = _rgb_keys(config)
    out = dict(shape_meta)
    out["all_shapes"] = {k: ([s[2], s[0], s[1]] if k in rgb and len(s) == 3
                             else list(s))
                         for k, s in shape_meta["all_shapes"].items()}
    return out


def shape_metadata_from_reference(shape_meta, config):
    """Inverse of ``shape_metadata_to_reference``: image shapes CHW -> HWC."""
    rgb = _rgb_keys(config)
    out = dict(shape_meta)
    out["all_shapes"] = {k: (list(s[1:]) + [s[0]] if k in rgb and len(s) == 3
                             else list(s))
                         for k, s in shape_meta["all_shapes"].items()}
    return out


def save_checkpoint(ckpt_dict, ckpt_path):
    """``torch.save`` @ckpt_dict to @ckpt_path (a ``.pth`` file) through a
    temporary name and ``os.replace``: an interrupted save leaves the last
    complete checkpoint in place."""
    ckpt_path = os.path.expanduser(ckpt_path)
    if not ckpt_path.endswith(".pth"):
        raise ValueError(f"checkpoints are .pth files: {ckpt_path}")
    os.makedirs(os.path.dirname(os.path.abspath(ckpt_path)), exist_ok=True)
    tmp = f"{ckpt_path}.{os.getpid()}.tmp"
    try:
        torch.save(ckpt_dict, tmp)
        os.replace(tmp, ckpt_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def maybe_dict_from_checkpoint(ckpt_path=None, ckpt_dict=None):
    """The checkpoint dict: @ckpt_dict, or the one in the ``.pth`` at
    @ckpt_path (its tensors on the CPU)."""
    if ckpt_dict is not None:
        return ckpt_dict
    if ckpt_path is None:
        raise ValueError("pass ckpt_path or ckpt_dict")
    # the checkpoint holds numpy statistics and the config, not only tensors;
    # it is a file this program wrote
    return torch.load(os.path.expanduser(ckpt_path), map_location="cpu",
                      weights_only=False)


def config_from_checkpoint(algo_name=None, ckpt_path=None, ckpt_dict=None,
                           verbose=False):
    """The locked Config the checkpoint was trained with, and the dict."""
    ckpt_dict = maybe_dict_from_checkpoint(ckpt_path, ckpt_dict)
    if algo_name is None:
        algo_name = ckpt_dict["algo_name"]
    config = config_factory(algo_name, dic=json.loads(ckpt_dict["config"]))
    if verbose:
        print(f"loaded config from checkpoint:\n{config}")
    config.lock()
    return config, ckpt_dict


def algo_from_checkpoint(device=None, ckpt_path=None, ckpt_dict=None, verbose=False):
    """Rebuild the trained algo from a checkpoint on @device (``cuda`` unless
    given): (algo in eval mode, ckpt_dict). ``policy_from_checkpoint`` wraps
    it for rollouts."""
    ckpt_dict = maybe_dict_from_checkpoint(ckpt_path, ckpt_dict)
    config, _ = config_from_checkpoint(ckpt_dict=ckpt_dict, verbose=verbose)
    ObsUtils.initialize_obs_utils_with_config(config)
    shape_meta = shape_metadata_from_reference(ckpt_dict["shape_metadata"],
                                               json.loads(ckpt_dict["config"]))
    algo = Algo.algo_factory(ckpt_dict["algo_name"], config,
                             obs_key_shapes=shape_meta["all_shapes"],
                             ac_dim=shape_meta["ac_dim"], device=device)
    algo.deserialize(ckpt_dict["model"])
    algo.set_eval()
    return algo, ckpt_dict


def policy_from_checkpoint(device=None, ckpt_path=None, ckpt_dict=None, verbose=False):
    """A rollout policy from a checkpoint: (``ICLRolloutPolicy`` for an algo
    whose ``get_action`` takes a context window, else ``RolloutPolicy``;
    with the checkpoint's normalization statistics and, where the algo
    takes ``lang_emb``, a ``LangEncoder``; ckpt_dict). The algo runs on
    @device (``cuda`` unless given). (The JAX package picks the wrapper by
    the algo's name, and so gives the MLP and RNN ICL policies a wrapper
    that passes them a context they do not take.)"""
    algo, ckpt_dict = algo_from_checkpoint(device=device, ckpt_path=ckpt_path,
                                           ckpt_dict=ckpt_dict, verbose=verbose)
    lang_encoder = None
    if LangUtils.LANG_EMB_KEY in algo.obs_shapes:
        lang_encoder = LangUtils.LangEncoder()
    policy = Algo.rollout_policy_class(algo)(algo,
                     obs_normalization_stats=ckpt_dict.get("obs_normalization_stats"),
                     action_normalization_stats=ckpt_dict.get("action_normalization_stats"),
                     lang_encoder=lang_encoder)
    return policy, ckpt_dict


def env_from_checkpoint(ckpt_path=None, ckpt_dict=None, env_name=None, render=False,
                        render_offscreen=False):
    """The checkpoint's eval env (named @env_name where given), unwrapped:
    (env, ckpt_dict)."""
    from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils

    ckpt_dict = maybe_dict_from_checkpoint(ckpt_path, ckpt_dict)
    env_meta = dict(ckpt_dict["env_metadata"])
    if env_name is not None:
        env_meta["env_name"] = env_name
    env = EnvUtils.create_env_from_metadata(env_meta=env_meta, render=render,
                                            render_offscreen=render_offscreen)
    return env, ckpt_dict
