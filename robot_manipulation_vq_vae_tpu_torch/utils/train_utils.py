"""Training harness utilities (the port's counterpart of the JAX package's
``utils/train_utils.py``): experiment directories, the dataset factory, the
epoch loop with its timing buckets, and checkpoint saving. Rollouts are not
ported yet (ROADMAP.md Queue 1 item 2).
"""

import datetime
import os
import time
from copy import deepcopy

import numpy as np
import torch

from robot_manipulation_vq_vae_tpu_torch.data.dataset import MetaDataset, SequenceDataset
from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import log_utils as LogUtils
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils


def get_exp_dir(config):
    """Create <output_dir>/<experiment name>/<time>/{logs,models,videos};
    returns (log_dir, ckpt_dir, video_dir, time_str)."""
    time_str = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
    base = os.path.abspath(os.path.expanduser(config.train.output_dir))
    base = os.path.join(base, config.experiment.name, time_str)
    dirs = [os.path.join(base, d) for d in ("logs", "models", "videos")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    return (*dirs, time_str)


def load_data_for_training(config, obs_keys, lang_encoder=None):
    """The training dataset, and the validation one when
    ``experiment.validate`` asks for it."""
    if config.experiment.validate and config.train.hdf5_validation_filter_key is None:
        raise ValueError("experiment.validate needs train.hdf5_validation_filter_key")
    train_dataset = dataset_factory(
        config, obs_keys, filter_by_attribute=config.train.hdf5_filter_key,
        lang_encoder=lang_encoder)
    valid_dataset = None
    if config.experiment.validate:
        valid_dataset = dataset_factory(
            config, obs_keys,
            filter_by_attribute=config.train.hdf5_validation_filter_key,
            lang_encoder=lang_encoder)
    return train_dataset, valid_dataset


def dataset_factory(config, obs_keys, filter_by_attribute=None, dataset_path=None,
                    lang_encoder=None):
    """A SequenceDataset per ``train.data`` entry; several entries become a
    weighted MetaDataset."""
    if config.train.data_format != "robomimic":
        raise NotImplementedError(f"train.data_format {config.train.data_format!r} "
                                  "is not ported yet (ROADMAP.md Queue 1)")
    ds_kwargs = dict(
        obs_keys=obs_keys,
        action_keys=config.train.action_keys,
        dataset_keys=config.train.dataset_keys,
        action_config=config.train.action_config,
        frame_stack=config.train.frame_stack,
        seq_length=config.train.seq_length,
        pad_frame_stack=config.train.pad_frame_stack,
        pad_seq_length=config.train.pad_seq_length,
        get_pad_mask=False,
        goal_mode=config.train.goal_mode,
        hdf5_cache_mode=config.train.hdf5_cache_mode,
        hdf5_use_swmr=config.train.hdf5_use_swmr,
        hdf5_normalize_obs=config.train.hdf5_normalize_obs,
        load_next_obs=config.train.hdf5_load_next_obs,
        shuffled_obs_key_groups=config.train.shuffled_obs_key_groups,
        lang_encoder=lang_encoder,
    )
    data_cfg = dataset_path if dataset_path is not None else config.train.data
    if isinstance(data_cfg, str):
        return SequenceDataset(hdf5_path=data_cfg,
                               filter_by_attribute=filter_by_attribute, **ds_kwargs)
    datasets, weights = [], []
    for entry in data_cfg:
        datasets.append(SequenceDataset(
            hdf5_path=entry["path"],
            filter_by_attribute=entry.get("filter_key", filter_by_attribute),
            **{**ds_kwargs, "dataset_lang": entry.get("lang", None)}))
        weights.append(entry.get("weight", 1.0))
    if len(datasets) == 1:
        return datasets[0]
    return MetaDataset(datasets, weights, normalize_weights_by_ds_size=False)


def make_batch_preparer(model, obs_normalization_stats=None):
    """The host-side work on a loader batch as one callable (for the
    prefetcher's thread): the algo's slicing, then the normalization."""

    def prepare(batch):
        input_batch = model.process_batch_for_training(batch)
        return model.postprocess_batch_for_training(
            input_batch, obs_normalization_stats=obs_normalization_stats)

    return prepare


def run_epoch(model, data_loader, epoch, validate=False, num_steps=None,
              obs_normalization_stats=None, data_loader_iter=None):
    """@num_steps gradient steps (default: one pass of @data_loader) with the
    timing buckets ``Data_Loading``, ``Process_Batch``, ``Train_Batch`` and
    ``Log_Info`` (minutes, summed), the step logs' means and ``Time_Epoch``.

    ``data_loader_iter`` may be a ``DevicePrefetcher``, the training path of
    ``scripts/train.py``: fetch, preparation and the host->device copy then
    run on its thread. ``Data_Loading`` is then the wait for a batch that is
    ready on the device, ``Process_Batch`` 0, and the ``prefetch/*`` keys
    hold the prefetcher's totals over the batches this epoch consumed.
    ``Train_Batch`` ends in ``torch.cuda.synchronize()`` on a card, so it
    holds the step's device time, not its launch.
    """
    epoch_timestamp = time.time()
    if validate:
        model.set_eval()
    else:
        model.set_train()
    if num_steps is None:
        num_steps = len(data_loader)
    on_card = model.device.type == "cuda"

    step_log_all = []
    timing_stats = dict(Data_Loading=[], Process_Batch=[], Train_Batch=[], Log_Info=[])
    prefetcher = data_loader_iter if isinstance(data_loader_iter, DevicePrefetcher) else None
    if prefetcher is not None:
        prefetcher.reset_stats()
        iterator = None
    else:
        iterator = data_loader_iter if data_loader_iter is not None else iter(data_loader)
    for _ in LogUtils.custom_tqdm(range(num_steps)):
        t = time.time()
        if prefetcher is not None:
            input_batch = prefetcher.get()
            timing_stats["Data_Loading"].append(time.time() - t)
            timing_stats["Process_Batch"].append(0.0)
        else:
            try:
                batch = next(iterator)
            except StopIteration:
                iterator = iter(data_loader)
                batch = next(iterator)
            timing_stats["Data_Loading"].append(time.time() - t)
            t = time.time()
            input_batch = model.process_batch_for_training(batch)
            input_batch = model.postprocess_batch_for_training(
                input_batch, obs_normalization_stats=obs_normalization_stats)
            timing_stats["Process_Batch"].append(time.time() - t)

        t = time.time()
        info = model.train_on_batch(input_batch, epoch, validate=validate)
        if on_card:
            torch.cuda.synchronize(model.device)
        timing_stats["Train_Batch"].append(time.time() - t)

        t = time.time()
        step_log_all.append(model.log_info(info))
        timing_stats["Log_Info"].append(time.time() - t)

    step_log_dict = {}
    for step_log in step_log_all:
        for k, v in step_log.items():
            step_log_dict.setdefault(k, []).append(v)
    out = {k: float(np.mean(v)) for k, v in step_log_dict.items()}
    for k, v in timing_stats.items():
        out[f"Time_{k}"] = float(np.sum(v) / 60.0)
    out["Time_Epoch"] = (time.time() - epoch_timestamp) / 60.0
    if prefetcher is not None:
        for k, v in prefetcher.transfer_summary().items():
            out[f"prefetch/{k}"] = v
    return out


def save_model(model, config, env_meta, shape_meta, ckpt_path,
               obs_normalization_stats=None, action_normalization_stats=None):
    """Write a self-describing ``.pth`` checkpoint (``utils/file_utils.py``
    says the layout): the reference's names, the image shapes CHW, and with
    ``experiment.save.include_optimizer`` what a resumed run needs."""
    include_opt = bool(config.experiment.save.get("include_optimizer", False))
    cfg_dict = config.to_dict()
    params = dict(
        model=model.serialize(include_optimizer=include_opt),
        algo_name=config.algo_name,
        config=config.dump(),
        env_metadata=deepcopy(env_meta),
        shape_metadata=FileUtils.shape_metadata_to_reference(deepcopy(shape_meta),
                                                             cfg_dict),
    )
    if obs_normalization_stats is not None:
        params["obs_normalization_stats"] = TensorUtils.to_numpy(obs_normalization_stats)
    if action_normalization_stats is not None:
        params["action_normalization_stats"] = TensorUtils.to_numpy(
            action_normalization_stats)
    FileUtils.save_checkpoint(params, ckpt_path)
    print(f"save checkpoint to {ckpt_path}")
