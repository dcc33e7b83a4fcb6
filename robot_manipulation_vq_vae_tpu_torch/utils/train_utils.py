"""Training harness utilities (the port's counterpart of the JAX package's
``utils/train_utils.py``): experiment directories, the dataset factory, the
epoch loop with its timing buckets, rollouts (one env, or a vector env in
lockstep) with their statistics and the best-checkpoint rule, and
checkpoint saving.
"""

import datetime
import os
import time
from collections import OrderedDict
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


def batchify_obs(obs_list):
    """A list of observation dicts -> one batched dict."""
    return {k: np.stack([obs[k] for obs in obs_list]) for k in obs_list[0]}


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


def is_every_n_steps(interval, current_step, skip_zero=False):
    if interval is None:
        return False
    if not (isinstance(interval, int) and interval > 0):
        raise ValueError(f"interval must be a positive int, not {interval!r}")
    if not (isinstance(current_step, int) and current_step >= 0):
        raise ValueError(f"current_step must be an int >= 0, not {current_step!r}")
    if skip_zero and current_step == 0:
        return False
    return current_step % interval == 0


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def run_batched_rollout(policy, venv, horizon, context_batch=None,
                        terminate_on_success=False):
    """One episode in each env of @venv, stepped in lockstep: one batched
    policy query per step serves every env. With the pool's batched API
    (``step_batched``) the observations come as one dict, with a
    shared-memory pool the shared block itself. Returns one result dict per
    env: Return, Horizon, Success_Rate, Exception_Rate, time."""
    langs = venv.get_env_attr("env_lang")
    policy.start_episode(lang=langs[0] if langs else None)
    use_batched_api = hasattr(venv, "step_batched")
    if use_batched_api:
        ob_batch = venv.reset_batched()
    else:
        ob_list = venv.reset()
    n = len(venv)

    returns = np.zeros(n)
    success = np.zeros(n, bool)
    horizons = np.full(n, horizon)
    active = np.ones(n, bool)
    t0 = time.time()
    for step_i in range(horizon):
        if not use_batched_api:
            ob_batch = batchify_obs(ob_list)
        if context_batch is not None:
            acs = policy(ob=ob_batch, context_batch=context_batch, batched=True)
        else:
            acs = policy(ob=ob_batch, batched=True)
        if use_batched_api:
            ob_batch, rews, dones, _ = venv.step_batched(np.asarray(acs))
        else:
            ob_list, rews, dones, _ = venv.step(np.asarray(acs))
        returns += np.asarray(rews) * active
        succ_now = np.asarray([s["task"] for s in venv.is_success()])
        success |= active & succ_now
        finished = np.asarray(dones, bool) | (succ_now if terminate_on_success else False)
        horizons[active & finished] = step_i + 1
        active &= ~finished
        if not active.any():
            break
    dt = (time.time() - t0) / n
    return [dict(Return=float(returns[i]), Horizon=int(horizons[i]),
                 Success_Rate=float(success[i]), Exception_Rate=0.0, time=dt)
            for i in range(n)]


def run_rollout(policy, env, horizon, context_batch=None, use_goals=False,
                render=False, video_writer=None, video_skip=5,
                terminate_on_success=False):
    """One episode of @env (with @context_batch, an ICL policy's). An
    exception the env names in ``rollout_exceptions`` ends the episode and
    counts in Exception_Rate."""
    policy.start_episode(lang=getattr(env, "env_lang", None))
    ob_dict = env.reset()
    goal_dict = env.get_goal() if use_goals else None

    results = {}
    video_count = 0
    total_reward = 0.0
    success = {"task": False}
    got_exception = False
    rollout_timestamp = time.time()
    try:
        for step_i in range(horizon):
            if context_batch is not None:
                ac = policy(ob=ob_dict, context_batch=context_batch, goal=goal_dict)
            else:
                ac = policy(ob=ob_dict, goal=goal_dict)
            ob_dict, r, done, _ = env.step(ac)
            total_reward += r
            cur_success_metrics = env.is_success()
            for k in success:
                success[k] = success[k] or cur_success_metrics[k]
            if render:
                env.render(mode="human")
            if video_writer is not None:
                if video_count % video_skip == 0:
                    video_writer.append_data(env.render(mode="rgb_array", height=512,
                                                        width=512))
                video_count += 1
            if done or (terminate_on_success and success["task"]):
                break
    except tuple(getattr(env, "rollout_exceptions", ()) or ()) as e:
        got_exception = True
        print(f"WARNING: rollout exception {e}")

    results["Return"] = total_reward
    results["Horizon"] = step_i + 1
    results["Success_Rate"] = float(success["task"])
    results["Exception_Rate"] = float(got_exception)
    results["time"] = time.time() - rollout_timestamp
    for k in success:
        if k != "task":
            results[f"{k}_Success_Rate"] = float(success[k])
    return results


def rollout_with_stats(policy, envs, horizon, context_batch=None, use_goals=False,
                       num_episodes=None, render=False, video_dir=None,
                       video_path=None, epoch=None, video_skip=5,
                       terminate_on_success=False, verbose=False):
    """@num_episodes episodes in each env of @envs ({name: env or vector
    env}; a vector env runs them in passes of len(env) in lockstep), and the
    mean of each result per env, with ``Time_Episode`` (minutes). Videos go
    to @video_dir or @video_path where imageio can write them.

    As in the JAX package, an exception in an episode is printed and ends
    that env's episodes; an env none of whose episodes finished gets only
    ``{"Success_Rate": 0.0}``, with no ``Return``. Returns (logs, None)."""
    try:
        import imageio
    except ImportError:
        imageio = None
    from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv

    all_rollout_logs = OrderedDict()
    write_video = (video_dir is not None) or (video_path is not None)
    for env_name, env in envs.items():
        video_writer = None
        if write_video and imageio is not None:
            if video_dir is not None:
                video_str = f"_epoch_{epoch}.mp4" if epoch is not None else ".mp4"
                this_video_path = os.path.join(video_dir, f"{env_name}{video_str}")
            else:
                this_video_path = video_path
            try:
                video_writer = imageio.get_writer(this_video_path, fps=20)
            except Exception as e:  # no ffmpeg plugin, for one
                LogUtils.log_warning(f"video writing disabled: {e}")
                video_writer = None

        rollout_logs = []
        num_success = 0
        if isinstance(env, SubprocVectorEnv):
            n_passes = (num_episodes + len(env) - 1) // len(env)
            for pass_i in LogUtils.custom_tqdm(range(n_passes)):
                try:
                    infos = run_batched_rollout(
                        policy=policy, venv=env, horizon=horizon,
                        context_batch=context_batch,
                        terminate_on_success=terminate_on_success)
                except Exception as e:
                    print(f"Batched rollout exception at pass {pass_i}: {e}")
                    break
                rollout_logs.extend(infos)
                num_success += sum(i["Success_Rate"] for i in infos)
            rollout_logs = rollout_logs[:num_episodes]
        else:
            for ep_i in LogUtils.custom_tqdm(range(num_episodes)):
                try:
                    rollout_info = run_rollout(
                        policy=policy, env=env, horizon=horizon,
                        context_batch=context_batch, use_goals=use_goals,
                        render=render, video_writer=video_writer,
                        video_skip=video_skip,
                        terminate_on_success=terminate_on_success)
                except Exception as e:
                    print(f"Rollout exception at episode {ep_i}: {e}")
                    break
                rollout_logs.append(rollout_info)
                num_success += rollout_info["Success_Rate"]
                if verbose:
                    print(f"Episode {ep_i + 1}, horizon={horizon}, "
                          f"num_success={num_success}")
        if video_writer is not None:
            video_writer.close()

        if rollout_logs:
            rollout_logs_mean = {k: float(np.mean([rl[k] for rl in rollout_logs]))
                                 for k in rollout_logs[0]}
            rollout_logs_mean["Time_Episode"] = (
                np.sum([rl["time"] for rl in rollout_logs]) / 60.0)
            all_rollout_logs[env_name] = rollout_logs_mean
        else:
            all_rollout_logs[env_name] = {"Success_Rate": 0.0}
    return all_rollout_logs, None


def should_save_from_rollout_logs(all_rollout_logs, best_return, best_success_rate,
                                  epoch_ckpt_name, save_on_best_rollout_return,
                                  save_on_best_rollout_success_rate):
    """Track the best return and success rate per env, and whether (and
    under which name) the epoch's checkpoint is saved for beating one."""
    should_save = False
    for env_name, rollout_logs in all_rollout_logs.items():
        if "Return" not in rollout_logs:
            # every episode of this env failed (rollout_with_stats' fallback)
            continue
        if rollout_logs["Return"] > best_return[env_name]:
            best_return[env_name] = rollout_logs["Return"]
            if save_on_best_rollout_return:
                epoch_ckpt_name += f"_{env_name}_return_{rollout_logs['Return']}"
                should_save = True
        if rollout_logs["Success_Rate"] > best_success_rate[env_name]:
            best_success_rate[env_name] = rollout_logs["Success_Rate"]
            if save_on_best_rollout_success_rate:
                epoch_ckpt_name += f"_{env_name}_success_{rollout_logs['Success_Rate']}"
                should_save = True
    return dict(best_return=best_return, best_success_rate=best_success_rate,
                epoch_ckpt_name=epoch_ckpt_name, should_save_ckpt=should_save)


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
