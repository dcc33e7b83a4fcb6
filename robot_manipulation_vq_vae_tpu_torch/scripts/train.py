"""Training entry point of the port (the counterpart of the JAX package's
``scripts/train.py``):

    python -m robot_manipulation_vq_vae_tpu_torch.scripts.train --config cfg.json
        [--algo NAME] [--name RUN] [--dataset PATH] [--output_dir DIR]
        [--debug] [--eval_only] [--auto_resume] [--device cpu]

Flow: config -> observation registries -> the dataset's env and shape
metadata -> logger -> algo (on the card) -> datasets and loaders -> eval envs
(with ``experiment.rollout.enabled``) -> one ``DevicePrefetcher`` for the
run -> epoch loop {run_epoch -> validation epoch -> rollouts -> action MSE
-> checkpoint}. ``--auto_resume`` starts from the newest checkpoint of the
experiment, past its epoch (with ``experiment.save.include_optimizer`` the
optimizers, schedules and generators resume too).

Rollouts run every ``experiment.rollout.rate`` epochs in each dataset's env
and each of ``experiment.additional_envs``; with
``experiment.rollout.batched`` a dataset's env is a pool of
``num_batch_envs`` spawned workers with shared-memory observations, stepped
in lockstep. An ICL policy takes a context of one window drawn from the
training set. The best return and success rate per env can save a
checkpoint (``experiment.save.on_best_rollout_*``).
``experiment.mse.enabled`` logs the action-prediction MSE.
"""

import argparse
import glob
import json
import os
import re
import sys
import time
from collections import OrderedDict

import numpy as np

import robot_manipulation_vq_vae_tpu_torch.algo as Algo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.data.loader import DataLoader, InfiniteLoader
from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv
from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as LangUtils
from robot_manipulation_vq_vae_tpu_torch.utils import log_utils as LogUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils

def _check_ported(config):
    """Raise for an option that the port cannot honour, rather than train
    without it."""
    if config.experiment.save.get("format", "pickle") == "orbax":
        raise NotImplementedError("experiment.save.format 'orbax' is the JAX "
                                  "package's TPU format; the port writes .pth")


def newest_checkpoint(config):
    """(path, epoch) of the newest ``model_epoch_<N>*.pth`` of this
    experiment under ``train.output_dir``, or (None, 0)."""
    pattern = os.path.join(os.path.abspath(os.path.expanduser(config.train.output_dir)),
                           config.experiment.name, "*", "models", "model_epoch_*.pth")
    best = (None, 0)
    for path in glob.glob(pattern):
        m = re.match(r"model_epoch_(\d+)", os.path.basename(path))
        if m and int(m.group(1)) >= best[1]:
            best = (path, int(m.group(1)))
    return best


def make_eval_envs(config, dataset_cfg, env_meta_list, shape_meta):
    """{env name: env or SubprocVectorEnv} for the rollouts: each dataset's
    env (unless its entry says ``do_eval: false``), then the additional envs
    by name with the first dataset's metadata. An env whose simulator is not
    installed disables the rollouts with a warning, as in the JAX package."""
    envs = OrderedDict()
    rollout = config.experiment.rollout
    kwargs = dict(render=False, render_offscreen=config.experiment.render_video,
                  use_image_obs=shape_meta["use_images"])
    try:
        for entry, env_meta in zip(dataset_cfg, env_meta_list):
            if not entry.get("do_eval", True):
                continue
            factory = EnvUtils.EnvFactory.from_config(env_meta, config, **kwargs)
            if rollout.get("batched", False):
                envs[env_meta["env_name"]] = SubprocVectorEnv(
                    [factory] * int(rollout.get("num_batch_envs", 5)), shared_obs=True)
            else:
                env = factory()
                envs[env.name] = env
        for extra_name in (config.experiment.additional_envs or []):
            env = EnvUtils.EnvFactory.from_config(
                {**env_meta_list[0], "env_name": extra_name}, config, **kwargs)()
            envs[env.name] = env
    except ImportError as e:
        LogUtils.log_warning(f"rollouts disabled: sim stack unavailable ({e})")
        close_envs(envs)
        envs = OrderedDict()
    return envs


def close_envs(envs):
    for env in envs.values():
        if isinstance(env, SubprocVectorEnv):
            env.close()


def train(config, eval_only=False, auto_resume=False, device=None):
    """The training run; returns the per-epoch numeric summaries (the step
    logs' means and timings, and the epoch's ``Rollout/<key>/<env>`` and
    action-MSE results). @device is ``cuda`` unless given."""
    _check_ported(config)
    np.random.seed(config.train.seed)

    print("\n============= New Training Run with Config =============")
    print(config)
    log_dir, ckpt_dir, video_dir, _ = TrainUtils.get_exp_dir(config)
    if config.experiment.logging.terminal_output_to_txt:
        logger = LogUtils.PrintLogger(os.path.join(log_dir, "log.txt"))
        sys.stdout = logger
        sys.stderr = logger

    ObsUtils.initialize_obs_utils_with_config(config)

    dataset_cfg = config.train.data
    if isinstance(dataset_cfg, str):
        dataset_cfg = [{"path": dataset_cfg}]
    env_meta_list, shape_meta_list = [], []
    for entry in dataset_cfg:
        env_meta = FileUtils.get_env_metadata_from_dataset(
            dataset_path=entry["path"], ds_format=config.train.data_format)
        meta_update = config.experiment.env_meta_update_dict
        if meta_update:
            env_meta.setdefault("env_kwargs", {}).update(
                dict(meta_update.get("env_kwargs", {})))
        if config.experiment.env is not None:
            env_meta["env_name"] = config.experiment.env
        env_meta_list.append(env_meta)
        shape_meta_list.append(FileUtils.get_shape_metadata_from_dataset(
            dataset_path=entry["path"], action_keys=config.train.action_keys,
            all_obs_keys=config.all_obs_keys, ds_format=config.train.data_format,
            verbose=True))
    shape_meta = shape_meta_list[0]

    data_logger = LogUtils.DataLogger(log_dir, config=config,
                                      log_tb=config.experiment.logging.log_tb,
                                      log_wandb=config.experiment.logging.log_wandb)
    model = Algo.algo_factory(config.algo_name, config,
                              obs_key_shapes=shape_meta["all_shapes"],
                              ac_dim=shape_meta["ac_dim"], device=device)

    ckpt_path = config.experiment.ckpt_path
    start_epoch = 1
    if auto_resume and ckpt_path is None:
        found, epoch = newest_checkpoint(config)
        if found is not None:
            ckpt_path, start_epoch = found, epoch + 1
            print(f"auto-resume: found {ckpt_path} (epoch {epoch})")
    if ckpt_path is not None:
        model.deserialize(FileUtils.maybe_dict_from_checkpoint(ckpt_path=ckpt_path)["model"])
        print(f"warm-started from {ckpt_path}")

    print("\n============= Model Summary =============")
    print(model.nets)

    # the datasets' language encoder adds the language embedding to the
    # observations; the files hold none
    obs_keys = [k for k in shape_meta["all_obs_keys"] if k != ObsUtils.LANG_EMB_KEY]
    lang_encoder = LangUtils.LangEncoder()
    trainset, validset = TrainUtils.load_data_for_training(
        config, obs_keys=obs_keys, lang_encoder=lang_encoder)
    print(f"\n============= Training Dataset =============\n{trainset}")

    obs_normalization_stats = None
    if config.train.hdf5_normalize_obs:
        obs_normalization_stats = trainset.normalize_obs()
    action_normalization_stats = trainset.get_action_normalization_stats()

    sampler_weights = trainset.get_dataset_sampler()
    train_loader = DataLoader(
        trainset, batch_size=config.train.batch_size, shuffle=True,
        sampler_weights=sampler_weights,
        num_workers=min(int(config.train.num_data_workers) or 1, 16),
        drop_last=True, seed=config.train.seed,
        # the prefetcher copies each batch out before it draws the next
        reuse_buffers=True,
    )
    # an ICL policy's rollout context: one window of the training set
    context_loader = InfiniteLoader(DataLoader(
        trainset, batch_size=1, shuffle=True, sampler_weights=sampler_weights,
        num_workers=1, seed=config.train.seed + 1))
    valid_loader = None
    if validset is not None:
        valid_loader = DataLoader(validset, batch_size=config.train.batch_size,
                                  shuffle=True, num_workers=1, seed=config.train.seed)

    epoch_history = []
    last_ckpt_time = time.time()
    train_num_steps = config.experiment.epoch_every_n_steps
    valid_num_steps = config.experiment.validation_epoch_every_n_steps
    envs = OrderedDict()
    if config.experiment.rollout.get("enabled", False) and not eval_only:
        envs = make_eval_envs(config, dataset_cfg, env_meta_list, shape_meta)
    best_return = {k: -np.inf for k in envs}
    best_success_rate = {k: -1.0 for k in envs}
    train_iter = None
    try:
        # one prefetch pipeline for the whole run: batches flow in loader
        # order and none is dropped, so the samples are the synchronous path's
        if not eval_only:
            train_iter = DevicePrefetcher(
                train_loader, prepare=TrainUtils.make_batch_preparer(
                    model, obs_normalization_stats),
                depth=2, device=model.device)
        for epoch in range(start_epoch, config.train.num_epochs + 1):
            step_log = {}
            if not eval_only:
                step_log = TrainUtils.run_epoch(
                    model=model, data_loader=train_loader, epoch=epoch,
                    num_steps=train_num_steps,
                    obs_normalization_stats=obs_normalization_stats,
                    data_loader_iter=train_iter)
                model.on_epoch_end(epoch)

            save = config.experiment.save
            eval_log = {}   # the epoch's rollout and MSE results
            epoch_ckpt_name = f"model_epoch_{epoch}"
            should_save_ckpt = False
            if save.enabled:
                time_check = (save.every_n_seconds is not None
                              and time.time() - last_ckpt_time > save.every_n_seconds)
                epoch_check = (save.every_n_epochs is not None
                               and epoch % save.every_n_epochs == 0)
                should_save_ckpt = time_check or epoch_check or epoch in save.epochs
                if should_save_ckpt:
                    last_ckpt_time = time.time()

            for k, v in step_log.items():
                if isinstance(v, bool):
                    continue
                if k.startswith("Time_"):
                    data_logger.record(f"Timing_Stats/Train_{k[5:]}", v, epoch)
                else:
                    data_logger.record(f"Train/{k}", v, epoch)

            if config.experiment.validate and valid_loader is not None:
                valid_step_log = TrainUtils.run_epoch(
                    model=model, data_loader=valid_loader, epoch=epoch, validate=True,
                    num_steps=valid_num_steps,
                    obs_normalization_stats=obs_normalization_stats)
                for k, v in valid_step_log.items():
                    if k.startswith("Time_"):
                        data_logger.record(f"Timing_Stats/Valid_{k[5:]}", v, epoch)
                    else:
                        data_logger.record(f"Valid/{k}", v, epoch)

            rollout = config.experiment.rollout
            if (rollout.enabled and envs and epoch > rollout.warmstart
                    and (epoch % rollout.rate == 0 or eval_only)):
                all_rollout_logs = run_rollouts(
                    config, model, envs, context_loader, epoch, video_dir,
                    obs_normalization_stats, action_normalization_stats,
                    lang_encoder, data_logger)
                eval_log.update({f"Rollout/{k}/{env_name}": v
                                 for env_name, logs in all_rollout_logs.items()
                                 for k, v in logs.items()})
                updated = TrainUtils.should_save_from_rollout_logs(
                    all_rollout_logs=all_rollout_logs, best_return=best_return,
                    best_success_rate=best_success_rate,
                    epoch_ckpt_name=epoch_ckpt_name,
                    save_on_best_rollout_return=save.on_best_rollout_return,
                    save_on_best_rollout_success_rate=save.on_best_rollout_success_rate)
                best_return = updated["best_return"]
                best_success_rate = updated["best_success_rate"]
                epoch_ckpt_name = updated["epoch_ckpt_name"]
                should_save_ckpt = should_save_ckpt or updated["should_save_ckpt"]

            mse = config.experiment.mse
            if mse.get("enabled", False) and (
                    epoch % mse.get("every_n_epochs", 50) == 0
                    or (should_save_ckpt and mse.get("on_save_ckpt", False))):
                savedir = (os.path.join(video_dir, f"mse_epoch_{epoch}")
                           if mse.get("visualize", False) else None)
                mse_log, _ = model.compute_mse_visualize(
                    trainset, validset, num_samples=mse.get("num_samples", 20),
                    savedir=savedir)
                for k, v in mse_log.items():
                    data_logger.record(k, v, epoch)
                eval_log.update(mse_log)

            if should_save_ckpt and not eval_only:
                TrainUtils.save_model(
                    model=model, config=config, env_meta=env_meta_list[0],
                    shape_meta=shape_meta,
                    ckpt_path=os.path.join(ckpt_dir, f"{epoch_ckpt_name}.pth"),
                    obs_normalization_stats=obs_normalization_stats,
                    action_normalization_stats=action_normalization_stats)

            if "Loss" in step_log:
                print(f"Epoch {epoch}: Loss {step_log['Loss']:.6f}")
            epoch_history.append({
                "epoch": epoch, "num_steps": train_num_steps,
                **{k: float(v) for k, v in step_log.items()
                   if isinstance(v, (int, float, np.floating, np.integer))},
                **eval_log,
            })
            if eval_only:
                break
    finally:
        if train_iter is not None:
            train_iter.close()
        close_envs(envs)
        data_logger.close()
    return epoch_history


def run_rollouts(config, model, envs, context_loader, epoch, video_dir,
                 obs_normalization_stats, action_normalization_stats, lang_encoder,
                 data_logger):
    """The epoch's rollouts in every env, logged as ``Rollout/<key>/<env>``
    (and ``Timing_Stats/Rollout_<env>_<key>``); returns the logs per env."""
    policy = Algo.rollout_policy_class(model)(
        model, obs_normalization_stats=obs_normalization_stats,
        action_normalization_stats=action_normalization_stats, lang_encoder=lang_encoder)
    context_batch = None
    if model.TAKES_CONTEXT:
        context_batch = model.process_batch_for_training(next(context_loader))
    rollout = config.experiment.rollout
    all_rollout_logs, _ = TrainUtils.rollout_with_stats(
        policy=policy, envs=envs, horizon=rollout.horizon,
        context_batch=context_batch, use_goals=config.use_goals,
        num_episodes=rollout.n, render=config.experiment.render,
        video_dir=video_dir if config.experiment.render_video else None,
        epoch=epoch, video_skip=config.experiment.video_skip,
        terminate_on_success=rollout.terminate_on_success)
    for env_name, rollout_logs in all_rollout_logs.items():
        for k, v in rollout_logs.items():
            if k.startswith("Time_"):
                data_logger.record(f"Timing_Stats/Rollout_{env_name}_{k[5:]}", v, epoch)
            else:
                data_logger.record(f"Rollout/{k}/{env_name}", v, epoch, log_stats=True)
        print(f"Env: {env_name}")
        print(json.dumps(rollout_logs, sort_keys=True, indent=4))
    return all_rollout_logs


def main(args):
    if args.config is not None:
        with open(args.config) as f:
            ext_cfg = json.load(f)
        config = config_factory(ext_cfg["algo_name"])
        with config.values_unlocked():
            config.update(ext_cfg)
    else:
        config = config_factory(args.algo)
    with config.values_unlocked():
        if args.dataset is not None:
            config.train.data = args.dataset
        if args.name is not None:
            config.experiment.name = args.name
        if args.output_dir is not None:
            config.train.output_dir = args.output_dir
        if args.debug:
            config.experiment.epoch_every_n_steps = 3
            config.experiment.validation_epoch_every_n_steps = 3
            config.train.num_epochs = 2
            config.experiment.rollout.rate = 1
            config.experiment.rollout.n = 2
            config.experiment.rollout.horizon = 10
            config.experiment.save.every_n_epochs = 1
    config.lock()
    return train(config, eval_only=args.eval_only, auto_resume=args.auto_resume,
                 device=args.device)


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--algo", type=str, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest checkpoint of this experiment")
    p.add_argument("--device", type=str, default=None,
                   help="the device to train on (default: cuda)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
