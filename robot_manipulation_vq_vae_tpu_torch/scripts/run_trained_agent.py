"""Roll out a trained checkpoint of the port in its environment (the
counterpart of the JAX package's ``scripts/run_trained_agent.py``; reference
``robomimic/scripts/run_trained_agent.py``):

    python -m robot_manipulation_vq_vae_tpu_torch.scripts.run_trained_agent \\
        --agent model_epoch_10.pth [--env NAME] [--n_rollouts 27] [--horizon 400]
        [--video_path out.mp4] [--dataset demos.hdf5] [--seed 0] [--device cpu]

The policy and its env come from the checkpoint; the env is wrapped as the
training config says (frame stacking), and the policy runs on the card
unless ``--device`` says otherwise. An ICL policy takes as its context one
window drawn (with ``--seed``) from ``--dataset``, by default the training
data the checkpoint's config names. (The JAX package's script passes no
context, so an ICL policy's every episode fails there.) Prints the mean
results as JSON, and fails when no episode of the env finished.
"""

import argparse
import json

from robot_manipulation_vq_vae_tpu_torch.data.loader import DataLoader
from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as LangUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils


def context_from_dataset(algo, config, dataset_path=None, seed=0):
    """One window of the training data (@dataset_path, else the config's),
    as the algo's training batch: an ICL policy's context."""
    obs_keys = [k for k in algo.obs_shapes if k != ObsUtils.LANG_EMB_KEY]
    dataset = TrainUtils.dataset_factory(
        config, obs_keys, filter_by_attribute=config.train.hdf5_filter_key,
        dataset_path=dataset_path, lang_encoder=LangUtils.LangEncoder())
    loader = DataLoader(dataset, batch_size=1, shuffle=True, num_workers=0, seed=seed)
    return algo.process_batch_for_training(next(iter(loader)))


def main(args):
    policy, ckpt_dict = FileUtils.policy_from_checkpoint(device=args.device,
                                                         ckpt_path=args.agent)
    env, _ = FileUtils.env_from_checkpoint(
        ckpt_dict=ckpt_dict, env_name=args.env, render=args.render,
        render_offscreen=args.video_path is not None)
    config, _ = FileUtils.config_from_checkpoint(ckpt_dict=ckpt_dict)
    env = EnvUtils.wrap_env_from_config(env, config=config)
    context_batch = None
    if policy.policy.TAKES_CONTEXT:
        context_batch = context_from_dataset(policy.policy, config, args.dataset, args.seed)
    logs, _ = TrainUtils.rollout_with_stats(
        policy=policy, envs={env.name: env}, horizon=args.horizon,
        context_batch=context_batch, num_episodes=args.n_rollouts, render=args.render,
        video_path=args.video_path, video_skip=args.video_skip,
        terminate_on_success=True, verbose=True)
    print(json.dumps(logs, indent=4, default=float))
    if "Return" not in logs[env.name]:
        raise RuntimeError(f"no episode of {env.name} finished")
    return logs


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--agent", type=str, required=True, help="a .pth checkpoint")
    p.add_argument("--env", type=str, default=None)
    p.add_argument("--n_rollouts", type=int, default=27)
    p.add_argument("--horizon", type=int, default=400)
    p.add_argument("--render", action="store_true")
    p.add_argument("--video_path", type=str, default=None)
    p.add_argument("--video_skip", type=int, default=5)
    p.add_argument("--dataset", type=str, default=None,
                   help="HDF5 demos to draw an ICL policy's context from "
                        "(default: the checkpoint's training data)")
    p.add_argument("--seed", type=int, default=0,
                   help="the seed of the context window's draw")
    p.add_argument("--device", type=str, default=None,
                   help="the device the policy runs on (default: cuda)")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
