"""MCR representation pretraining from the command line (counterpart of the
JAX package's ``scripts/train_mcr_representation.py``; the defaults are the
reference's ``config_rep.yaml``).

Trains the trunk with the TCN / BC / state-alignment losses, snapshots
every ``--eval_freq`` steps after an evaluation step, and with
``--export_trunk`` writes the trunk that the ``mcr`` policies warm-start
from through ``RMVQ_MCR_CKPT`` (``algo/mcr.py``). Sources:
``--dataset synthetic`` (dry runs), an ``.npz`` in the MCR batch layout
(``images`` [N, 5, H, W, 3] uint8, ``actions`` [N, 5, A], optionally
``state_s0`` / ``state_s2`` [N, D]), or a robot-demo ``.hdf5`` sampled by
``data/mcr_adapter.py`` (``--views cam0_image,cam1_image``, optionally
``--state_keys proprio``). Runs on ``cuda`` unless ``--device`` says
otherwise. The trunk's stem pools with the recorded-argmax pool, through
the CUDA stem-pool kernels on the card (``ops/stem_pool.py``).

Example::

    python -m robot_manipulation_vq_vae_tpu_torch.scripts.train_mcr_representation \\
        --dataset synthetic --train_steps 20 --eval_freq 10 \\
        --size 18 --image_size 64 --work_dir /tmp/mcr_run
"""

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic', an .npz in the MCR layout, or an .hdf5 of demos")
    p.add_argument("--work_dir", default="./mcr_pretrain_run")
    p.add_argument("--load_snap", default="", help="snapshot to resume from")
    p.add_argument("--export_trunk", default="",
                   help="write the trunk pickle for RMVQ_MCR_CKPT here after training")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    # the reference's config_rep.yaml defaults
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--train_steps", type=int, default=2_000_000)
    p.add_argument("--eval_freq", type=int, default=20_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--hidden_dim", type=int, default=1024)
    p.add_argument("--size", type=int, default=34, choices=(18, 34, 50))
    p.add_argument("--tcnweight", type=float, default=1.0)
    p.add_argument("--l2dist", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--align_state_weight", type=float, default=0.0)
    p.add_argument("--state_window", type=int, default=3)
    p.add_argument("--use_action", action="store_true")
    p.add_argument("--bc_weight", type=float, default=0.0)
    # synthetic data
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--action_dim", type=int, default=7)
    # the HDF5 adapter (MCRHdf5Buffer)
    p.add_argument("--views", default="",
                   help="comma-separated camera-view obs keys (hdf5 only)")
    p.add_argument("--state_keys", default="",
                   help="comma-separated low-dim obs keys of the s0/s2 state windows "
                        "(hdf5 only)")
    p.add_argument("--alpha", type=float, default=0.2,
                   help="start/end temporal sampling margin (hdf5 only)")
    p.add_argument("--cache_mode", default="all", choices=("all", "low_dim", "none"),
                   help="SequenceDataset hdf5 cache mode (hdf5 only)")
    return p


def _hdf5_buffers(path, args, seeds):
    """One MCR batch iterator per seed over one shared SequenceDataset of
    @path (train and validation differ by the sampling seed alone)."""
    from robot_manipulation_vq_vae_tpu_torch.data.dataset import SequenceDataset
    from robot_manipulation_vq_vae_tpu_torch.data.mcr_adapter import MCRHdf5Buffer

    views = [v for v in args.views.split(",") if v]
    if not views:
        raise SystemExit("--views is required with an hdf5 dataset "
                         "(comma-separated camera-view obs keys)")
    state_keys = [s for s in args.state_keys.split(",") if s]
    ds = SequenceDataset(
        hdf5_path=path, obs_keys=views + state_keys, action_keys=["actions"],
        dataset_keys=("actions",), action_config={}, seq_length=1, frame_stack=1,
        load_next_obs=False,
        hdf5_cache_mode=None if args.cache_mode == "none" else args.cache_mode)
    return [iter(MCRHdf5Buffer(ds, views, batch_size=args.batch_size, alpha=args.alpha,
                               state_keys=state_keys, state_window=args.state_window,
                               use_action=args.use_action, seed=seed))
            for seed in seeds]


def _npz_batches(path, batch_size, seed):
    """Minibatches drawn with replacement from an .npz in the MCR layout."""
    data = np.load(path)
    images, actions = data["images"], data["actions"]
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(0, images.shape[0], size=batch_size)
        batch = {"images": images[idx], "actions": actions[idx]}
        for k in ("state_s0", "state_s2"):
            if k in data:
                batch[k] = data[k][idx]
        yield batch


def run(args):
    """Train (or resume) and return the trainer."""
    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import (
        MCRPretrainer,
        MCRRepresentation,
        synthetic_batches,
    )
    from robot_manipulation_vq_vae_tpu_torch.models.base_nets import set_stem_pool

    os.makedirs(args.work_dir, exist_ok=True)
    if args.dataset == "synthetic":
        state_dim = 14 * args.state_window + (
            7 * (args.state_window - 1) if args.use_action else 0)
        train_iter, val_iter = (
            synthetic_batches(args.batch_size, args.image_size, args.action_dim,
                              state_dim=state_dim, seed=seed)
            for seed in (args.seed, args.seed + 1))
    elif args.dataset.endswith((".hdf5", ".h5")):
        train_iter, val_iter = _hdf5_buffers(args.dataset, args, (args.seed, args.seed + 1))
    else:
        train_iter = _npz_batches(args.dataset, args.batch_size, args.seed)
        val_iter = _npz_batches(args.dataset, args.batch_size, args.seed + 1)

    example = next(train_iter)
    state = example.get("state_s0")
    # the weights are drawn on the CPU from the seed, whatever the device
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = MCRRepresentation(
            size=args.size, hidden_dim=args.hidden_dim, l2dist=args.l2dist,
            tcn_weight=args.tcnweight, align_state_weight=args.align_state_weight,
            bc_weight=args.bc_weight, state_window=args.state_window,
            use_action=args.use_action, action_dim=example["actions"].shape[-1],
            resize_to_224=example["images"].shape[2] >= 128,
            state_dim=None if state is None else state.shape[-1])
    set_stem_pool(model, True)
    trainer = MCRPretrainer(model, lr=args.lr, seed=args.seed, device=args.device)
    if args.load_snap:
        print(f"LOADING {args.load_snap}")
        trainer.load_snapshot(args.load_snap)

    with open(os.path.join(args.work_dir, "metrics.jsonl"), "a") as log_f:
        while trainer.step < args.train_steps:
            t0 = time.time()
            batch = next(train_iter)
            t1 = time.time()
            metrics = trainer.update(batch)
            t2 = time.time()
            if trainer.step % 10 == 0 or trainer.step == 1:
                print(trainer.step, metrics)
                print(f"Sample time {t1 - t0:.3f}, Update time {t2 - t1:.3f}")
            log_f.write(json.dumps({"step": trainer.step, "split": "train", **metrics})
                        + "\n")
            if trainer.step % args.eval_freq == 0:
                eval_metrics = trainer.update(next(val_iter), eval=True)
                print("EVAL", trainer.step, eval_metrics)
                log_f.write(json.dumps({"step": trainer.step, "split": "eval",
                                        **eval_metrics}) + "\n")
                for name in (f"snapshot_{trainer.step}.pkl", "snapshot.pkl"):
                    trainer.save_snapshot(os.path.join(args.work_dir, name))

    trainer.save_snapshot(os.path.join(args.work_dir, "snapshot.pkl"))
    if args.export_trunk:
        trainer.export_trunk(args.export_trunk)
        print(f"exported trunk -> {args.export_trunk}")
    return trainer


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
