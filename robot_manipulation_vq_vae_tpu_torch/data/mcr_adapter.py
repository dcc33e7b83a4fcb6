"""The MCR pretraining batches from the framework's own robot-demo HDF5
(counterpart of the JAX package's ``data/mcr_adapter.py``): ``MCRHdf5Buffer``
samples ``MCRPretrainer``'s batch layout from a ``SequenceDataset`` with the
temporal-distance scheme of the reference's droid loader:

* one random demo and one random camera view per sample;
* the frame quintuple [start, end, s0, s1, s2]::

      start ~ U[1, 2 + int(alpha T))      end ~ U[int((1 - alpha) T) - 1, T)
      s1 ~ U[2, T);   s0 ~ U[1, s1);   s2 ~ U[s1, T)

  (start and end clamped to T - 1);
* the actions at the five indices;
* state windows of ``state_window`` frames from ``max(1, ind -
  state_window // 2)``, clamped to T - 1, around s0 and s2: the state keys
  of each frame concatenated, with its action after every frame but the
  last when ``use_action``.

It is numpy on the host, draws from a seeded ``RandomState``, and gives the
JAX adapter's batches on the same file and seed.
"""

import numpy as np


class MCRHdf5Buffer:
    """Infinite MCR-format batch sampler over a ``SequenceDataset``.

    Args:
        dataset: a ``SequenceDataset`` whose ``obs_keys`` include the
            camera views in ``view_keys`` (uint8 [T, H, W, 3]) and the
            low-dim keys in ``state_keys``.
        view_keys: camera-view obs keys; each sample draws ONE view.
        batch_size: samples per yielded batch.
        alpha: start/end sampling margin (reference default 0.2).
        state_keys: low-dim obs keys concatenated into the state windows
            (reference ``state_keys`` cartesian/gripper/joint,
            data_loaders.py:141). Empty -> zero-width state vectors.
        state_window: frames per state window (reference default 3).
        use_action: interleave actions inside the state windows
            (data_loaders.py:235-247).
        action_key: dataset key holding per-frame actions.
        seed: numpy RandomState seed (the sampler is reproducible).
    """

    MIN_DEMO_LEN = 3  # s1 ~ U[2, T) needs T >= 3 (data_loaders.py:205)

    def __init__(self, dataset, view_keys, batch_size=16, alpha=0.2,
                 state_keys=(), state_window=3, use_action=False,
                 action_key="actions", seed=0):
        assert len(view_keys) >= 1, "need at least one camera view"
        assert 0.0 < alpha <= 0.5, f"alpha={alpha} outside (0, 0.5]"
        self.dataset = dataset
        self.view_keys = list(view_keys)
        self.batch_size = int(batch_size)
        self.alpha = float(alpha)
        self.state_keys = list(state_keys)
        self.state_window = int(state_window)
        self.use_action = bool(use_action)
        self.action_key = action_key
        self.rng = np.random.RandomState(seed)
        self.demos = [
            ep for ep in dataset.demos
            if dataset._demo_id_to_demo_length[ep] >= self.MIN_DEMO_LEN
        ]
        assert self.demos, (
            f"no demo has >= {self.MIN_DEMO_LEN} frames; MCR temporal "
            f"sampling needs s0 < s1 <= s2 inside each demo"
        )

    def _sample_indices(self, vidlen):
        """The reference's exact index scheme (data_loaders.py:203-207)."""
        rng = self.rng
        start_ind = rng.randint(1, 2 + int(self.alpha * vidlen))
        end_ind = rng.randint(int((1 - self.alpha) * vidlen) - 1, vidlen)
        s1_ind = rng.randint(2, vidlen)
        s0_ind = rng.randint(1, s1_ind)
        s2_ind = rng.randint(s1_ind, vidlen)
        # clamp: the droid tree is 1-indexed with T files, so index T-1 is
        # its last frame too — same arrays, 0-based here
        return (min(start_ind, vidlen - 1), min(end_ind, vidlen - 1),
                s0_ind, s1_ind, s2_ind)

    def _state_window_vec(self, ep, ind, vidlen, states, actions):
        """One concatenated state window (data_loaders.py:219-247)."""
        parts = []
        wind_start = max(1, ind - self.state_window // 2)
        for i in range(self.state_window):
            t = min(wind_start + i, vidlen - 1)
            for key in self.state_keys:
                parts.append(np.asarray(states[key][t], np.float32).ravel())
            if self.use_action and i != self.state_window - 1:
                parts.append(np.asarray(actions[t], np.float32).ravel())
        if not parts:
            return np.zeros((0,), np.float32)
        return np.concatenate(parts)

    def _sample_one(self):
        ds = self.dataset
        ep = self.demos[self.rng.randint(0, len(self.demos))]
        vidlen = ds._demo_id_to_demo_length[ep]
        view = self.view_keys[self.rng.randint(0, len(self.view_keys))]
        idx = self._sample_indices(vidlen)

        frames = ds.get_dataset_for_ep(ep, f"obs/{view}")
        images = np.stack([np.asarray(frames[t]) for t in idx])
        actions_traj = ds.get_dataset_for_ep(ep, self.action_key)
        actions = np.stack(
            [np.asarray(actions_traj[t], np.float32) for t in idx]
        )
        states = {
            k: ds.get_dataset_for_ep(ep, f"obs/{k}") for k in self.state_keys
        }
        s0_vec = self._state_window_vec(ep, idx[2], vidlen, states,
                                        actions_traj)
        s2_vec = self._state_window_vec(ep, idx[4], vidlen, states,
                                        actions_traj)
        return images, actions, s0_vec, s2_vec

    def sample_batch(self):
        """One MCR batch: ``images`` uint8 [B, 5, H, W, 3], ``actions``
        float32 [B, 5, A], ``state_s0``/``state_s2`` float32 [B, D]."""
        ims, acts, s0s, s2s = zip(
            *(self._sample_one() for _ in range(self.batch_size))
        )
        return {
            "images": np.stack(ims).astype(np.uint8),
            "actions": np.stack(acts),
            "state_s0": np.stack(s0s),
            "state_s2": np.stack(s2s),
        }

    @property
    def state_dim(self):
        """Width of state_s0/state_s2 (for sizing align-state models)."""
        ep = self.demos[0]
        vec = self._state_window_vec(
            ep, 1, self.dataset._demo_id_to_demo_length[ep],
            {k: self.dataset.get_dataset_for_ep(ep, f"obs/{k}")
             for k in self.state_keys},
            self.dataset.get_dataset_for_ep(ep, self.action_key),
        )
        return int(vec.shape[0])

    def __iter__(self):
        while True:
            yield self.sample_batch()
