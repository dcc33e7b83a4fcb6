"""HDF5 demonstration datasets (a port-owned copy of the JAX package's
``data/dataset.py``, numpy only; no JAX).

Same observable semantics as the JAX package, which follows the reference
``robomimic/utils/dataset.py``:

  * windowed sequence fetch of length (frame_stack - 1 + seq_length) with
    edge padding + pad masks at demo boundaries;
  * per-demo index maps built from ``num_samples`` attrs;
  * filter keys (``mask/<key>``) selecting demo subsets;
  * per-key action normalization (min_max to +/-0.999999 with range_eps
    dimension-ignoring, gaussian, none) applied in get_item;
  * caching modes "all" / "low_dim" / None; with "all" and the native
    window gather, ``get_batch`` windows whole batches from the in-memory
    [T, ...] arrays;
  * per-demo language strings -> embeddings tiled over time;
  * MetaDataset concatenation with weighted sampling and Welford-style
    statistic merging.

Images stay uint8 HWC up to the device; the algo's step converts them.

Files are opened through ``open_hdf5``, the one place that names ``h5py``
(imported there, at the first open). A caller without ``h5py`` may replace it
with a function that returns an object with the same ``File`` / ``Group`` /
``Dataset`` surface.

The R2D2/DROID file format (``train.data_format = "r2d2"``) is not ported.
"""

import json
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager

import numpy as np

from robot_manipulation_vq_vae_tpu_torch import native
from robot_manipulation_vq_vae_tpu_torch.utils import action_utils as AcUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils


def open_hdf5(path, mode="r", swmr=False):
    """Open the HDF5 file at @path (``h5py.File``; reads use the latest
    library version, which SWMR needs)."""
    import h5py

    if mode == "r":
        return h5py.File(path, mode, swmr=swmr, libver="latest")
    return h5py.File(path, mode)


LANG_EMB_KEY = ObsUtils.LANG_EMB_KEY


class SequenceDataset:
    """Windowed sequence dataset over one HDF5 demo file."""

    def __init__(
        self,
        hdf5_path,
        obs_keys,
        action_keys,
        dataset_keys,
        action_config,
        frame_stack=1,
        seq_length=1,
        pad_frame_stack=True,
        pad_seq_length=True,
        get_pad_mask=False,
        goal_mode=None,
        hdf5_cache_mode=None,
        hdf5_use_swmr=True,
        hdf5_normalize_obs=False,
        filter_by_attribute=None,
        load_next_obs=True,
        shuffled_obs_key_groups=None,
        lang_encoder=None,
        dataset_lang=None,
    ):
        self.hdf5_path = os.path.expanduser(hdf5_path)
        self.hdf5_use_swmr = hdf5_use_swmr
        self.hdf5_normalize_obs = hdf5_normalize_obs
        self._hdf5_file = None

        if hdf5_cache_mode not in ("all", "low_dim", None):
            raise ValueError(f"hdf5_cache_mode {hdf5_cache_mode!r}")
        self.hdf5_cache_mode = hdf5_cache_mode
        self.load_next_obs = load_next_obs
        self.filter_by_attribute = filter_by_attribute

        self.obs_keys = tuple(obs_keys)
        self.action_keys = tuple(action_keys)
        self.dataset_keys = tuple(dataset_keys)
        if self.action_keys is not None:
            self.dataset_keys = tuple(
                set(self.dataset_keys).union(set(self.action_keys))
            )
        self.action_config = action_config
        self.dataset_lang = dataset_lang

        self.n_frame_stack = frame_stack
        if self.n_frame_stack < 1:
            raise ValueError(f"frame_stack {frame_stack} < 1")
        self.seq_length = seq_length
        if self.seq_length < 1:
            raise ValueError(f"seq_length {seq_length} < 1")

        self.goal_mode = goal_mode
        if self.goal_mode is not None:
            if self.goal_mode != "last":
                raise ValueError(f"goal_mode {goal_mode!r}")
        if not self.load_next_obs:
            if self.goal_mode == "last":
                raise ValueError('goal_mode "last" needs load_next_obs')

        self.pad_seq_length = pad_seq_length
        self.pad_frame_stack = pad_frame_stack
        self.get_pad_mask = get_pad_mask

        self._lang_encoder = lang_encoder
        self.load_demo_info(filter_by_attribute=self.filter_by_attribute)

        self.obs_normalization_stats = None
        if self.hdf5_normalize_obs:
            self.obs_normalization_stats = self.normalize_obs()

        self.action_normalization_stats = None

        self.hdf5_cache = None
        self.getitem_cache = None
        if self.hdf5_cache_mode in ["all", "low_dim"]:
            obs_keys_in_memory = self.obs_keys
            if self.hdf5_cache_mode == "low_dim":
                obs_keys_in_memory = [
                    k for k in self.obs_keys
                    if ObsUtils.key_is_obs_modality(k, "low_dim")
                ]
            self.obs_keys_in_memory = tuple(obs_keys_in_memory)
            self.hdf5_cache = self._load_dataset_in_memory()
            if self.hdf5_cache_mode == "all":
                if native.is_available():
                    # keep the [T, ...] in-memory cache and window on demand
                    # through the batched native gather (get_batch): one
                    # memcpy per (demo, key) per batch, and none of the
                    # reference's window-duplicated getitem cache (which
                    # costs window-x the RAM; reference dataset.py:156-184)
                    pass
                else:
                    self.getitem_cache = [
                        self.get_item(i) for i in range(len(self))
                    ]
                    self.hdf5_cache = None

        self.shuffled_obs_key_groups = list(shuffled_obs_key_groups or [])
        self.close_and_delete_hdf5_handle()

    # ------------------------------------------------------------ hdf5
    @property
    def hdf5_file(self):
        """Read handle, one per thread: concurrent reads on a single h5py
        handle serialize on h5py's global lock, so loader worker threads
        each get their own (read-only / SWMR handles on one file are safe
        and parallelize page-cache reads)."""
        if not hasattr(self, "_hdf5_handles"):
            self._hdf5_handles = threading.local()
            self._all_hdf5_handles = []
        h = getattr(self._hdf5_handles, "handle", None)
        if h is None:
            h = open_hdf5(self.hdf5_path, "r", swmr=self.hdf5_use_swmr)
            self._hdf5_handles.handle = h
            self._all_hdf5_handles.append(h)
        return h

    def close_and_delete_hdf5_handle(self):
        for h in getattr(self, "_all_hdf5_handles", []):
            try:
                h.close()
            except Exception:
                pass
        self._all_hdf5_handles = []
        if hasattr(self, "_hdf5_handles"):
            self._hdf5_handles = threading.local()
        self._hdf5_file = None

    @contextmanager
    def hdf5_file_opened(self):
        should_close = self._hdf5_file is None
        yield self.hdf5_file
        if should_close:
            self.close_and_delete_hdf5_handle()

    def __del__(self):
        try:
            self.close_and_delete_hdf5_handle()
        except Exception:
            pass  # interpreter teardown

    # ------------------------------------------------------------ demo maps
    def load_demo_info(self, filter_by_attribute=None, demos=None):
        if demos is not None:
            self.demos = demos
        elif filter_by_attribute is not None:
            self.demos = [
                e.decode("utf-8")
                for e in np.array(self.hdf5_file[f"mask/{filter_by_attribute}"][:])
            ]
        else:
            self.demos = list(self.hdf5_file["data"].keys())
        # sort numerically by the demo index suffix
        inds = np.argsort([int(e[5:]) for e in self.demos])
        self.demos = [self.demos[i] for i in inds]
        self.n_demos = len(self.demos)

        self._index_to_demo_id = {}
        self._demo_id_to_start_indices = {}
        self._demo_id_to_demo_length = {}
        self._demo_id_to_demo_lang_str = {}
        self._demo_id_to_demo_lang_emb = {}

        self.total_num_sequences = 0
        for ep in self.demos:
            demo_length = int(self.hdf5_file[f"data/{ep}"].attrs["num_samples"])
            self._demo_id_to_start_indices[ep] = self.total_num_sequences
            self._demo_id_to_demo_length[ep] = demo_length

            if self.dataset_lang is not None:
                self._demo_id_to_demo_lang_str[ep] = self.dataset_lang
            else:
                ep_meta = self.hdf5_file[f"data/{ep}"].attrs.get("ep_meta", None)
                if ep_meta is not None:
                    lang = json.loads(ep_meta).get("lang", "dummy")
                    if lang is not None:
                        self._demo_id_to_demo_lang_str[ep] = lang

            num_sequences = demo_length
            if not self.pad_frame_stack:
                num_sequences -= self.n_frame_stack - 1
            if not self.pad_seq_length:
                num_sequences -= self.seq_length - 1
            if self.pad_seq_length:
                if demo_length < 1:
                    raise ValueError(f"{ep} is empty")
                num_sequences = max(num_sequences, 1)
            else:
                if num_sequences < 1:
                    raise ValueError(f"{ep} ({demo_length} steps) is shorter than "
                                     "one unpadded window")
            for _ in range(num_sequences):
                self._index_to_demo_id[self.total_num_sequences] = ep
                self.total_num_sequences += 1

        # per-demo language embeddings (batched encode; reference :261-276)
        if self._lang_encoder is not None and self._demo_id_to_demo_lang_str:
            for i in range(0, len(self.demos), 64):
                batch = self.demos[i : i + 64]
                embs = self._lang_encoder.get_lang_emb(
                    [self._demo_id_to_demo_lang_str[ep] for ep in batch]
                )
                embs = np.asarray(embs)
                for j, ep in enumerate(batch):
                    self._demo_id_to_demo_lang_emb[ep] = embs[j]

    def __len__(self):
        return self.total_num_sequences

    # ------------------------------------------------------------ caching
    def _load_dataset_in_memory(self):
        cache = {}
        f = self.hdf5_file
        for ep in self.demos:
            cache[ep] = {"attrs": {"num_samples": self._demo_id_to_demo_length[ep]}}
            cache[ep]["obs"] = {
                k: f[f"data/{ep}/obs/{k}"][()] for k in self.obs_keys_in_memory
            }
            if self.load_next_obs:
                cache[ep]["next_obs"] = {
                    k: f[f"data/{ep}/next_obs/{k}"][()]
                    for k in self.obs_keys_in_memory
                }
            for k in self.dataset_keys:
                if f"data/{ep}/{k}" in f:
                    cache[ep][k] = f[f"data/{ep}/{k}"][()].astype(np.float32)
                else:
                    cache[ep][k] = np.zeros(
                        (self._demo_id_to_demo_length[ep], 1), np.float32
                    )
        return cache

    def get_dataset_for_ep(self, demo_id, key):
        """Fetch a full [T, ...] array for @key in @demo_id (cache-aware)."""
        in_cache = self.hdf5_cache is not None and (
            key.split("/")[0] not in ("obs", "next_obs")
            or key.split("/")[1] in self.obs_keys_in_memory
        )
        if in_cache:
            node = self.hdf5_cache[demo_id]
            for part in key.split("/"):
                node = node[part]
            return node
        return self.hdf5_file[f"data/{demo_id}/{key}"]

    # ------------------------------------------------------------ fetching
    def get_sequence_from_demo(self, demo_id, index_in_demo, keys,
                               num_frames_to_stack=0, seq_length=1):
        """Windowed fetch with edge padding + pad mask (reference :588-632)."""
        assert num_frames_to_stack >= 0 and seq_length >= 1
        demo_length = self._demo_id_to_demo_length[demo_id]
        assert index_in_demo < demo_length

        seq_begin_index = max(0, index_in_demo - num_frames_to_stack)
        seq_end_index = min(demo_length, index_in_demo + seq_length)
        seq_begin_pad = max(0, num_frames_to_stack - index_in_demo)
        seq_end_pad = max(0, index_in_demo + seq_length - demo_length)
        if not self.pad_frame_stack:
            assert seq_begin_pad == 0
        if not self.pad_seq_length:
            assert seq_end_pad == 0

        seq = {}
        window = num_frames_to_stack + seq_length
        start = np.asarray([index_in_demo - num_frames_to_stack], np.int64)
        for k in keys:
            data = self.get_dataset_for_ep(demo_id, k)
            if isinstance(data, np.ndarray):
                # native C++ edge-padded gather (single memcpy loop) on the
                # in-memory cache path
                seq[k] = native.gather_windows(data, start, window)[0]
            else:
                arr = np.asarray(data[seq_begin_index:seq_end_index])
                seq[k] = TensorUtils.pad_sequence_single(
                    arr, (seq_begin_pad, seq_end_pad), pad_same=True
                )
        pad_mask = np.array(
            [0] * seq_begin_pad
            + [1] * (seq_end_index - seq_begin_index)
            + [0] * seq_end_pad
        )[:, None].astype(bool)
        return seq, pad_mask

    def get_obs_sequence_from_demo(self, demo_id, index_in_demo, keys,
                                   num_frames_to_stack=0, seq_length=1,
                                   prefix="obs"):
        obs, pad_mask = self.get_sequence_from_demo(
            demo_id,
            index_in_demo=index_in_demo,
            keys=tuple(f"{prefix}/{k}" for k in keys),
            num_frames_to_stack=num_frames_to_stack,
            seq_length=seq_length,
        )
        obs = {"/".join(k.split("/")[1:]): obs[k] for k in obs}
        if self.get_pad_mask:
            obs["pad_mask"] = pad_mask
        return obs

    def get_dataset_sequence_from_demo(self, demo_id, index_in_demo, keys,
                                       num_frames_to_stack=0, seq_length=1):
        data, pad_mask = self.get_sequence_from_demo(
            demo_id,
            index_in_demo=index_in_demo,
            keys=keys,
            num_frames_to_stack=num_frames_to_stack,
            seq_length=seq_length,
        )
        if self.get_pad_mask:
            data["pad_mask"] = pad_mask
        return data

    def __getitem__(self, index):
        if self.getitem_cache is not None:
            return self.getitem_cache[index]
        return self.get_item(index)

    def get_item(self, index):
        """Reference get_item (:499-585)."""
        demo_id = self._index_to_demo_id[index]
        demo_start_index = self._demo_id_to_start_indices[demo_id]
        demo_length = self._demo_id_to_demo_length[demo_id]

        demo_index_offset = 0 if self.pad_frame_stack else (self.n_frame_stack - 1)
        index_in_demo = index - demo_start_index + demo_index_offset
        demo_length_offset = 0 if self.pad_seq_length else (self.seq_length - 1)
        end_index_in_demo = demo_length - demo_length_offset

        meta = self.get_dataset_sequence_from_demo(
            demo_id,
            index_in_demo=index_in_demo,
            keys=self.dataset_keys,
            num_frames_to_stack=self.n_frame_stack - 1,
            seq_length=self.seq_length,
        )

        goal_index = None
        if self.goal_mode == "last":
            goal_index = end_index_in_demo - 1

        meta["obs"] = self.get_obs_sequence_from_demo(
            demo_id,
            index_in_demo=index_in_demo,
            keys=self.obs_keys,
            num_frames_to_stack=self.n_frame_stack - 1,
            seq_length=self.seq_length,
            prefix="obs",
        )
        if self.load_next_obs:
            meta["next_obs"] = self.get_obs_sequence_from_demo(
                demo_id,
                index_in_demo=index_in_demo,
                keys=self.obs_keys,
                num_frames_to_stack=self.n_frame_stack - 1,
                seq_length=self.seq_length,
                prefix="next_obs",
            )
        if goal_index is not None:
            goal = self.get_obs_sequence_from_demo(
                demo_id,
                index_in_demo=goal_index,
                keys=self.obs_keys,
                num_frames_to_stack=0,
                seq_length=1,
                prefix="next_obs",
            )
            meta["goal_obs"] = {k: goal[k][0] for k in goal}

        # action components -> normalize -> concatenate (:559-573)
        ac_dict = OrderedDict()
        for k in self.action_keys:
            ac = meta[k]
            if ac.ndim == 1:
                ac = ac.reshape(-1, 1)
            ac_dict[k] = ac
        stats = self.get_action_normalization_stats()
        ac_dict = ObsUtils.normalize_dict(ac_dict, stats)
        meta["actions"] = AcUtils.action_dict_to_vector(ac_dict).astype(np.float32)
        meta["index"] = index

        if demo_id in self._demo_id_to_demo_lang_emb:
            t = meta["actions"].shape[0]
            meta["obs"][LANG_EMB_KEY] = np.tile(
                self._demo_id_to_demo_lang_emb[demo_id], (t, 1)
            )
        return meta

    # ------------------------------------------------------------ batched
    def get_batch(self, indices, buffers=None):
        """Batched get_item fast path: one native edge-padded window gather
        per (demo, key), scattered straight into the batch arrays (no
        per-sample dicts, no collate re-stack). Produces exactly
        ``collate([get_item(i) for i in indices])``; returns None when a
        feature needs the per-item path (pad masks, shuffled obs groups,
        uncached/disk-backed keys, partial language embeddings).

        @buffers: optional dict for output-buffer reuse across batches
        (page faults on fresh ~100MB allocations cost ~20x the memcpy);
        the caller owns the aliasing contract (see DataLoader.reuse_buffers).
        """
        if self.get_pad_mask or self.shuffled_obs_key_groups:
            return None
        if not native.is_available():
            return None

        indices = np.asarray(indices, dtype=np.int64)
        nfs = self.n_frame_stack - 1
        window = nfs + self.seq_length

        def alloc(name, shape, dtype):
            if buffers is None:
                return np.empty(shape, dtype)
            buf = buffers.get(name)
            if buf is None or buf.shape != shape or buf.dtype != dtype:
                buf = np.empty(shape, dtype)
                buffers[name] = buf
            return buf

        groups = {}  # demo_id -> list of positions in the batch
        idx_in_demo = np.empty(len(indices), np.int64)
        for pos, index in enumerate(indices):
            demo_id = self._index_to_demo_id[int(index)]
            groups.setdefault(demo_id, []).append(pos)
            offset = 0 if self.pad_frame_stack else nfs
            idx_in_demo[pos] = (
                int(index) - self._demo_id_to_start_indices[demo_id] + offset
            )

        def gather_key(key):
            out = None
            for demo_id, positions in groups.items():
                data = self.get_dataset_for_ep(demo_id, key)
                if out is None:
                    out = alloc(
                        key,
                        (len(indices), window) + data.shape[1:], data.dtype,
                    )
                if isinstance(data, np.ndarray):
                    starts = idx_in_demo[positions] - nfs
                    native.gather_windows_at(
                        data, out, np.asarray(positions, np.int64), starts,
                        window,
                    )
                    continue
                # disk-backed key: one ranged h5py read per sample, written
                # straight into the batch row; edges replicate (pad_same)
                t_len = data.shape[0]
                for pos in positions:
                    start = int(idx_in_demo[pos]) - nfs
                    lo = max(0, start)
                    hi = min(t_len, start + window)
                    left = lo - start
                    data.read_direct(
                        out, np.s_[lo:hi], np.s_[pos, left : left + hi - lo]
                    )
                    if left:
                        out[pos, :left] = out[pos, left]
                    right = start + window - hi
                    if right:
                        out[pos, window - right :] = out[pos, window - right - 1]
            return out

        meta = {}
        for k in self.dataset_keys:
            arr = gather_key(k)
            if arr is None:
                return None
            meta[k] = arr

        obs = {}
        for k in self.obs_keys:
            arr = gather_key(f"obs/{k}")
            if arr is None:
                return None
            obs[k] = arr
        meta["obs"] = obs

        if self.load_next_obs:
            next_obs = {}
            for k in self.obs_keys:
                arr = gather_key(f"next_obs/{k}")
                if arr is None:
                    return None
                next_obs[k] = arr
            meta["next_obs"] = next_obs

        if self.goal_mode == "last":
            goal = {}
            for k in self.obs_keys:
                out = None
                for demo_id, positions in groups.items():
                    data = self.get_dataset_for_ep(demo_id, f"next_obs/{k}")
                    demo_length = self._demo_id_to_demo_length[demo_id]
                    end = demo_length - (
                        0 if self.pad_seq_length else self.seq_length - 1
                    )
                    frame = data[end - 1]
                    if out is None:
                        out = alloc(
                            f"goal/{k}",
                            (len(indices),) + frame.shape, frame.dtype,
                        )
                    out[positions] = frame
                goal[k] = out
            meta["goal_obs"] = goal

        # action components -> normalize -> concatenate (batched; stats
        # broadcast over the leading [B, T] dims)
        ac_dict = OrderedDict()
        for k in self.action_keys:
            ac = meta[k]
            if ac.ndim == 2:  # [B, T] -> [B, T, 1]
                ac = ac[..., None]
            ac_dict[k] = ac
        stats = self.get_action_normalization_stats()
        ac_dict = ObsUtils.normalize_dict(ac_dict, stats)
        # batched action_dict_to_vector: flatten past [B, T], concat last dim
        meta["actions"] = np.concatenate(
            [
                np.asarray(ac_dict[k]).reshape(
                    ac_dict[k].shape[0], ac_dict[k].shape[1], -1
                )
                for k in self.action_keys
            ],
            axis=-1,
        ).astype(np.float32)
        meta["index"] = indices

        if self._demo_id_to_demo_lang_emb:
            if any(d not in self._demo_id_to_demo_lang_emb for d in groups):
                return None
            emb0 = next(iter(self._demo_id_to_demo_lang_emb.values()))
            out = alloc(
                "lang_emb", (len(indices), window, emb0.shape[-1]), emb0.dtype
            )
            for demo_id, positions in groups.items():
                out[positions] = np.tile(
                    self._demo_id_to_demo_lang_emb[demo_id], (window, 1)
                )
            meta["obs"][LANG_EMB_KEY] = out
        return meta

    # ------------------------------------------------------------ statistics
    def get_action_traj(self, ep):
        return {
            k: np.asarray(
                self.get_dataset_for_ep(ep, k)[()], dtype=np.float32
            ).reshape(self._demo_id_to_demo_length[ep], -1)
            for k in self.action_keys
        }

    def get_action_stats(self):
        ep = self.demos[0]
        stats = _compute_traj_stats(self.get_action_traj(ep))
        for ep in self.demos[1:]:
            stats = _aggregate_traj_stats(
                stats, _compute_traj_stats(self.get_action_traj(ep))
            )
        return stats

    def set_action_normalization_stats(self, action_normalization_stats):
        self.action_normalization_stats = action_normalization_stats

    def get_action_normalization_stats(self):
        if self.action_normalization_stats is None:
            self.action_normalization_stats = action_stats_to_normalization_stats(
                self.get_action_stats(), self.action_config
            )
        return self.action_normalization_stats

    def normalize_obs(self):
        """Global mean/std per obs key (reference ``normalize_obs``)."""

        def traj_obs(ep):
            return {
                k: np.asarray(
                    self.hdf5_file[f"data/{ep}/obs/{k}"][()], np.float32
                ).reshape(self._demo_id_to_demo_length[ep], -1)
                for k in self.obs_keys
            }

        stats = _compute_traj_stats(traj_obs(self.demos[0]))
        for ep in self.demos[1:]:
            stats = _aggregate_traj_stats(stats, _compute_traj_stats(traj_obs(ep)))
        out = {}
        for k, s in stats.items():
            out[k] = {
                "mean": s["mean"],
                "std": np.sqrt(s["sqdiff"] / s["n"]) + 1e-3,
            }
        return out

    def get_dataset_sampler(self):
        return None

    def __repr__(self):
        return (
            f"{self.__class__.__name__} (path={self.hdf5_path}, "
            f"demos={self.n_demos}, sequences={self.total_num_sequences}, "
            f"frame_stack={self.n_frame_stack}, seq_length={self.seq_length})"
        )


class MetaDataset:
    """Concatenation of SequenceDatasets with weighted sampling
    (reference dataset.py:1063-1155)."""

    def __init__(self, datasets, ds_weights, normalize_weights_by_ds_size=False):
        self.datasets = list(datasets)
        ds_lens = np.array([len(ds) for ds in self.datasets])
        if normalize_weights_by_ds_size:
            self.ds_weights = np.array(ds_weights) / ds_lens
        else:
            self.ds_weights = np.array(ds_weights)
        self._ds_ind_bins = np.cumsum([0] + list(ds_lens))

        # cache mode "all" bakes stale normalization stats into cached items
        for ds in self.datasets:
            if ds.hdf5_cache_mode == "all":
                raise ValueError("MetaDataset requires cache mode != 'all' "
                                 "(normalization stats are set after member "
                                 "datasets are built)")

        action_stats = self.get_action_stats()
        self.action_normalization_stats = action_stats_to_normalization_stats(
            action_stats, self.datasets[0].action_config
        )
        self.set_action_normalization_stats(self.action_normalization_stats)

    def __len__(self):
        return int(np.sum([len(ds) for ds in self.datasets]))

    def __getitem__(self, idx):
        ds_ind = int(np.digitize(idx, self._ds_ind_bins)) - 1
        ind_in_ds = int(idx - self._ds_ind_bins[ds_ind])
        meta = self.datasets[ds_ind][ind_in_ds]
        meta["index"] = idx
        return meta

    def get_batch(self, indices, buffers=None):
        """Batched fast path over the member datasets: group by dataset,
        delegate to each member's get_batch, merge with one scatter per
        array. Returns None if any member needs the per-item path or the
        members disagree on batch schema."""
        indices = np.asarray(indices, dtype=np.int64)
        parts = {}  # ds_ind -> (positions, local indices)
        for pos, idx in enumerate(indices):
            ds_ind = int(np.digitize(idx, self._ds_ind_bins)) - 1
            positions, local = parts.setdefault(ds_ind, ([], []))
            positions.append(pos)
            local.append(int(idx - self._ds_ind_bins[ds_ind]))

        sub_batches = []
        positions_list = []
        for ds_ind, (positions, local) in parts.items():
            sub_buf = None
            if buffers is not None:
                sub_buf = buffers.setdefault(f"_ds{ds_ind}", {})
            sub = self.datasets[ds_ind].get_batch(
                np.asarray(local, np.int64), buffers=sub_buf
            )
            if sub is None:
                return None
            sub_batches.append(sub)
            positions_list.append(np.asarray(positions, np.int64))

        def alloc(name, shape, dtype):
            if buffers is None:
                return np.empty(shape, dtype)
            buf = buffers.get(name)
            if buf is None or buf.shape != shape or buf.dtype != dtype:
                buf = np.empty(shape, dtype)
                buffers[name] = buf
            return buf

        total = len(indices)

        def merge(trees, name):
            first = trees[0]
            if isinstance(first, dict):
                keys = set(first)
                if any(set(t) != keys for t in trees[1:]):
                    return None  # schema mismatch -> per-item path
                out = {}
                for k in first:
                    v = merge([t[k] for t in trees], f"{name}/{k}")
                    if v is None:
                        return None
                    out[k] = v
                return out
            out = alloc(name, (total,) + first.shape[1:], first.dtype)
            for t, pos in zip(trees, positions_list):
                out[pos] = t
            return out

        merged = merge(sub_batches, "batch")
        if merged is None:
            return None
        merged["index"] = indices
        return merged

    def get_action_stats(self):
        stats = self.datasets[0].get_action_stats()
        for ds in self.datasets[1:]:
            stats = _aggregate_traj_stats(stats, ds.get_action_stats())
        return stats

    def set_action_normalization_stats(self, action_normalization_stats):
        self.action_normalization_stats = action_normalization_stats
        for ds in self.datasets:
            ds.set_action_normalization_stats(action_normalization_stats)

    def get_action_normalization_stats(self):
        if self.action_normalization_stats is None:
            self.action_normalization_stats = action_stats_to_normalization_stats(
                self.get_action_stats(), self.datasets[0].action_config
            )
        return self.action_normalization_stats

    def get_dataset_sampler(self):
        """Per-index sampling weights, or None if uniform (reference
        :1116-1137)."""
        if np.all(self.ds_weights == 1):
            return None
        weights = np.ones(len(self))
        for i, (start, end) in enumerate(
            zip(self._ds_ind_bins[:-1], self._ds_ind_bins[1:])
        ):
            weights[start:end] = self.ds_weights[i]
        return weights / weights.sum()

    def __repr__(self):
        return "\n".join(repr(ds) for ds in self.datasets)


# ---------------------------------------------------------------------------
# statistics helpers (reference dataset.py:1160-1255, exact math)
# ---------------------------------------------------------------------------

def _compute_traj_stats(traj_obs_dict):
    stats = {k: {} for k in traj_obs_dict}
    for k, arr in traj_obs_dict.items():
        stats[k]["n"] = arr.shape[0]
        stats[k]["mean"] = arr.mean(axis=0, keepdims=True)
        stats[k]["sqdiff"] = ((arr - stats[k]["mean"]) ** 2).sum(
            axis=0, keepdims=True
        )
        stats[k]["min"] = arr.min(axis=0, keepdims=True)
        stats[k]["max"] = arr.max(axis=0, keepdims=True)
    return stats


def _aggregate_traj_stats(a, b):
    merged = {}
    for k in a:
        n_a, avg_a, m2_a = a[k]["n"], a[k]["mean"], a[k]["sqdiff"]
        n_b, avg_b, m2_b = b[k]["n"], b[k]["mean"], b[k]["sqdiff"]
        n = n_a + n_b
        mean = (n_a * avg_a + n_b * avg_b) / n
        delta = avg_b - avg_a
        m2 = m2_a + m2_b + (delta**2) * (n_a * n_b) / n
        merged[k] = dict(
            n=n, mean=mean, sqdiff=m2,
            min=np.minimum(a[k]["min"], b[k]["min"]),
            max=np.maximum(a[k]["max"], b[k]["max"]),
        )
    return merged


def action_stats_to_normalization_stats(action_stats, action_config):
    """Exact reference math (dataset.py:1192-1255), including the
    +/-0.999999 output range and the range_eps dimension-ignoring."""
    out = OrderedDict()
    for action_key in action_stats:
        norm_method = action_config.get(action_key, {}).get("normalization", None)
        if norm_method is None:
            out[action_key] = {
                "scale": np.ones_like(action_stats[action_key]["mean"], np.float32),
                "offset": np.zeros_like(action_stats[action_key]["mean"], np.float32),
            }
        elif norm_method == "min_max":
            range_eps = 1e-4
            input_min = action_stats[action_key]["min"].astype(np.float32)
            input_max = action_stats[action_key]["max"].astype(np.float32)
            output_min, output_max = -0.999999, 0.999999
            input_range = input_max - input_min
            ignore_dim = input_range < range_eps
            input_range[ignore_dim] = output_max - output_min
            scale = input_range / (output_max - output_min)
            offset = input_min - scale * output_min
            offset[ignore_dim] = (
                input_min[ignore_dim] - (output_max + output_min) / 2
            )
            out[action_key] = {"scale": scale, "offset": offset}
        elif norm_method == "gaussian":
            input_mean = action_stats[action_key]["mean"].astype(np.float32)
            input_std = np.sqrt(
                action_stats[action_key]["sqdiff"] / action_stats[action_key]["n"]
            ).astype(np.float32)
            std_eps = 1e-6
            input_std[input_std < std_eps] = 1.0
            # NOTE: the reference stores mean as "scale" and std as "offset"
            # here (dataset.py:1246-1250) - an upstream naming bug; we keep
            # the conventional mapping and document the divergence.
            out[action_key] = {"scale": input_std, "offset": input_mean}
        else:
            raise NotImplementedError(
                f'normalization "{norm_method}" is not supported'
            )
    return out
