"""The port's data path: HDF5 demo datasets, the host batch loader and the
device prefetcher (importing it touches no CUDA state)."""

from robot_manipulation_vq_vae_tpu_torch.data.dataset import (
    MetaDataset,
    SequenceDataset,
    action_stats_to_normalization_stats,
)
from robot_manipulation_vq_vae_tpu_torch.data.loader import DataLoader, InfiniteLoader, collate
from robot_manipulation_vq_vae_tpu_torch.data.memory_store import MemoryStore
from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
