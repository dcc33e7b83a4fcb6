"""The port's data path against the JAX package's, on the same HDF5 demo
files (written by ``torch_port_helpers.write_demo_file``, a copy of
tests/test_dataset.py's writer):

* ``SequenceDataset.get_item`` / ``get_batch`` bit-equal to JAX's, with and
  without the native gather, in each cache mode, with frame stacks, sequence
  padding, unpadded windows, goals, pad masks, language, filter keys and
  ``hdf5_normalize_obs``;
* the action normalization statistics and ``MetaDataset`` (sampler weights,
  batches) equal JAX's;
* ``DataLoader`` yields JAX's batches for the same seed (shuffled, weighted,
  threaded, with ``reuse_buffers``);
* the port's ``native`` gathers equal JAX ``native``'s, and its build leaves
  no partial file behind when the compiler fails;
* ``DevicePrefetcher`` on the CPU yields the synchronous stream and joins its
  thread on ``close()``; its statistics count the batches consumed;
* a ``MemoryStore`` behind ``open_hdf5`` reads as the file does.
"""

import json
import os
import stat

import h5py
import numpy as np
import pytest
import torch

from robot_manipulation_vq_vae_tpu import native as jax_native
from robot_manipulation_vq_vae_tpu.data import dataset as JaxDataset
from robot_manipulation_vq_vae_tpu.data import loader as JaxLoader
from robot_manipulation_vq_vae_tpu.utils import lang_utils as JaxLang
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

from robot_manipulation_vq_vae_tpu_torch import native
from robot_manipulation_vq_vae_tpu_torch.data import dataset as PortDataset
from robot_manipulation_vq_vae_tpu_torch.data import loader as PortLoader
from robot_manipulation_vq_vae_tpu_torch.data.memory_store import MemoryStore
from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as PortLang
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from torch_port_helpers import assert_trees_equal, write_demo_file
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

SPEC = {"obs": {"low_dim": ["eef_pos"], "rgb": ["cam_image"]}}


@pytest.fixture(autouse=True)
def modalities():
    JaxObsUtils.initialize_obs_utils_with_obs_specs(SPEC)
    PortObsUtils.initialize_obs_utils_with_obs_specs(SPEC)


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    """Three demos (9, 6 and 12 steps) with next_obs, for goals."""
    path = str(tmp_path_factory.mktemp("data") / "demos.hdf5")
    write_demo_file(path, demo_lengths=[9, 6, 12])
    with h5py.File(path, "a") as f:
        for ep in f["data"]:
            for k in ("eef_pos", "cam_image"):
                src = f[f"data/{ep}/obs/{k}"][()]
                f.create_dataset(f"data/{ep}/next_obs/{k}", data=np.roll(src, -1, axis=0))
    return path


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def gather(request, monkeypatch):
    """Both packages with their native gather, or both on numpy."""
    if request.param:
        assert native.is_available() and jax_native.is_available()
    else:
        monkeypatch.setattr(native, "_lib", False)
        monkeypatch.setattr(jax_native, "_lib", False)
    return request.param


def _kwargs(path, **kwargs):
    kw = dict(hdf5_path=path, obs_keys=["eef_pos", "cam_image"], action_keys=["actions"],
              dataset_keys=["actions"], action_config={"actions": {"normalization": None}},
              frame_stack=3, seq_length=2, hdf5_cache_mode=None, load_next_obs=False)
    kw.update(kwargs)
    return kw


def _port_ds(path, lang=False, **kwargs):
    return PortDataset.SequenceDataset(
        **_kwargs(path, **kwargs), lang_encoder=PortLang.LangEncoder() if lang else None)


def _pair(path, lang=False, **kwargs):
    """(JAX dataset, port dataset) over @path with the same arguments."""
    jax_ds = JaxDataset.SequenceDataset(
        **_kwargs(path, **kwargs), lang_encoder=JaxLang.LangEncoder() if lang else None)
    return jax_ds, _port_ds(path, lang, **kwargs)


CONFIGS = {
    "stack3_seq2": dict(),
    "seq5": dict(frame_stack=1, seq_length=5),
    "unpadded": dict(frame_stack=2, seq_length=4, pad_frame_stack=False,
                     pad_seq_length=False),
    "goal_last": dict(frame_stack=2, seq_length=4, goal_mode="last", load_next_obs=True),
    "pad_mask": dict(get_pad_mask=True),
    "lang": dict(lang=True, seq_length=4),
    "filter_key": dict(filter_by_attribute="first_only"),
    "normalize_obs": dict(hdf5_normalize_obs=True, frame_stack=1, seq_length=3),
    "min_max": dict(action_config={"actions": {"normalization": "min_max"}}),
    "gaussian": dict(action_config={"actions": {"normalization": "gaussian"}}),
}


@pytest.mark.parametrize("cache_mode", [None, "low_dim", "all"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_sequence_dataset_matches_jax(demo_path, gather, cache_mode, config):
    jax_ds, port_ds = _pair(demo_path, hdf5_cache_mode=cache_mode, **CONFIGS[config])
    assert len(port_ds) == len(jax_ds) and port_ds.demos == jax_ds.demos
    for i in range(len(jax_ds)):
        assert_trees_equal(port_ds[i], jax_ds[i], f"item {i}")
    idx = np.random.RandomState(0).randint(0, len(jax_ds), 11)
    want = jax_ds.get_batch(idx)
    got = port_ds.get_batch(idx)
    if want is None:
        assert got is None
    else:
        assert_trees_equal(got, want, "batch")
        assert_trees_equal(got, PortLoader.collate([port_ds[int(i)] for i in idx]),
                           "collated")
    assert_trees_equal(port_ds.get_action_normalization_stats(),
                       jax_ds.get_action_normalization_stats())
    if port_ds.hdf5_normalize_obs:
        assert_trees_equal(port_ds.obs_normalization_stats,
                           jax_ds.obs_normalization_stats)


def test_native_gather_is_the_batched_path(demo_path):
    """With the library, cache mode "all" windows whole batches natively."""
    assert native.is_available()
    port_ds = _port_ds(demo_path, hdf5_cache_mode="all")
    assert port_ds.getitem_cache is None and port_ds.hdf5_cache is not None
    assert port_ds.get_batch([0, 5, 20]) is not None


@pytest.mark.parametrize("method", ["min_max", "gaussian", None])
def test_action_normalization_stats_match_jax(method):
    rng = np.random.RandomState(3)
    arr = rng.randn(40, 4).astype(np.float32) * [1.0, 2.0, 0.0, 5.0]
    stats = PortDataset._aggregate_traj_stats(
        PortDataset._compute_traj_stats({"actions": arr[:15]}),
        PortDataset._compute_traj_stats({"actions": arr[15:]}))
    want_stats = JaxDataset._aggregate_traj_stats(
        JaxDataset._compute_traj_stats({"actions": arr[:15]}),
        JaxDataset._compute_traj_stats({"actions": arr[15:]}))
    assert_trees_equal(stats, want_stats)
    cfg = {"actions": {"normalization": method}}
    assert_trees_equal(PortDataset.action_stats_to_normalization_stats(stats, cfg),
                       JaxDataset.action_stats_to_normalization_stats(want_stats, cfg))


def test_meta_dataset_matches_jax(tmp_path, gather):
    paths = [write_demo_file(str(tmp_path / "a.hdf5"), [7, 5]),
             write_demo_file(str(tmp_path / "b.hdf5"), [9], seed=3)]
    cfg = dict(hdf5_cache_mode="low_dim",
               action_config={"actions": {"normalization": "min_max"}})
    members = [_pair(p, **cfg) for p in paths]
    want = JaxDataset.MetaDataset([m[0] for m in members], [1.0, 3.0],
                                  normalize_weights_by_ds_size=True)
    got = PortDataset.MetaDataset([m[1] for m in members], [1.0, 3.0],
                                  normalize_weights_by_ds_size=True)
    np.testing.assert_array_equal(got.get_dataset_sampler(), want.get_dataset_sampler())
    assert_trees_equal(got.get_action_normalization_stats(),
                       want.get_action_normalization_stats())
    idx = np.random.RandomState(1).randint(0, len(want), 13)
    for i in idx:
        assert_trees_equal(got[int(i)], want[int(i)])
    batch = want.get_batch(idx, buffers={})
    if batch is None:
        assert got.get_batch(idx, buffers={}) is None
    else:
        assert_trees_equal(got.get_batch(idx, buffers={}), batch)
    with pytest.raises(ValueError, match="cache mode"):
        PortDataset.MetaDataset([_port_ds(paths[0], hdf5_cache_mode="all")], [1.0])


@pytest.mark.parametrize("kind", ["shuffled", "weighted", "sequential", "threads"])
def test_data_loader_matches_jax(demo_path, kind):
    """The same seed gives the same batches, drawn through the reused buffer
    ring (each batch copied as it arrives), over two passes."""
    jax_ds, port_ds = _pair(demo_path, hdf5_cache_mode="all")
    n = len(jax_ds)
    kw = dict(batch_size=5, seed=4, reuse_buffers=True,
              num_workers=2 if kind == "threads" else 0,
              shuffle=kind != "sequential", drop_last=kind != "sequential")
    if kind == "weighted":
        kw["sampler_weights"] = np.linspace(1, 2, n) / np.linspace(1, 2, n).sum()

    def stream(loader_cls, ds):
        loader = loader_cls(ds, **kw)
        return [_copy(b) for _ in range(2) for b in loader]

    want = stream(JaxLoader.DataLoader, jax_ds)
    got = stream(PortLoader.DataLoader, port_ds)
    assert len(got) == len(want) == 2 * len(PortLoader.DataLoader(port_ds, **kw))
    for g, w in zip(got, want):
        assert_trees_equal(g, w)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return None if tree is None else np.array(tree)


def test_infinite_loader_restarts():
    loader = PortLoader.DataLoader(list(range(6)), batch_size=4, shuffle=False,
                                   num_workers=0)
    it = PortLoader.InfiniteLoader(loader)
    assert [next(it).tolist() for _ in range(3)] == [[0, 1, 2, 3]] * 3


def test_native_gathers_match_jax():
    rng = np.random.RandomState(5)
    src = rng.randint(0, 255, (11, 4, 3), dtype=np.uint8)
    starts = np.array([-3, 0, 4, 9, 12], np.int64)
    np.testing.assert_array_equal(native.gather_windows(src, starts, 5),
                                  jax_native.gather_windows(src, starts, 5))
    big = rng.randn(40, 64, 64, 3).astype(np.float32)   # over 8 MB: threaded
    dst = np.array([3, 0, 2, 1], np.int64)
    st = np.array([-2, 10, 30, 38], np.int64)
    out_p = np.zeros((4, 12, 64, 64, 3), np.float32)
    out_j = np.zeros_like(out_p)
    native.gather_windows_at(big, out_p, dst, st, 12)
    jax_native.gather_windows_at(big, out_j, dst, st, 12)
    np.testing.assert_array_equal(out_p, out_j)
    srcs = [src, src[:3], src[5:]]
    np.testing.assert_array_equal(native.gather_windows_multi(srcs, starts[:3], 4),
                                  jax_native.gather_windows_multi(srcs, starts[:3], 4))
    t_lens = np.array([11, 3, 6, 11, 11], np.int64)
    np.testing.assert_array_equal(native.window_pad_masks(starts, t_lens, 5),
                                  jax_native.window_pad_masks(starts, t_lens, 5))


def test_native_build_is_atomic(tmp_path, monkeypatch):
    """A compiler that writes part of its output and fails leaves nothing
    under the build directory; a working one leaves only the library, under
    a name with the source's hash."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad-cxx"
    bad.write_text('#!/bin/sh\nfor a; do out=$last; last=$a; done\n'
                   'echo partial > "$last"\nexit 1\n')
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="failed"):
        native.build(compiler=str(bad))
    assert os.listdir(tmp_path / "build") == []
    path = native.build()
    assert os.listdir(tmp_path / "build") == [path.name]
    assert path.name.startswith("libwindow_gather-") and path == native.library_path()


def test_prefetcher_on_cpu_yields_the_synchronous_stream(demo_path):
    """Depth 2 over a reused buffer ring, with a preparation that slices (a
    strided view) and normalizes; two passes of the loader."""
    ds = _port_ds(demo_path, hdf5_cache_mode="all")

    def prepare(batch):
        return {"obs": {k: v[:, :2] for k, v in batch["obs"].items()},
                "actions": batch["actions"] * 2.0, "goal_obs": None}

    kw = dict(batch_size=4, seed=2, num_workers=2, reuse_buffers=True)
    sync = PortLoader.DataLoader(ds, **kw)
    want = [_copy(prepare(b)) for _ in range(2) for b in sync]
    loader = PortLoader.DataLoader(ds, **kw)
    pf = DevicePrefetcher(loader, prepare=prepare, depth=2, device="cpu")
    try:
        got = [pf.get() for _ in range(len(want))]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert not pf.pinned
    for g, w in zip(got, want):
        assert isinstance(g["obs"]["cam_image"], torch.Tensor)
        assert g["obs"]["cam_image"].is_contiguous()
        assert_trees_equal(g, w)


def test_prefetcher_counts_the_batches_consumed(demo_path):
    """Statistics are recorded when a batch is handed out: after a reset,
    a window of k gets counts k batches, though the thread has prepared
    more (the JAX package's counts the batches produced)."""
    ds = _port_ds(demo_path, hdf5_cache_mode="all")
    loader = PortLoader.DataLoader(ds, batch_size=4, seed=2, num_workers=0)
    with DevicePrefetcher(loader, depth=3, device="cpu") as pf:
        first = pf.get()
        pf.reset_stats()
        got = [pf.get() for _ in range(2)]
        summary = pf.transfer_summary()
    assert summary["batches"] == 2
    nbytes = sum(sum(v.numel() * v.element_size() for v in
                     ([b["actions"], b["index"]] + list(b["obs"].values()))) for b in got)
    assert summary["transfer_mbytes"] * 1e6 == pytest.approx(nbytes)
    assert summary["transfer_s"] == 0.0 and summary["stall_s"] >= 0.0
    assert first["obs"]["eef_pos"].shape[0] == 4


def test_prefetcher_surfaces_errors_and_refuses_a_missing_card(demo_path):
    ds = _port_ds(demo_path)
    loader = PortLoader.DataLoader(ds, batch_size=4, num_workers=0)

    def bad(batch):
        raise ValueError("prepare failed")

    pf = DevicePrefetcher(loader, prepare=bad, device="cpu")
    with pytest.raises(ValueError, match="prepare failed"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()

    def failing_loader():
        yield next(iter(loader))
        raise OSError("the file went away")

    pf = DevicePrefetcher(failing_loader(), device="cpu")
    assert pf.get()["obs"]["eef_pos"].shape[0] == 4
    with pytest.raises(OSError, match="went away"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePrefetcher(loader, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePrefetcher(loader)


def test_in_memory_store_through_the_opener(demo_path, monkeypatch):
    """A MemoryStore copy of the file, served by a replacement of
    ``open_hdf5``, gives the same items and batches as the file (the path a
    card host without h5py takes)."""
    store = MemoryStore()
    with h5py.File(demo_path, "r") as f:
        def copy(name, node):
            if isinstance(node, h5py.Dataset):
                store.create_dataset(name, data=node[()])
            else:
                if name not in store:
                    store.create_group(name)
                store[name].attrs.update(node.attrs)
        f.visititems(copy)
    assert "data/demo_0/obs/eef_pos" in store and "data/demo_9" not in store
    assert store["data"].keys() == ["demo_0", "demo_1", "demo_2"]
    want = _port_ds(demo_path, hdf5_cache_mode="all", lang=True,
                    filter_by_attribute="first_only")
    monkeypatch.setattr(PortDataset, "open_hdf5", lambda *a, **k: store)
    for cache_mode in ("all", None):
        got = _port_ds("unused.hdf5", hdf5_cache_mode=cache_mode, lang=True,
                       filter_by_attribute="first_only")
        idx = np.arange(len(want))
        assert_trees_equal(got.get_batch(idx), want.get_batch(idx))
        for i in idx:
            assert_trees_equal(got[i], want[i])


def test_lang_encoder_is_the_jax_pseudo_embedding():
    port, jax_enc = PortLang.LangEncoder(), JaxLang.LangEncoder()
    assert not port.is_real
    np.testing.assert_array_equal(port.get_lang_emb(["task 0", "pick"]),
                                  jax_enc.get_lang_emb(["task 0", "pick"]))
    assert json.dumps(port.get_lang_emb("x").shape) == "[768]"


def test_file_metadata_matches_jax(tmp_path):
    from robot_manipulation_vq_vae_tpu.utils import file_utils as JaxFileUtils

    from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils

    path = write_demo_file(str(tmp_path / "meta.hdf5"), [4, 6, 5])
    with h5py.File(path, "a") as f:
        f["data"].attrs["env_args"] = json.dumps({"env_name": "Fake", "type": 1})
    for utils in (JaxFileUtils, FileUtils):
        lengths = utils.create_hdf5_filter_key(path, ["demo_2", "demo_0"], f"k_{id(utils)}")
        np.testing.assert_array_equal(lengths, [5, 4])
    assert FileUtils.get_demos_for_filter_key(path, f"k_{id(FileUtils)}") == \
        JaxFileUtils.get_demos_for_filter_key(path, f"k_{id(JaxFileUtils)}") == \
        ["demo_2", "demo_0"]
    assert FileUtils.get_env_metadata_from_dataset(path) == \
        JaxFileUtils.get_env_metadata_from_dataset(path)
    want = JaxFileUtils.get_shape_metadata_from_dataset(path, ["actions"])
    got = FileUtils.get_shape_metadata_from_dataset(path, ["actions"])
    assert got == want and got["all_shapes"]["cam_image"] == [8, 8, 3]
    # the language embedding comes from the encoder, 768 wide, where the
    # file holds none (the JAX package reads it from the file)
    PortObsUtils.initialize_obs_utils_with_obs_specs(
        {"obs": {"low_dim": ["eef_pos", "lang_emb"], "rgb": ["cam_image"]}})
    lang = FileUtils.get_shape_metadata_from_dataset(
        path, ["actions"], all_obs_keys=["eef_pos", "lang_emb", "cam_image"])
    assert lang["all_shapes"]["lang_emb"] == [768]
    FileUtils.atomic_write_json(str(tmp_path / "x.json"), {"a": 1})
    assert json.load(open(tmp_path / "x.json")) == {"a": 1}
    assert sorted(os.listdir(tmp_path)) == ["meta.hdf5", "x.json"]


def test_observation_statistics_normalize(demo_path):
    """``normalize_obs`` gives mean / std statistics; the port's
    normalize_dict applies them as (x - mean) / std, and action-style offset /
    scale ones as (x - offset) / scale. (The JAX package's normalize_dict
    reads only offset / scale, so its training path with
    hdf5_normalize_obs raises a KeyError.)"""
    from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObs

    _, ds = _pair(demo_path, hdf5_normalize_obs=True)
    stats = ds.obs_normalization_stats
    x = {"eef_pos": np.random.RandomState(0).randn(4, 2, 3).astype(np.float32)}
    got = PortObsUtils.normalize_dict(x, stats)["eef_pos"]
    np.testing.assert_array_equal(
        got, (x["eef_pos"] - stats["eef_pos"]["mean"][0]) / stats["eef_pos"]["std"][0])
    np.testing.assert_allclose(
        PortObsUtils.unnormalize_dict({"eef_pos": got}, stats)["eef_pos"], x["eef_pos"],
        rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError):
        JaxObs.normalize_dict(x, stats)
    as_offset = {"eef_pos": {"offset": stats["eef_pos"]["mean"],
                             "scale": stats["eef_pos"]["std"]}}
    np.testing.assert_array_equal(PortObsUtils.normalize_dict(x, as_offset)["eef_pos"],
                                  JaxObs.normalize_dict(x, as_offset)["eef_pos"])
