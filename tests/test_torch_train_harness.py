"""The port's training harness against the JAX package's, at a small size (one
GPT layer of width 32, one 32 x 32 camera cropped to 28, an HVQVAE of 16 / 8
codes; a GMM paper policy of the same width; torch on one thread, which on a
shared CPU runs these small steps many times faster than a thread per core):

* ``run_epoch`` feeds ``train_on_batch`` the batches JAX's ``run_epoch``
  feeds it, from the same demo file and seed, synchronously and through each
  package's ``DevicePrefetcher``, and returns the same keys;
* a flagship checkpoint written by the port's ``save_model`` is read by the
  JAX package (``load_reference_torch_checkpoint`` ->
  ``convert_flagship_checkpoint`` -> ``policy_from_checkpoint``): its
  ``get_action`` agrees with the port's within the serving tolerance of
  tests/test_torch_icl_hvqvae.py, and its Adam moments pass through
  ``convert_torch_adam_moments``; the port reads it back bit for bit;
* ``serialize(include_optimizer=True)`` -> ``deserialize`` into a fresh algo,
  then 3 steps, equals 6 uninterrupted steps, to the bit, with random crops
  and dropout on, for the flagship and the paper policy;
* ``scripts/train.py --auto_resume`` continues past the newest checkpoint;
* the options that are not ported raise (rollouts, additional envs and the
  action MSE are ported: tests/test_torch_rollout.py).
"""

import argparse
import copy
import glob
import json
import os

import h5py
import numpy as np
import pytest
import torch

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from robot_manipulation_vq_vae_tpu.data.loader import DataLoader as JaxDataLoader
from robot_manipulation_vq_vae_tpu.data.prefetch import DevicePrefetcher as JaxPrefetcher
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import ckpt_conversion as Conv
from robot_manipulation_vq_vae_tpu.utils import file_utils as JaxFileUtils
from robot_manipulation_vq_vae_tpu.utils import lang_utils as JaxLang
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils import train_utils as JaxTrainUtils

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo.algo import reference_name
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.data.dataset import SequenceDataset
from robot_manipulation_vq_vae_tpu_torch.data.loader import DataLoader
from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
from robot_manipulation_vq_vae_tpu_torch.scripts import train as PortTrain
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as PortLang
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils
from torch_port_helpers import assert_trees_equal
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, T, A, IMG, CROP = 4, 3, 12, 32, 28
CAMS = ["agentview_image"]
LOW_DIM = {"eef_pos": (3,), "gripper_qpos": (2,)}
SHAPES = {**LOW_DIM, **{c: (IMG, IMG, 3) for c in CAMS}, "lang_emb": (768,)}


def _configure(cfg, algo="icl"):
    """The flagship (FiLM ResNet-18, language, random crops, dropout 0.1,
    HVQVAE) or the paper policy, shrunk."""
    with cfg.values_unlocked():
        cfg.experiment.name = "harness"
        cfg.experiment.logging.terminal_output_to_txt = False
        cfg.experiment.logging.log_tb = False
        cfg.experiment.rollout.enabled = False
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 8, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": CROP, "crop_width": CROP, "num_crops": 1, "pos_enc": False}
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.embed_dim = True, T, 32
        tc.num_layers, tc.num_heads = 1, 4
        tc.supervise_all_steps = tc.pred_future_acs = True
        if algo == "icl":
            tc.causal, tc.vq_vae_enabled = False, True
            vq = tc.vqvae
            vq.embed_dim, vq.num_subclusters, vq.num_clusters = 32, 16, 8
            vq.num_stages, vq.num_layers_per_stage = 1, 2
        # a rate that changes every step: the schedule's state must resume
        cfg.algo.optim_params.policy.learning_rate.scheduler_type = "linear"
        cfg.train.max_grad_norm = 1.0
        cfg.train.pallas_pool = True
        cfg.train.seed = 5
        cfg.train.batch_size = B
        cfg.train.seq_length = 2 * T - 1
        cfg.train.dataset_keys = ["actions"]
        cfg.train.hdf5_load_next_obs = False
        cfg.train.action_config = {"actions": {"normalization": "min_max"}}
    return cfg


def _write_demos(path, n=3, length=10, seed=0):
    """Demos with the configuration's observations, actions, the
    environment metadata and a language string per demo."""
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env_args"] = json.dumps({"env_name": "Fake", "type": 1,
                                             "env_kwargs": {}})
        for i in range(n):
            ep = data.create_group(f"demo_{i}")
            ep.attrs["num_samples"] = length
            ep.attrs["ep_meta"] = json.dumps({"lang": f"task {i % 2}"})
            for k, s in LOW_DIM.items():
                ep.create_dataset(f"obs/{k}", data=rng.randn(length, *s).astype(np.float32))
            for c in CAMS:
                ep.create_dataset(f"obs/{c}", data=rng.randint(
                    0, 256, (length, IMG, IMG, 3), dtype=np.uint8))
            ep.create_dataset("actions", data=rng.uniform(
                -1, 1, (length, A)).astype(np.float32))
    return path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    return _write_demos(str(tmp_path_factory.mktemp("harness") / "demos.hdf5"))


def _port_algo(algo="icl", cfg=None):
    cfg = cfg or _configure(config_factory(algo), algo)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    return PortAlgo.algo_factory(algo, cfg, SHAPES, A, device="cpu")


def _batches(n, seed=1, b=B):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        obs = {k: rng.randn(b, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
        obs.update({c: rng.randint(0, 256, (b, T, IMG, IMG, 3), dtype=np.uint8)
                    for c in CAMS})
        obs["lang_emb"] = rng.randn(b, T, 768).astype(np.float32)
        out.append({"obs": obs, "goal_obs": None,
                    "actions": rng.uniform(-1, 1, (b, T, A)).astype(np.float32)})
    return out


# ---------------------------------------------------------------------------
# run_epoch
# ---------------------------------------------------------------------------

class _Recorder:
    """An algo whose step records the prepared batch it is given."""

    def __init__(self, algo):
        self.algo, self.batches = algo, []
        self.device = torch.device("cpu")

    def process_batch_for_training(self, batch):
        return self.algo.process_batch_for_training(batch)

    def postprocess_batch_for_training(self, batch, obs_normalization_stats=None):
        return self.algo.postprocess_batch_for_training(batch, obs_normalization_stats)

    def set_train(self):
        pass

    def set_eval(self):
        pass

    def train_on_batch(self, batch, epoch, validate=False):
        self.batches.append(copy.deepcopy({
            k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else None if v is None else np.asarray(v)) for k, v in batch.items()}))
        return {"losses": {"action_loss": float(len(self.batches))}}

    def log_info(self, info):
        return {"Loss": info["losses"]["action_loss"]}


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetcher"])
def test_run_epoch_feeds_the_jax_batches(demo_path, prefetch):
    """Two epochs of 4 steps over 5-batch passes of the loader, with the
    observation statistics applied in the preparation."""
    port_cfg = _configure(config_factory("icl"))
    jax_cfg = _configure(jax_config_factory("icl"))
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    try:
        jax_rec = _Recorder(JaxAlgo.algo_factory("icl", jax_cfg, SHAPES, A))
    finally:
        set_pallas_pool(False)
    port_rec = _Recorder(_port_algo("icl", port_cfg))
    stats = {"eef_pos": {"offset": np.array([[0.5, -0.5, 0.0]], np.float32),
                         "scale": np.array([[2.0, 3.0, 0.5]], np.float32)}}
    ds_kw = dict(hdf5_path=demo_path, obs_keys=list(LOW_DIM) + CAMS,
                 action_keys=["actions"], dataset_keys=["actions"],
                 action_config={"actions": {"normalization": "min_max"}},
                 seq_length=2 * T - 1, hdf5_cache_mode="all", load_next_obs=False)
    ld_kw = dict(batch_size=B, seed=3, num_workers=2, reuse_buffers=True)
    runs = {}
    for side, rec, ds_cls, lang, ld_cls, pf_cls, utils in (
            ("jax", jax_rec, JaxSequenceDataset, JaxLang, JaxDataLoader, JaxPrefetcher,
             JaxTrainUtils),
            ("port", port_rec, SequenceDataset, PortLang, DataLoader,
             DevicePrefetcher, TrainUtils)):
        loader = ld_cls(ds_cls(**ds_kw, lang_encoder=lang.LangEncoder()), **ld_kw)
        it = None
        if prefetch:
            kw = {"device": "cpu"} if side == "port" else {}
            it = pf_cls(loader, prepare=utils.make_batch_preparer(rec, stats), **kw)
        try:
            runs[side] = [utils.run_epoch(rec, loader, epoch, num_steps=4,
                                          obs_normalization_stats=stats,
                                          data_loader_iter=it) for epoch in (1, 2)]
        finally:
            if it is not None:
                it.close()
    assert len(port_rec.batches) == len(jax_rec.batches) == 8
    for got, want in zip(port_rec.batches, jax_rec.batches):
        assert_trees_equal(got, want)
    for got, want in zip(runs["port"], runs["jax"]):
        assert set(got) >= set(want)
        assert set(got) - set(want) == ({"prefetch/stage_s", "prefetch/stall_s",
                                         "prefetch/pinned"} if prefetch else set())
        assert got["Loss"] == want["Loss"]
    if prefetch:
        assert [r["prefetch/batches"] for r in runs["port"]] == [4, 4]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A flagship trained 2 steps on the CPU, saved with its optimizers."""
    algo = _port_algo()
    for batch in _batches(2):
        algo.train_on_batch(batch, epoch=1)
    cfg = _configure(config_factory("icl"))
    with cfg.values_unlocked():
        cfg.experiment.save.include_optimizer = True
    shape_meta = {"all_shapes": {k: list(v) for k, v in SHAPES.items()},
                  "all_obs_keys": sorted(SHAPES), "ac_dim": A, "use_images": True}
    path = str(tmp_path_factory.mktemp("ckpt") / "models" / "model_epoch_1.pth")
    stats = {"actions": {"scale": np.full((1, A), 0.5, np.float32),
                         "offset": np.zeros((1, A), np.float32)}}
    TrainUtils.save_model(algo, cfg, {"env_name": "Fake"}, shape_meta, path,
                          action_normalization_stats=stats)
    return algo, path


def _request(seed=9, b=2):
    batch = _batches(1, seed, b)[0]
    return batch["obs"], {"actions": batch["actions"]}


def test_checkpoint_layout(saved):
    algo, path = saved
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt["model"]
    for key in ("policy.params.embed_timestep", "policy.nets.embed_encoder.weight",
                "policy.nets.embed_ln.bias",
                f"policy.nets.encoder.nets.obs.obs_nets.{CAMS[0]}.nets.2.weight",
                f"policy.nets.encoder.nets.obs.obs_nets.{CAMS[0]}.pool.nets.weight",
                f"policy.nets.encoder.nets.obs.obs_nets.{CAMS[0]}.backbone."
                "_conv_blocks.7.bn2.running_var",
                "policy.nets.transformer.nets.transformer.0.nets.attention.nets.qkv.weight",
                "policy.nets.transformer.nets.output_ln.weight",
                "policy.nets.decoder.nets.action.weight",
                "vqvae.codebook_z", "vqvae.embed_avg_q", "vqvae.codebooks_initialized"):
        assert key in model, key
    assert not any(k.startswith("policy.net.") for k in model)
    assert ckpt["shape_metadata"]["all_shapes"][CAMS[0]] == [3, IMG, IMG]
    assert json.loads(ckpt["config"])["algo_name"] == "icl" == ckpt["algo_name"]
    state = model["training_state"]
    assert state["step"] == 2 == algo.global_step
    assert set(state["optimizers"]) == {"policy", "vqvae"}
    assert not os.listdir(os.path.dirname(path)) == []
    assert [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")] == []


def test_port_reads_its_checkpoint_bit_for_bit(saved):
    algo, path = saved
    loaded, ckpt = FileUtils.algo_from_checkpoint(device="cpu", ckpt_path=path)
    assert not loaded.nets.training
    for k, v in algo.nets.state_dict().items():
        assert torch.equal(loaded.nets.state_dict()[k], v), k
    obs, ctx = _request()
    assert torch.equal(loaded.get_action(obs, ctx), algo.get_action(obs, ctx))
    assert loaded.nets["vqvae"]._initialized
    assert FileUtils.shape_metadata_from_reference(
        ckpt["shape_metadata"], json.loads(ckpt["config"]))["all_shapes"][CAMS[0]] == \
        [IMG, IMG, 3]


def test_jax_package_reads_the_checkpoint(saved):
    """The JAX package's reader of the reference's .pth files, unchanged."""
    algo, path = saved
    ckpt = Conv.convert_flagship_checkpoint(JaxFileUtils.load_reference_torch_checkpoint(path))
    assert ckpt["shape_metadata"]["all_shapes"][CAMS[0]] == [IMG, IMG, 3]
    try:
        policy, _ = JaxFileUtils.policy_from_checkpoint(ckpt_dict=ckpt)
        obs, ctx = _request()
        want = np.asarray(policy.policy.get_action(obs, context_batch=ctx))
    finally:
        set_pallas_pool(False)
    got = algo.get_action(obs, ctx).numpy()
    assert got.shape == want.shape == (2, A)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_adam_moments_convert_through_the_jax_package(saved):
    algo, path = saved
    raw = JaxFileUtils.load_reference_torch_checkpoint(path)
    cfg = json.loads(raw["config"])
    names = [reference_name(f"policy.{n}")
             for n, _ in algo.nets["policy"].named_parameters()]

    def convert(sd):
        return Conv.convert_transformer_actor(sd, cfg, with_stats=False)[0]

    count, mu, nu = Conv.convert_torch_adam_moments(
        raw["model"]["training_state"]["optimizers"]["policy"], names, convert)
    assert count == 2
    params = convert({k: v for k, v in raw["model"].items() if k.startswith("policy.")})
    assert _structure(mu) == _structure(nu) == _structure(params)
    state = algo.optimizers["policy"].state_dict()["state"]
    head = [i for i, (n, _) in enumerate(algo.nets["policy"].named_parameters())
            if n == "net.decoder.nets.action.weight"][0]
    np.testing.assert_array_equal(mu["net"]["decoder"]["head_action"]["kernel"],
                                  state[head]["exp_avg"].numpy().T)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return np.shape(tree)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo_name", ["icl", "icl_gmm_paper"])
def test_resume_equals_uninterrupted(algo_name, tmp_path):
    """6 steps straight, against 3 steps, a checkpoint through a .pth file, a
    fresh algo and 3 more steps; the global generator is scrambled before
    the resumed steps, so dropout must come from the checkpoint."""
    b = 2 * B if algo_name == "icl_gmm_paper" else B   # context + supervised
    batches = _batches(6, seed=4, b=b)
    torch.manual_seed(123)
    straight = _port_algo(algo_name)
    for batch in batches:
        straight.train_on_batch(batch, epoch=1)

    torch.manual_seed(123)
    first = _port_algo(algo_name)
    for batch in batches[:3]:
        first.train_on_batch(batch, epoch=1)
    path = str(tmp_path / "resume.pth")
    FileUtils.save_checkpoint({"model": first.serialize(include_optimizer=True)}, path)
    torch.manual_seed(999)
    resumed = _port_algo(algo_name)
    resumed.deserialize(FileUtils.maybe_dict_from_checkpoint(ckpt_path=path)["model"])
    assert resumed.global_step == 3
    for batch in batches[3:]:
        resumed.train_on_batch(batch, epoch=1)

    want, got = straight.nets.state_dict(), resumed.nets.state_dict()
    # the last 3 steps moved the heads, the GPT and the BatchNorm statistics
    # (at 28 x 28 the trunk's output is 1 x 1, and its weights get no gradient)
    for k in ("policy.net.decoder.nets.mean.weight" if algo_name == "icl_gmm_paper"
              else "policy.net.decoder.nets.action.weight",
              "policy.net.transformer.nets.transformer.0.nets.mlp.0.weight",
              f"policy.net.encoder.nets.obs.obs_nets.{CAMS[0]}.backbone."
              "_base_block.1.running_mean"):
        assert not torch.equal(want[k], first.nets.state_dict()[k]), k
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for n, opt in straight.optimizers.items():
        assert_trees_equal(resumed.optimizers[n].state_dict()["state"],
                           opt.state_dict()["state"], n)
    assert resumed.lr_schedulers["policy"].get_last_lr() == \
        straight.lr_schedulers["policy"].get_last_lr()


def test_serialize_names_round_trip():
    for name in ("icl", "icl_gmm_paper"):
        algo = _port_algo(name)
        blob = algo.serialize()
        assert len(blob) == len(algo.nets.state_dict())
        fresh = _port_algo(name)
        with torch.no_grad():
            for p in fresh.nets.parameters():
                p.add_(1.0)
        fresh.deserialize(blob)
        for k, v in algo.nets.state_dict().items():
            assert torch.equal(fresh.nets.state_dict()[k], v), k
        with pytest.raises(KeyError, match="does not have"):
            fresh.deserialize({**blob, "policy.nets.extra": torch.zeros(1)})


# ---------------------------------------------------------------------------
# scripts/train.py
# ---------------------------------------------------------------------------

def _args(cfg_path, **kw):
    args = dict(config=cfg_path, algo=None, name=None, dataset=None, output_dir=None,
                debug=False, eval_only=False, auto_resume=False, device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


def test_auto_resume(demo_path, tmp_path):
    """A 1-epoch run, then --auto_resume with 2 epochs: the second run starts
    from model_epoch_1.pth and trains epoch 2 only."""
    cfg = json.loads(_configure(config_factory("icl")).dump())
    cfg["train"].update(data=demo_path, output_dir=str(tmp_path / "out"), num_epochs=1,
                        num_data_workers=1)
    cfg["experiment"].update(epoch_every_n_steps=2)
    cfg["experiment"]["save"].update(enabled=True, every_n_epochs=1,
                                     include_optimizer=True)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    first = PortTrain.main(_args(cfg_path))
    assert [h["epoch"] for h in first] == [1]
    ckpts = glob.glob(str(tmp_path / "out" / "harness" / "*" / "models" / "*.pth"))
    assert [os.path.basename(p) for p in ckpts] == ["model_epoch_1.pth"]
    assert PortTrain.newest_checkpoint(
        config_factory("icl", dic=cfg))[1] == 1

    cfg["train"]["num_epochs"] = 2
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    second = PortTrain.main(_args(cfg_path, auto_resume=True))
    assert [h["epoch"] for h in second] == [2]
    assert np.isfinite(second[0]["Loss"]) and second[0]["prefetch/batches"] == 2
    names = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "out" / "harness" / "*" / "models" / "*.pth")))
    assert names == ["model_epoch_1.pth", "model_epoch_2.pth"]
    ckpt = FileUtils.maybe_dict_from_checkpoint(ckpt_path=sorted(glob.glob(
        str(tmp_path / "out" / "harness" / "*" / "models" / "model_epoch_2.pth")))[0])
    assert ckpt["model"]["training_state"]["step"] == 4


@pytest.mark.parametrize("option", ["orbax", "r2d2"])
def test_unported_options_raise(demo_path, tmp_path, option):
    cfg = _configure(config_factory("icl"))
    with cfg.values_unlocked():
        cfg.train.data = demo_path
        cfg.train.output_dir = str(tmp_path)
        if option == "orbax":
            cfg.experiment.save.format = "orbax"
        else:
            cfg.train.data_format = "r2d2"
    with pytest.raises(NotImplementedError):
        PortTrain.train(cfg, device="cpu")
