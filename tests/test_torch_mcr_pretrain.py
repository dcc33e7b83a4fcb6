"""MCR representation pretraining, the port's against the JAX package's.

* ``mcr_preprocess`` in float32 in both resize directions: 128 x 128 up to
  256 x 256 within 1e-6 and 300 x 320 down to 256 x 273 within 5e-5
  (measured 4.1e-5 on 0.5 % of the normalized values: float32 rounding of
  the antialiasing filter's sums; JAX's resize antialiases when it shrinks,
  as ``F.interpolate(antialias=True)`` does, and in float64 the two
  resizes agree within 1e-12).
* ``MCRRepresentation`` (ResNet-18 on 32 x 32 frames, all three losses, B 4)
  from JAX's variables (every leaf made random) in float64, the negatives
  pinned (one permutation the identity: ``sim(x, x)`` at the zero-safe
  norm), with ``l2dist`` true and false: every metric within 1e-8
  relative; with ``l2dist`` every parameter's gradient within 1e-8 of its
  tensor's largest.
* ``MCRPretrainer``: 3 steps against JAX's trainer from the same variables,
  the negatives replayed from the JAX step's own ``jax.random.permutation``
  draws (metrics within 1e-8 relative, parameters within 1e-8 of each
  tensor's largest, BatchNorm statistics within 1e-7: Flax's one-pass
  variance); an evaluation step changes nothing; a snapshot taken after 2
  steps resumes into a fresh trainer whose third step is the original's to
  the bit.
* The command line on synthetic data with a snapshot, a resume and the
  exported trunk; and ``MCRHdf5Buffer`` against the JAX adapter on the same
  HDF5 file and seed (with and without actions in the state windows),
  batch for batch to the bit, and through the command line (whose trunk
  pools its stem with the recorded-argmax pool).
"""

import copy
import os
import pickle

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from robot_manipulation_vq_vae_tpu.algo import mcr_pretrain as JaxPretrain
from robot_manipulation_vq_vae_tpu.data.dataset import SequenceDataset as JaxDataset
from robot_manipulation_vq_vae_tpu.data.mcr_adapter import MCRHdf5Buffer as JaxBuffer
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.algo import mcr_pretrain as PortPretrain
from robot_manipulation_vq_vae_tpu_torch.data.dataset import SequenceDataset
from robot_manipulation_vq_vae_tpu_torch.data.mcr_adapter import MCRHdf5Buffer
from robot_manipulation_vq_vae_tpu_torch.models.pretrained_nets import resize_bilinear
from robot_manipulation_vq_vae_tpu_torch.scripts import train_mcr_representation as PortCLI
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import float64_tree, perturbed_variables, random_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, IMG, A = 4, 32, 7
STATE_DIM = 14 * 3
KW = dict(size=18, hidden_dim=16, tcn_weight=1.0, align_state_weight=0.25, bc_weight=0.5,
          action_dim=A, resize_to_224=False)


@pytest.mark.parametrize("shape,tol", [((2, 128, 128, 3), 1e-6), ((1, 300, 320, 3), 5e-5)],
                         ids=["up_128", "down_300x320"])
def test_mcr_preprocess_matches_jax(shape, tol):
    x = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jax.jit(JaxPretrain.mcr_preprocess)(x))
    got = PortPretrain.mcr_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the float32 gap is rounding: in float64 the two resizes agree
    h, w = shape[1:3]
    size = (256, int(256 * w / h))
    x64 = x.astype(np.float64) / 255.0
    with jax.enable_x64():
        want64 = np.asarray(jax.image.resize(jnp.asarray(x64), (shape[0], *size, 3),
                                             method="bilinear"))
    got64 = resize_bilinear(torch.from_numpy(x64).permute(0, 3, 1, 2), *size)
    np.testing.assert_allclose(got64.permute(0, 2, 3, 1).numpy(), want64, atol=1e-12, rtol=0)


def _batch(seed=0, b=B):
    return next(JaxPretrain.synthetic_batches(b, IMG, A, STATE_DIM, num_batches=1, seed=seed))


def _perms(seed, b=B):
    """3 permutations, the first the identity (every row a fixed point)."""
    rng = np.random.RandomState(seed)
    return np.stack([np.arange(b), rng.permutation(b), rng.permutation(b)])


def _variables(model, batch, seed):
    """The JAX model's variables with every leaf random, float64: (nested,
    flat)."""
    perms = jnp.asarray(_perms(0, batch["images"].shape[0]))
    init = random_init(lambda rng, bt: model.init(rng, bt, perms, train=False))
    nested, flat = perturbed_variables(init(jax.random.PRNGKey(0), batch), seed)
    with jax.enable_x64():
        return float64_tree(nested), flat


def _port_model(flat, **kw):
    model = PortPretrain.MCRRepresentation(**{**KW, **kw}, state_dim=STATE_DIM).double()
    load_jax_variables(model, flat)
    return model


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("l2dist", [True, False], ids=["l2", "cosine"])
def test_loss_and_gradients_match_jax(l2dist):
    """The metrics of both similarities; the gradients of the L2 one (the
    identity permutation puts every row's ``sim(x, x)`` in the loss)."""
    batch, perms = _batch(), _perms(3)
    model = JaxPretrain.MCRRepresentation(**KW, l2dist=l2dist)
    variables, flat = _variables(model, batch, 5)
    with jax.enable_x64():
        def loss_fn(params, batch):
            return model.apply({**variables, "params": params}, batch, jnp.asarray(perms))

        if l2dist:
            (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"], batch)
        else:
            metrics = jax.jit(loss_fn)(variables["params"], batch)[1]
    port = _port_model(flat, l2dist=l2dist).eval()
    got_loss, got = port(_torch(batch), torch.from_numpy(perms))
    assert set(got) == set(metrics) == {"tcnloss", "aligned", "bc_loss", "state_align_loss",
                                        "stateimg_aligned", "full_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(got[k].detach()), float(metrics[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    if not l2dist:
        return
    got_loss.backward()
    want = copy.deepcopy(port)
    load_jax_variables(want, flatten_variables({"params": grads, **{
        k: v for k, v in variables.items() if k != "params"}}))
    want_grads = {n: p.detach() for n, p in want.named_parameters()}
    for n, p in port.named_parameters():
        scale = float(want_grads[n].abs().max())
        err = float((p.grad - want_grads[n]).abs().max())
        assert err <= 1e-8 * max(scale, 1e-12), f"{n}: {err} of {scale}"


def _jax_trainer(model, variables, lr, seed):
    """The JAX package's trainer on @variables (its own init compiles each
    op of the trunk alone)."""
    tr = object.__new__(JaxPretrain.MCRPretrainer)
    tr.model, tr.tx, tr.step = model, optax.adam(lr), 0
    tr.rng = jax.random.split(jax.random.PRNGKey(seed))[0]
    tr.params, tr.batch_stats = variables["params"], variables["batch_stats"]
    tr.opt_state = jax.jit(tr.tx.init)(tr.params)
    tr._train_step = jax.jit(tr._step_impl, static_argnames="train")
    return tr


def _jax_step_perms(tr, b):
    """The permutations the JAX trainer's next step draws."""
    _, perm_rng = jax.random.split(tr.rng)
    keys = jax.random.split(perm_rng, tr.model.num_negatives)
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, b))(keys))


def test_trainer_matches_jax_and_resumes(tmp_path):
    lr, batches = 1e-3, [_batch(seed=s) for s in range(4)]
    model = JaxPretrain.MCRRepresentation(**KW)
    variables, flat = _variables(model, batches[0], 7)
    metrics = []
    with jax.enable_x64():
        jax_tr = _jax_trainer(model, variables, lr, 1)
        trainer = PortPretrain.MCRPretrainer(_port_model(flat), lr=lr, device="cpu")
        for i, batch in enumerate(batches[:3]):
            perms = _jax_step_perms(jax_tr, B)
            want = jax_tr.update(batch)
            if i == 2:
                trainer.save_snapshot(str(tmp_path / "snapshot.pkl"))
                resumed = PortPretrain.MCRPretrainer(
                    PortPretrain.MCRRepresentation(**KW, state_dim=STATE_DIM).double(),
                    lr=lr, seed=9, device="cpu")
                resumed.load_snapshot(str(tmp_path / "snapshot.pkl"))
                assert resumed.step == 2
                again = resumed.update(batch, neg_perms=perms)
            got = trainer.update(batch, neg_perms=perms)
            metrics.append((want, got))
    for step, (want, got) in enumerate(metrics):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-12,
                                       err_msg=f"step {step} {k}")
    assert trainer.step == 3 and again == metrics[-1][1]
    for a, b in zip(resumed.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    expected = copy.deepcopy(trainer.model)
    load_jax_variables(expected, flatten_variables(
        {"params": jax_tr.params, "batch_stats": jax_tr.batch_stats}))
    got_sd, want_sd = trainer.model.state_dict(), expected.state_dict()
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-7 if k.endswith(("running_mean", "running_var")) else 1e-8
        err = float((got_sd[k] - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-12), f"{k}: {err}"
    # an evaluation step moves nothing
    before = copy.deepcopy(trainer.model.state_dict())
    trainer.update(batches[3], eval=True)
    assert trainer.step == 3
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cli_synthetic_run_resume_and_export(tmp_path):
    work, trunk = str(tmp_path / "run"), str(tmp_path / "trunk.pkl")
    args = ["--dataset", "synthetic", "--work_dir", work, "--train_steps", "3",
            "--eval_freq", "2", "--batch_size", "2", "--size", "18", "--image_size", str(IMG),
            "--lr", "1e-3", "--export_trunk", trunk, "--device", "cpu"]
    trainer = PortCLI.main(args)
    assert trainer.step == 3
    for name in ("snapshot.pkl", "snapshot_2.pkl", "metrics.jsonl"):
        assert os.path.exists(os.path.join(work, name)), name
    with open(os.path.join(work, "metrics.jsonl")) as f:
        splits = [line.split('"split": ')[1][:7] for line in f]
    assert splits == ['"train"', '"train"', '"eval",', '"train"']
    with open(trunk, "rb") as f:
        tree = pickle.load(f)
    assert "stem" in tree and "block7" in tree
    resumed = PortCLI.main(args + ["--load_snap", os.path.join(work, "snapshot.pkl"),
                                   "--train_steps", "4"])
    assert resumed.step == 4


# ---------------------------------------------------------------------------
# the HDF5 adapter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hdf5_path(tmp_path_factory):
    """4 demos (one of 2 frames, too short to sample) with two 8 x 8
    cameras, a 4-d proprio state and 7-d actions."""
    path = str(tmp_path_factory.mktemp("mcr") / "demos.hdf5")
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        total = 0
        for i, t in enumerate((9, 2, 12, 7)):
            ep = data.create_group(f"demo_{i}")
            ep.attrs["num_samples"] = t
            for cam in ("cam0_image", "cam1_image"):
                ep.create_dataset(f"obs/{cam}", data=rng.randint(0, 255, (t, 8, 8, 3),
                                                                 dtype=np.uint8))
            ep.create_dataset("obs/proprio", data=rng.randn(t, 4).astype(np.float32))
            ep.create_dataset("actions", data=rng.uniform(-1, 1, (t, A)).astype(np.float32))
            total += t
        data.attrs["total"] = total
    return path


@pytest.mark.parametrize("use_action", [False, True], ids=["states", "states_actions"])
def test_hdf5_buffer_matches_jax(hdf5_path, use_action):
    views, keys = ["cam0_image", "cam1_image"], ["proprio"]
    buffers = []
    for dataset, buffer in ((JaxDataset, JaxBuffer), (SequenceDataset, MCRHdf5Buffer)):
        ds = dataset(hdf5_path=hdf5_path, obs_keys=views + keys, action_keys=["actions"],
                     dataset_keys=("actions",), action_config={}, seq_length=1,
                     frame_stack=1, load_next_obs=False, hdf5_cache_mode="all")
        buffers.append(buffer(ds, views, batch_size=6, state_keys=keys,
                              use_action=use_action, seed=3))
    jax_buf, buf = buffers
    assert buf.demos == jax_buf.demos == ["demo_0", "demo_2", "demo_3"]
    assert buf.state_dim == jax_buf.state_dim == 3 * 4 + (2 * A if use_action else 0)
    for _ in range(2):
        want, got = jax_buf.sample_batch(), buf.sample_batch()
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_trains_from_hdf5(hdf5_path, tmp_path):
    trainer = PortCLI.main([
        "--dataset", hdf5_path, "--views", "cam0_image,cam1_image", "--state_keys", "proprio",
        "--align_state_weight", "0.5", "--work_dir", str(tmp_path / "run"),
        "--train_steps", "2", "--eval_freq", "2", "--batch_size", "3", "--size", "18",
        "--hidden_dim", "16", "--device", "cpu"])
    assert trainer.step == 2
    assert trainer.model.state_encoder[0].in_features == 3 * 4
    pools = [m for m in trainer.model.modules() if type(m).__name__ == "StemMaxPool"]
    assert len(pools) == 1 and pools[0].recorded_argmax
