"""Ranks of the port's mesh tests (tests/test_torch_mesh.py): each runs in a
spawned process on ``gloo`` with a ``file://`` rendezvous, so it imports
only PyTorch and the port (no JAX: a spawned rank must not load it).

``start_ranks(job, world, work, *args)`` starts @world ranks of
``job(rank, world, work, *args)``; what it returns waits for them and gives
the ranks' results (each saved with ``torch.save`` under @work). The
configurations, models and batches are shared with the parent test, which
builds the same algos from the same seed, unsharded, and the JAX package's
from their weights."""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# __graft_entry__'s tiny flagship: two low-dim keys, H = 4, A = 12, B = 8;
# with rgb one 32 x 32 camera and a language embedding (FiLM ResNet-18)
OBS_KEYS = {"robot0_eef_pos": (5,), "robot0_gripper_qpos": (2,)}
RGB_KEYS = {"robot0_agentview_image": (32, 32, 3)}
LANG, H, A, B = 768, 4, 12, 8
KZ, KQ, E = 32, 16, 64


def flagship_config(cfg, with_rgb):
    """``__graft_entry__._tiny_config`` on @cfg (the JAX package's or the
    port's ``icl`` config), without the crop randomizer and with dropout 0:
    the dp step refuses per-row draws (each rank would draw its own)."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_KEYS) + (
            ["lang_emb"] if with_rgb else [])
        cfg.observation.modalities.obs.rgb = list(RGB_KEYS) if with_rgb else []
        if with_rgb:
            cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
            cfg.observation.encoder.rgb.core_kwargs = {
                "feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
                "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
                "pool_class": "SpatialSoftmax",
                "pool_kwargs": {"num_kp": 8, "learnable_temperature": False,
                                "temperature": 1.0, "noise_std": 0.0},
            }
            cfg.observation.encoder.rgb.obs_randomizer_class = None
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.embed_dim = True, H, 64
        tc.num_layers, tc.num_heads, tc.causal = 2, 4, False
        tc.supervise_all_steps = tc.pred_future_acs = True
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        tc.vq_vae_enabled = True
        vq = tc.vqvae
        vq.num_subclusters, vq.num_clusters, vq.embed_dim = KZ, KQ, E
        vq.num_stages, vq.num_layers_per_stage, vq.dropout = 1, 2, 0.0
        cfg.train.max_grad_norm = 100.0
        cfg.train.seed = 0
        cfg.train.pallas_pool = with_rgb
    return cfg


def paper_config(cfg):
    """@cfg (``icl_gmm_paper``) at a small size on low-dim keys, LipVQ on,
    dropout 0."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
        cfg.observation.modalities.obs.rgb = []
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = H, 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        tc.vq_vae_enabled = True
        cfg.train.max_grad_norm = 1.0
        cfg.train.seed = 0
    return cfg


def shapes(with_rgb):
    out = dict(OBS_KEYS)
    if with_rgb:
        out.update(RGB_KEYS)
        out["lang_emb"] = (LANG,)
    return out


def make_batch(seed, with_rgb=False, clustered=False, t=2 * H - 1):
    """``__graft_entry__._make_batch``: B rows of a @t-step window."""
    rng = np.random.RandomState(seed)
    obs = {k: rng.randn(B, t, *s).astype(np.float32) for k, s in OBS_KEYS.items()}
    if with_rgb:
        for k, s in RGB_KEYS.items():
            obs[k] = rng.randint(0, 255, (B, t) + s).astype(np.uint8)
        obs["lang_emb"] = rng.randn(B, t, LANG).astype(np.float32)
    if clustered:
        protos = rng.randn(4, t, A).astype(np.float32) * 3.0
        actions = protos[rng.randint(0, 4, size=B)] + 0.01 * rng.randn(B, t, A).astype(
            np.float32)
    else:
        actions = rng.randn(B, t, A).astype(np.float32)
    return {"obs": obs, "actions": actions}


def port_algo(name, cfg_fn, with_rgb, device="cpu"):
    from robot_manipulation_vq_vae_tpu_torch.algo import algo_factory
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils

    cfg = cfg_fn(config_factory(name))
    obs_utils.initialize_obs_utils_with_config(cfg)
    return algo_factory(name, cfg, shapes(with_rgb), A, device=device)


def algo_state(algo):
    """What the tests compare: the networks' state and every optimizer's."""
    return {"nets": {k: v.detach().cpu().clone() for k, v in algo.nets.state_dict().items()},
            "opt": {n: o.state_dict() for n, o in algo.optimizers.items()}}


def steps(algo, batches, mesh=None, halves=False):
    """train_on_batch over @batches, the shards of @mesh when given (the
    paper step's context and supervised halves with @halves; the flagship's
    batches go through process_batch_for_training first). Returns [{loss:
    float}] per step."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    out = []
    for batch in batches:
        if not halves:
            batch = algo.process_batch_for_training(batch)
        if mesh is not None:
            batch = shard_batch(mesh, batch, halves=halves)
        info = algo.train_on_batch(batch, epoch=0)
        out.append({k: float(v) for k, v in info["losses"].items()})
    return out


# ---------------------------------------------------------------------------
# the runs (each rank and the parent test build the same algos from the seed)
# ---------------------------------------------------------------------------


def initialized_vq(algo, seed=4):
    """Give the flagship's HVQVAE an initialized ``vq`` state with counts of
    2 to 5 (no code dies in two steps, so no random draw enters); returns
    it as the JAX collection's numpy arrays."""
    rng = np.random.RandomState(seed)

    def unit(k):
        cb = rng.randn(k, E)
        return (cb / np.linalg.norm(cb, axis=-1, keepdims=True)).astype(np.float32)

    vq = {"codebook_z": unit(KZ), "codebook_q": unit(KQ),
          "cluster_size_z": rng.uniform(2, 5, KZ).astype(np.float32),
          "cluster_size_q": rng.uniform(2, 5, KQ).astype(np.float32),
          "embed_avg_z": rng.randn(KZ, E).astype(np.float32),
          "embed_avg_q": rng.randn(KQ, E).astype(np.float32)}
    model = algo.nets["vqvae"]
    with torch.no_grad():
        for k, v in vq.items():
            getattr(model, k).copy_(torch.from_numpy(v))
        model.codebooks_initialized.fill_(True)
    model._initialized = True
    return {**vq, "initialized": np.asarray(True)}


def legs():
    """{tag: (algo name, config, with_rgb, initialized vq, batches,
    halves)}: the tiny flagship low-dim and with rgb from an initialized vq
    state (the JAX comparison), low-dim from an uninitialized one through a
    clustered batch (the k-means init and the dead-code replacement under
    dp), and the paper step with LipVQ."""
    return {
        "flagship": ("icl", "flagship", False, True,
                     [make_batch(0), make_batch(1)], False),
        "flagship_rgb": ("icl", "flagship", True, True,
                         [make_batch(0, True), make_batch(1, True)], False),
        "flagship_kmeans": ("icl", "flagship", False, False,
                            [make_batch(2), make_batch(3, clustered=True)], False),
        "paper": ("icl_gmm_paper", "paper", False, False,
                  [make_batch(4, t=H), make_batch(5, t=H)], True),
    }


def leg_algo(name, cfg_name, with_rgb, init_vq, device="cpu"):
    cfg_fn = {"flagship": lambda c: flagship_config(c, with_rgb),
              "paper": paper_config}[cfg_name]
    algo = port_algo(name, cfg_fn, with_rgb, device)
    vq = initialized_vq(algo) if init_vq else None
    return algo, vq


def gpt_backbone():
    from robot_manipulation_vq_vae_tpu_torch.models.transformers import GPT_Backbone

    torch.manual_seed(0)
    return GPT_Backbone(32, 4, causal=True, attn_dropout=0.0, block_output_dropout=0.0,
                        num_layers=2, num_heads=4)


def gpt_input():
    return torch.from_numpy(np.random.RandomState(1).randn(2, 4, 32).astype(np.float32))


def lipvq_model():
    from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import LipVQVAE

    torch.manual_seed(0)
    return LipVQVAE(6, 16, num_codes=8)


def lipvq_input():
    return torch.from_numpy(np.random.RandomState(0).randn(16, 6).astype(np.float32))


def lipvq_step(model, x, comm=None):
    """test_parallel's LipVQ step: one Adam step (lr 1e-3); under @comm
    (the dp axis) on this rank's rows with the gradients averaged."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    _, loss = model(x)
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    loss = loss.detach().reshape(1)
    if comm is not None:
        comm.mean_(grads)
        comm.mean_([loss])
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    opt.step()
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


def _refusal(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def refusals(mesh):
    """What shard_state and train_on_batch refuse under dp > 1."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    def flagship(**train):
        def cfg(c):
            c = flagship_config(c, False)
            with c.values_unlocked():
                for k, v in train.items():
                    c.train[k] = v
            return c
        return port_algo("icl", cfg, False)

    def dropout_flagship():
        def cfg(c):
            c = flagship_config(c, False)
            with c.values_unlocked():
                c.algo.transformer.attn_dropout = 0.1
            return c
        return port_algo("icl", cfg, False)

    def bin_paper():
        def cfg(c):
            c = paper_config(c)
            with c.values_unlocked():
                c.algo.transformer.vq_vae_enabled = False
                c.algo.transformer.bin_enabled = True
            return c
        return port_algo("icl_gmm_paper", cfg, False)

    def bc():
        def cfg(c):
            with c.values_unlocked():
                c.observation.modalities.obs.low_dim = list(OBS_KEYS)
            return c
        return port_algo("bc", cfg, False)

    def unsharded_batch():
        algo = shard_state(mesh, flagship())
        algo.train_on_batch(algo.process_batch_for_training(make_batch(0)), epoch=0)

    return {
        "bc": _refusal(lambda: shard_state(mesh, bc())),
        "dropout": _refusal(lambda: shard_state(mesh, dropout_flagship())),
        "bin": _refusal(lambda: shard_state(mesh, bin_paper())),
        "mixed_precision": _refusal(lambda: shard_state(mesh, flagship(mixed_precision=True))),
        "unsharded_batch": _refusal(unsharded_batch),
    }


def job_all(rank, world, work):
    """Everything a rank of a @world-rank group runs: the ('dp', 'mp')
    mesh at mp = 2, the GPT under mp = 2 (world 2), the LipVQ step and the
    algo legs under dp = world, and the refusals."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import (
        AxisComm,
        make_mesh,
        shard_batch,
        shard_params,
        shard_state,
    )

    out = {}
    mesh = make_mesh(mp=2)
    out["mesh"] = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
                   "coord": (mesh.get_local_rank("dp"), mesh.get_local_rank("mp"))}
    if world == 2:
        model = shard_params(mesh, gpt_backbone())
        with torch.no_grad():
            gpt_out = model(gpt_input())
        out["gpt"] = {
            "placements": {n: [(type(pl).__name__, getattr(pl, "dim", None))
                                for pl in p.placements]
                           for n, p in model.named_parameters()},
            "local": {n: tuple(p.to_local().shape) for n, p in model.named_parameters()},
            "out": gpt_out}
    dp_mesh = make_mesh()
    comm = AxisComm(dp_mesh)
    out["lipvq"] = lipvq_step(lipvq_model(),
                              shard_batch(dp_mesh, {"x": lipvq_input()})["x"], comm)
    for tag, (name, cfg_name, with_rgb, init_vq, batches, halves) in legs().items():
        algo, _ = leg_algo(name, cfg_name, with_rgb, init_vq)
        shard_state(dp_mesh, algo)
        out[tag] = {"losses": steps(algo, batches, dp_mesh, halves), **algo_state(algo)}
    out["refusals"] = refusals(dp_mesh)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, work, job, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'rdv')}",
                            world_size=world, rank=rank)
    try:
        result = job(rank, world, work, *args)
        torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(job, world, work, *args):
    """Start @world ranks of @job on gloo; returns ``results()``, which waits
    for them and gives their results in rank order."""
    work = str(work)
    os.makedirs(work, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, work, job, args), nprocs=world,
                             join=False, start_method="spawn")

    def results():
        while not ctx.join():
            pass
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return results
