"""Ranks of the port's mesh tests (tests/test_torch_mesh.py): each runs in a
spawned process on ``gloo`` with a ``file://`` rendezvous, so it imports
only PyTorch and the port (no JAX: a spawned rank must not load it).

``start_ranks(job, world, work, *args)`` starts @world ranks of
``job(rank, world, work, *args)``; what it returns waits for them and gives
the ranks' results (each saved with ``torch.save`` under @work). The
configurations, models and batches are shared with the parent test, which
builds the same algos from the same seed, unsharded, and the JAX package's
from their weights."""

import gc
import hashlib
import os
import time

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


# the randomizers of the draw legs: __graft_entry__._tiny_config's crop, or
# the color jitter followed by Gaussian noise
RANDOMIZERS = {
    "crop": (["CropRandomizer"], [{"crop_height": 28, "crop_width": 28, "num_crops": 1,
                                   "pos_enc": False}]),
    "jitter": (["ColorRandomizer", "GaussianNoiseRandomizer"], [{}, {"noise_std": 0.1}]),
}


def flagship_config(cfg, with_rgb, draws=None):
    """``__graft_entry__._tiny_config`` on @cfg (the JAX package's or the
    port's ``icl`` config). Without @draws: no randomizer, dropout 0 and no
    keypoint noise (the JAX comparisons: JAX's draws differ). With @draws
    ("crop" or "jitter", ``RANDOMIZERS``): dropout 0.1 everywhere
    ``_tiny_config`` keeps icl's default (the GPT's three and the
    HVQVAE's), SpatialSoftmax's keypoint noise 0.1 and those randomizers."""
    p = 0.1 if draws else 0.0
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
                                "temperature": 1.0, "noise_std": p},
            }
            classes, kwargs = RANDOMIZERS[draws] if draws else (None, None)
            cfg.observation.encoder.rgb.obs_randomizer_class = classes
            if draws:
                cfg.observation.encoder.rgb.obs_randomizer_kwargs = kwargs
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.embed_dim = True, H, 64
        tc.num_layers, tc.num_heads, tc.causal = 2, 4, False
        tc.supervise_all_steps = tc.pred_future_acs = True
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = p
        tc.vq_vae_enabled = True
        vq = tc.vqvae
        vq.num_subclusters, vq.num_clusters, vq.embed_dim = KZ, KQ, E
        vq.num_stages, vq.num_layers_per_stage, vq.dropout = 1, 2, p
        cfg.train.max_grad_norm = 100.0
        cfg.train.seed = 0
        cfg.train.pallas_pool = with_rgb
    return cfg


def paper_config(cfg, draws=None):
    """@cfg (``icl_gmm_paper``) at a small size on low-dim keys, LipVQ on,
    dropout 0; with @draws its dropout 0.1 (``icl_gmm_paper.json``'s)."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
        cfg.observation.modalities.obs.rgb = []
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = H, 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = (
            0.1 if draws else 0.0)
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
    """What the tests compare: the networks' state and every optimizer's,
    whole (under mp the shards gathered: every rank calls it)."""
    from robot_manipulation_vq_vae_tpu_torch.algo.algo import _to_cpu

    return {"nets": {k: algo._full(v).detach().cpu().clone()
                     for k, v in algo.nets.state_dict().items()},
            "opt": {n: _to_cpu(o.state_dict(), algo._full)
                    for n, o in algo.optimizers.items()}}


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


def leg_algo(name, cfg_name, with_rgb, init_vq, device="cpu", draws=None):
    cfg_fn = {"flagship": lambda c: flagship_config(c, with_rgb, draws),
              "paper": lambda c: paper_config(c, draws)}[cfg_name]
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


def refusals(mesh, mp_mesh):
    """What shard_state and train_on_batch say (None: admitted; else the
    error): under @mp_mesh's mp > 1 the bf16 step, a bc policy, the paper
    with the bin tokenizer, offline RL, the hierarchical family, the MCR
    policies and MCR pretraining (the last four under dp > 1 too,
    ``<case>_dp``), all admitted; and refused: a batch that is not a shard,
    an object of no covered class, and a GPT whose qkv rows mp does not
    divide."""
    from types import SimpleNamespace

    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import MCRPretrainer
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    def low_dim(c):
        with c.values_unlocked():
            _low_dim(c)
        return c

    def flagship(**train):
        def cfg(c):
            c = flagship_config(c, False)
            with c.values_unlocked():
                for k, v in train.items():
                    c.train[k] = v
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

    def unsharded_batch():
        algo = shard_state(mesh, flagship())
        algo.train_on_batch(algo.process_batch_for_training(make_batch(0)), epoch=0)

    def odd_gpt():   # qkv [45, 15]: 45 rows, mp = 2
        def cfg(c):
            c = icl_family_config(c, "transformer_gmm")
            with c.values_unlocked():
                c.algo.transformer.embed_dim, c.algo.transformer.num_heads = 15, 3
            return c
        return port_algo("bc", cfg, False)

    families = {
        "iql": lambda: port_algo("iql", low_dim, False),
        "gl": lambda: port_algo("gl", low_dim, False),
        "mcr": lambda: port_algo("mcr", low_dim, False),
        "mcr_pretrain": lambda: MCRPretrainer(torch.nn.Linear(2, 2), device="cpu"),
    }
    return {
        **{case: _refusal(lambda make=make: shard_state(mp_mesh, make()))
           for case, make in families.items()},
        **{f"{case}_dp": _refusal(lambda make=make: shard_state(mesh, make()))
           for case, make in families.items()},
        "bc_mp": _refusal(lambda: shard_state(mp_mesh, port_algo("bc", low_dim, False))),
        "bin_mp": _refusal(lambda: shard_state(mp_mesh, bin_paper())),
        "mixed_precision_mp": _refusal(
            lambda: shard_state(mp_mesh, flagship(mixed_precision=True))),
        "unsharded_batch": _refusal(unsharded_batch),
        "not_covered": _refusal(lambda: shard_state(
            mp_mesh, SimpleNamespace(device=torch.device("cpu")))),
        "undivisible_mp": _refusal(lambda: shard_state(mp_mesh, odd_gpt())),
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
        out["gpt"] = {   # a replicated parameter is a plain tensor
            "placements": {n: [(type(pl).__name__, getattr(pl, "dim", None))
                                for pl in p.placements] if hasattr(p, "placements")
                           else [("Replicate", None)]
                           for n, p in model.named_parameters()},
            "local": {n: tuple((p.to_local() if hasattr(p, "to_local") else p).shape)
                      for n, p in model.named_parameters()},
            "out": gpt_out}
    dp_mesh = make_mesh()
    comm = AxisComm(dp_mesh)
    out["lipvq"] = lipvq_step(lipvq_model(),
                              shard_batch(dp_mesh, {"x": lipvq_input()})["x"], comm)
    for tag, (name, cfg_name, with_rgb, init_vq, batches, halves) in legs().items():
        algo, _ = leg_algo(name, cfg_name, with_rgb, init_vq)
        shard_state(dp_mesh, algo)
        out[tag] = {"losses": steps(algo, batches, dp_mesh, halves), **algo_state(algo)}
    out["refusals"] = refusals(dp_mesh, mesh)
    return out


# ---------------------------------------------------------------------------
# the draws under dp and the GPT under mp (tests/test_torch_mesh_draws.py,
# tests/test_torch_mesh_mp.py)
# ---------------------------------------------------------------------------


def draw_legs():
    """{tag: (algo name, config, with_rgb, initialized vq, batches, halves,
    draws)}: the tiny flagship with rgb behind the crop, and behind the
    color jitter and Gaussian noise (both with dropout 0.1 and keypoint
    noise), and the paper step with its dropout."""
    rgb = [make_batch(0, True), make_batch(1, True)]
    return {
        "flagship_crop": ("icl", "flagship", True, True, rgb, False, "crop"),
        "flagship_jitter": ("icl", "flagship", True, True, rgb, False, "jitter"),
        "paper": ("icl_gmm_paper", "paper", False, False,
                  [make_batch(4, t=H), make_batch(5, t=H)], True, True),
    }


def mp_legs():
    """The tiny flagship with rgb under mp: with the crop leg's draws, and
    without draws (``legs()["flagship_rgb"]``, the JAX comparison)."""
    rgb = [make_batch(0, True), make_batch(1, True)]
    return {"draws": ("icl", "flagship", True, True, rgb, False, "crop"),
            "plain": ("icl", "flagship", True, True, rgb, False, None)}


def request(with_rgb):
    """A B-row request: (observations [B, H, ...], context batch)."""
    obs = make_batch(7, with_rgb, t=H)["obs"]
    ctx = make_batch(8, with_rgb, t=H)
    return obs, {"obs": ctx["obs"], "actions": ctx["actions"]}


def serve(algo, with_rgb, mesh=None):
    """get_action on ``request``: this rank's shards under a dp @mesh; the
    global batch's actions."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    obs, ctx = request(with_rgb)
    if mesh is not None:
        obs, ctx = shard_batch(mesh, obs), shard_batch(mesh, ctx)
    return algo.get_action(obs, ctx).detach().cpu().clone()


def digest(state):
    """Each tensor of an ``algo_state``'s networks as a hash of its bytes:
    what the ranks after the first keep (their states are compared with
    rank 0's to the bit; whole states of every rank would take gigabytes)."""
    return {k: hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in state["nets"].items()}


def keep_state(res, rank):
    """@res with its whole state at rank 0, its ``digest`` elsewhere."""
    if rank:
        res["digest"] = digest(res)
        del res["nets"], res["opt"]
    return res


def run_leg(leg, mesh, dp_mesh):
    """A leg's algo put under @mesh, its steps on @dp_mesh's shards (None:
    whole batches) and a request after them."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    name, cfg_name, with_rgb, init_vq, batches, halves, draws = leg
    algo, _ = leg_algo(name, cfg_name, with_rgb, init_vq, draws=draws)
    if mesh is not None:
        shard_state(mesh, algo)
    losses = steps(algo, batches, dp_mesh, halves)
    return algo, {"losses": losses, **algo_state(algo),
                  "action": serve(algo, with_rgb, dp_mesh)}


def job_draws(rank, world, work):
    """dp = @world: each draw leg's two steps and a request after them, and
    the draw-free flagship's request from its initial weights."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state

    mesh = make_mesh()
    out = {tag: keep_state(run_leg(leg, mesh, mesh)[1], rank)
           for tag, leg in draw_legs().items()}
    algo, _ = leg_algo("icl", "flagship", True, True)
    out["serve_initial"] = serve(shard_state(mesh, algo), True, mesh)
    return out


def _count_optimizer_comms(algo):
    """Wrap each optimizer's step to count the collectives it issues
    (``CommDebugMode``); returns the list the counts go to."""
    from torch.distributed.tensor.debug import CommDebugMode

    counts = []
    for opt in algo.optimizers.values():
        def counted(*args, _step=opt.step, **kwargs):
            with CommDebugMode() as comm:
                result = _step(*args, **kwargs)
            counts.append(comm.get_total_counts())
            return result
        opt.step = counted
    return counts


def kernel_guards(mesh):
    """Each kernel wrapper given a DTensor: {wrapper: the error}."""
    from torch.distributed.tensor import DTensor, Replicate

    from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel, pool, stem_pool

    def dt(*shape, dtype=torch.float32):
        return DTensor.from_local(torch.zeros(shape, dtype=dtype), mesh["mp"], [Replicate()],
                                  run_check=False)

    w = ((dt(4, 4), dt(4)), (dt(4, 4), dt(4)))
    calls = {
        "pool_fwd_cuda": lambda: stem_pool.pool_fwd_cuda(dt(1, 2, 8, 8)),
        "pool_bwd_cuda": lambda: stem_pool.pool_bwd_cuda(dt(1, 2, 4, 4, dtype=torch.int8),
                                                         dt(1, 2, 4, 4), (8, 8)),
        "l2_nearest_cuda": lambda: lipvq_kernel.l2_nearest_cuda(dt(4, 4), dt(8, 4)),
        "lipvq_roundtrip_cuda": lambda: lipvq_kernel.lipvq_roundtrip_cuda(
            dt(4, 4), w, (dt(4, 4), dt(4)), dt(8, 4), w + ((dt(4, 4), dt(4)),)),
        "pool_route_cuda": lambda: pool.pool_route_cuda(dt(1, 2, 8, 8), dt(1, 2, 4, 4),
                                                        dt(1, 2, 4, 4)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as err:
            out[name] = str(err)
    return out


def _largest_gap(a, b):
    """The largest |a - b| over two ``algo_state``s' tensors."""
    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k])
        elif isinstance(tree, torch.Tensor):
            yield tree

    gaps = [float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
            for x, y in zip(leaves({"n": a["nets"], "o": a["opt"]}),
                            leaves({"n": b["nets"], "o": b["opt"]}))]
    return max(gaps)


def job_mp(rank, world, work):
    """The meshes (1, 2) at world 2, (2, 2) and (1, 4) at world 4: each mp
    leg's two steps (the optimizers' collectives counted), a request after
    them (its collectives counted too: ``CommDebugMode`` sees the mesh's),
    and ``serialize`` (every rank calls it; rank 0 keeps it), which the
    draw leg loads into a fresh mp algo and serves again; the kernel
    wrappers given DTensors (world 2)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state
    from robot_manipulation_vq_vae_tpu_torch.utils.tensor_parallel import local

    out = {}
    for mp in ((2,) if world == 2 else (2, 4)):
        mesh = make_mesh(mp=mp, device="cpu")
        dp_mesh = mesh if world // mp > 1 else None
        for tag, leg in mp_legs().items():
            name, cfg_name, with_rgb, init_vq, batches, halves, draws = leg
            algo, _ = leg_algo(name, cfg_name, with_rgb, init_vq, draws=draws)
            shard_state(mesh, algo)
            opt_comms = _count_optimizer_comms(algo)
            losses = steps(algo, batches, dp_mesh, halves)
            with CommDebugMode() as comm:
                action = serve(algo, with_rgb, dp_mesh)
            res = {"losses": losses, "opt_comms": opt_comms,
                   "foreach": [g["foreach"] for g in algo.optimizers["policy"].param_groups],
                   "serve_comms": comm.get_total_counts(), "action": action,
                   "devices": sorted({local(p).device.type for p in algo.nets.parameters()}
                                     | {mesh.device_type}),
                   "placements": {n: [type(pl).__name__ for pl in p.placements]
                                  for n, p in algo.nets.named_parameters()
                                  if hasattr(p, "placements")}}
            state = algo_state(algo)
            ser = algo.serialize(include_optimizer=True)
            # rank 0 keeps the whole state once, as serialize wrote it
            res.update({"serialized": ser} if rank == 0 else {"digest": digest(state)})
            if draws:
                # the whole tensors placed again in a fresh mp algo: its
                # state's largest gap from the trained one's, and a request
                again, _ = leg_algo(name, cfg_name, with_rgb, init_vq, draws=draws)
                shard_state(mesh, again)
                again.deserialize(ser)
                res["reloaded"] = {"action": serve(again, with_rgb, dp_mesh),
                                   "gap": _largest_gap(algo_state(again), state)}
                del again
            out[(world // mp, mp, tag)] = res
            del algo, state, ser   # a rank holds one leg's states at a time
            gc.collect()
        if world == 2:
            out["guards"] = kernel_guards(mesh)
    return out


# ---------------------------------------------------------------------------
# the policy families under dp (tests/test_torch_mesh_families.py)
# ---------------------------------------------------------------------------

# a second camera for the packed trunks (which need two)
RGB2_KEYS = {**RGB_KEYS, "robot0_eye_in_hand_image": (32, 32, 3)}
FAM_T, FAM_TP = 3, 8          # the MLP / RNN / ACT windows; the diffusion Tp
# the diffusion policy's training draws and a DDPM request's draws, injected
# at the global batch's shape by the hooks leg (2 inference steps)
FAM_DDPM_STEPS = 2


def _low_dim(cfg):
    cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
    cfg.observation.modalities.obs.rgb = []


def _train_common(cfg, half):
    """A clip limit below the gradient norms, the seed, @half (mixed
    precision); the templates' own learning rates."""
    cfg.train.max_grad_norm = 0.5
    cfg.train.seed = 0
    cfg.train.mixed_precision = half


def icl_family_config(cfg, mode):
    """@cfg (``icl`` or ``bc``) as the MLP, RNN, VAE or transformer policy
    of @mode at a small size on the low-dim keys, dropout 0."""
    with cfg.values_unlocked():
        _low_dim(cfg)
        a = cfg.algo
        tx = a.transformer
        tx.enabled = mode.startswith("transformer")
        tx.ln_act_enabled = tx.vq_vae_enabled = False
        tx.context_length, tx.embed_dim, tx.num_layers, tx.num_heads = H, 16, 1, 2
        tx.emb_dropout = tx.attn_dropout = tx.block_output_dropout = 0.0
        tx.supervise_all_steps, tx.pred_future_acs = True, False
        a.gaussian.enabled = mode == "gaussian"
        a.gmm.enabled = mode in ("gmm", "rnn_gmm", "transformer_gmm")
        a.gmm.num_modes = 3
        a.rnn.enabled = mode in ("rnn", "rnn_gmm")
        a.rnn.horizon, a.rnn.hidden_dim, a.rnn.num_layers = FAM_T, 10, 2
        a.actor_layer_dims = [] if mode.startswith("rnn") else [16, 16]
        if "vae" in a:
            a.vae.enabled = mode.startswith("vae")
            a.vae.latent_dim = 4
            a.vae.encoder_layer_dims = a.vae.decoder_layer_dims = [16]
            a.vae.prior_layer_dims = [16]
            if mode == "vae_gmm_prior":
                for k, v in {"learn": True, "is_conditioned": True, "use_gmm": True,
                             "gmm_num_modes": 3, "gmm_learn_weights": True}.items():
                    a.vae.prior[k] = v
            if mode == "vae_categorical":
                for k, v in {"use_categorical": True, "categorical_dim": 3,
                             "categorical_gumbel_softmax_hard": True}.items():
                    a.vae.prior[k] = v
        a.loss.l1_weight, a.loss.cos_weight = 0.5, 0.25
        _train_common(cfg, False)
        cfg.train.seq_length = FAM_T
    return cfg


def paper_modality_config(cfg, modality, half=False):
    """``paper_config`` with @modality's tokenizer ("lipvq", "bin",
    "ln_act", "fast" or "default"); the default encoder keeps its fixed
    dropout 0.1, drawn from the algo's generator."""
    cfg = paper_config(cfg)
    with cfg.values_unlocked():
        tc = cfg.algo.transformer
        tc.vq_vae_enabled = modality == "lipvq"
        for flag in ("bin", "ln_act", "fast"):
            tc[f"{flag}_enabled"] = modality == flag
        cfg.train.mixed_precision = half
    return cfg


def mamba_config(cfg, gmm, half=False):
    """``icl_mamba`` at a small size: ICLMamba_GMM with LipVQ (@gmm), else
    ICLMambaHVQVAE with a small HVQVAE (dropout 0)."""
    with cfg.values_unlocked():
        _low_dim(cfg)
        mc = cfg.algo.mamba
        mc.context_length, mc.embed_dim, mc.num_layers, mc.num_heads = H, 32, 1, 4
        mc.emb_dropout = mc.attn_dropout = mc.block_output_dropout = 0.0
        mc.vq_vae_enabled, mc.ln_act_enabled = True, False
        mc.supervise_all_steps = True
        cfg.algo.gmm.enabled = gmm
        if not gmm:
            mc.pred_future_acs = True
            vq = mc.vqvae
            vq.embed_dim, vq.num_subclusters, vq.num_clusters = E, KZ, KQ
            vq.num_stages, vq.num_layers_per_stage, vq.dropout = 1, 2, 0.0
        cfg.train.max_grad_norm = 1.0
        cfg.train.seed = 0
        cfg.train.mixed_precision = half
    return cfg


def diffusion_config(cfg, half=False, ddim=True):
    with cfg.values_unlocked():
        _low_dim(cfg)
        a = cfg.algo
        a.horizon.observation_horizon, a.horizon.prediction_horizon = 2, FAM_TP
        a.unet.down_dims, a.unet.diffusion_step_embed_dim, a.unet.n_groups = [16, 32], 16, 4
        a.ddpm.enabled, a.ddim.enabled = not ddim, ddim
        a.ddpm.num_inference_timesteps = a.ddim.num_inference_timesteps = FAM_DDPM_STEPS
        _train_common(cfg, half)
        cfg.train.seq_length = FAM_TP
    return cfg


def act_config(cfg):
    with cfg.values_unlocked():
        _low_dim(cfg)
        act = cfg.algo.act
        act.hidden_dim, act.dim_feedforward, act.nheads = 32, 64, 2
        act.enc_layers, act.dec_layers, act.latent_dim = 1, 1, 8
        _train_common(cfg, False)
        cfg.train.seq_length = FAM_T
    return cfg


def flagship_bf16_config(cfg, packed):
    """The tiny flagship with rgb (``flagship_config``, draw-free) under
    ``train.mixed_precision``; with @packed two cameras in the packed
    trunks."""
    cfg = flagship_config(cfg, True)
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
        if packed:
            cfg.observation.modalities.obs.rgb = list(RGB2_KEYS)
            cfg.train.packed_rgb_encoders = True
    return cfg


def family_batch(seed, t, keys=None, bounded=False, b=B):
    """B rows of a @t-step window over @keys (``OBS_KEYS``; images uint8,
    ``lang_emb`` 768 floats); actions in [-1, 1] with @bounded."""
    rng = np.random.RandomState(seed)
    obs = {}
    for k, shape in (keys or OBS_KEYS).items():
        if len(shape) == 3:
            obs[k] = rng.randint(0, 255, (b, t) + shape).astype(np.uint8)
        else:
            obs[k] = rng.randn(b, t, *shape).astype(np.float32)
    actions = rng.randn(b, t, A).astype(np.float32)
    if bounded:
        actions = np.tanh(actions)
    return {"obs": obs, "actions": actions}


# tag: (algo name, configure, obs key shapes, window, halves, request kind,
# dp worlds, bf16). A leg's steps take two batches of ``window`` steps; its
# request is ``family_request``'s @kind. dp = 4 where the step couples rows
# (BatchNorm, packed BatchNorm, bin's min / max, the default encoder).
_RGB = {**OBS_KEYS, **RGB_KEYS, "lang_emb": (LANG,)}
_RGB2 = {**OBS_KEYS, **RGB2_KEYS, "lang_emb": (LANG,)}
FAMILY_LEGS = {
    "flagship_bf16": ("icl", lambda c: flagship_bf16_config(c, False), _RGB, 2 * H - 1,
                      False, "context", (2, 4), True),
    "flagship_packed_bf16": ("icl", lambda c: flagship_bf16_config(c, True), _RGB2,
                             2 * H - 1, False, "context", (2, 4), True),
    "paper_lipvq_bf16": ("icl_gmm_paper", lambda c: paper_modality_config(c, "lipvq", True),
                         OBS_KEYS, H, True, "context", (2,), True),
    "paper_bin": ("icl_gmm_paper", lambda c: paper_modality_config(c, "bin"), OBS_KEYS, H,
                  True, "context", (2, 4), False),
    "paper_ln_act": ("icl_gmm_paper", lambda c: paper_modality_config(c, "ln_act"),
                     OBS_KEYS, H, True, "context", (2,), False),
    "paper_default": ("icl_gmm_paper", lambda c: paper_modality_config(c, "default"),
                      OBS_KEYS, H, True, "context", (2, 4), False),
    "paper_fast": ("icl_gmm_paper", lambda c: paper_modality_config(c, "fast"), OBS_KEYS,
                   H, True, "context", (2,), False),
    "mamba_gmm": ("icl_mamba", lambda c: mamba_config(c, True), OBS_KEYS, H, True,
                  "context", (2,), False),
    "mamba_gmm_bf16": ("icl_mamba", lambda c: mamba_config(c, True, True), OBS_KEYS, H,
                       True, "context", (2,), True),
    "mamba_hvqvae": ("icl_mamba", lambda c: mamba_config(c, False), OBS_KEYS, 2 * H - 1,
                     False, "context", (2,), False),
    "icl": ("icl", lambda c: icl_family_config(c, "plain"), OBS_KEYS, FAM_T, False, "obs",
            (2,), False),
    "icl_gaussian": ("icl", lambda c: icl_family_config(c, "gaussian"), OBS_KEYS, FAM_T,
                     False, "obs", (2,), False),
    "icl_gmm": ("icl", lambda c: icl_family_config(c, "gmm"), OBS_KEYS, FAM_T, False, "obs",
                (2,), False),
    "icl_rnn": ("icl", lambda c: icl_family_config(c, "rnn"), OBS_KEYS, FAM_T, False, "rnn",
                (2,), False),
    "icl_rnn_gmm": ("icl", lambda c: icl_family_config(c, "rnn_gmm"), OBS_KEYS, FAM_T,
                    False, "rnn", (2,), False),
    "bc_rnn_gmm": ("bc", lambda c: icl_family_config(c, "rnn_gmm"), OBS_KEYS, FAM_T, False,
                   "rnn", (2,), False),
    "bc_vae": ("bc", lambda c: icl_family_config(c, "vae"), OBS_KEYS, FAM_T, False, "obs",
               (2,), False),
    "bc_vae_gmm_prior": ("bc", lambda c: icl_family_config(c, "vae_gmm_prior"), OBS_KEYS,
                         FAM_T, False, "obs", (2,), False),
    "bc_vae_categorical": ("bc", lambda c: icl_family_config(c, "vae_categorical"),
                           OBS_KEYS, FAM_T, False, "obs", (2,), False),
    "bc_transformer": ("bc", lambda c: icl_family_config(c, "transformer"), OBS_KEYS, H,
                       False, "window", (2,), False),
    "bc_transformer_gmm": ("bc", lambda c: icl_family_config(c, "transformer_gmm"),
                           OBS_KEYS, H, False, "window", (2,), False),
    "diffusion": ("diffusion_policy", diffusion_config, OBS_KEYS, FAM_TP, False,
                  "diffusion", (2,), False),
    "diffusion_bf16": ("diffusion_policy", lambda c: diffusion_config(c, True), OBS_KEYS,
                       FAM_TP, False, "diffusion", (2,), True),
    "diffusion_ddpm_hooks": ("diffusion_policy", lambda c: diffusion_config(c, ddim=False),
                             OBS_KEYS, FAM_TP, False, "diffusion", (2,), False),
    "act": ("act", act_config, OBS_KEYS, FAM_T, False, "act", (2,), False),
}


def family_legs(world=None):
    """``FAMILY_LEGS`` (those run at dp = @world, where given)."""
    return {tag: leg for tag, leg in FAMILY_LEGS.items() if world is None or world in leg[6]}


def family_algo(tag, device="cpu", legs=None):
    """The leg's port algo from the seed; FAST on ``chip_smoke``'s
    stand-ins; the hooks leg's draws injected (``family_hooks``)."""
    from robot_manipulation_vq_vae_tpu_torch.algo import algo_factory
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils

    name, configure, keys = (legs or FAMILY_LEGS)[tag][:3]
    cfg = configure(config_factory(name))
    obs_utils.initialize_obs_utils_with_config(cfg)
    algo = algo_factory(name, cfg, dict(keys), A, device=device)
    if tag == "paper_fast":
        from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import FastHostEncoder
        from chip_smoke import SmokeFastProcessor, smoke_clip_encode

        algo.set_fast_tokenizer(FastHostEncoder.from_components(SmokeFastProcessor(),
                                                                smoke_clip_encode))
    if tag == "diffusion_ddpm_hooks":
        family_hooks(algo)
    if tag == "act_pinned":
        algo._noise_hook = act_noise
    if "vqvae" in algo.nets:
        initialized_vq(algo)   # no k-means draw: JAX's oracle starts from it too
    return algo


def family_hooks(algo):
    """The diffusion policy's training and request draws injected at the
    global batch's shape: a step's (timesteps [B], noise [B, Tp, A]) and a
    request's (initial noise [B, Tp, A], the DDPM noises [n, B, Tp, A]),
    from a seeded numpy stream that every rank and the unsharded run share."""
    rng = np.random.RandomState(11)
    algo._noise_hook = lambda: (rng.randint(0, 100, (B,)),
                                rng.randn(B, FAM_TP, A).astype(np.float32))
    algo._sample_hook = lambda: (rng.randn(B, FAM_TP, A).astype(np.float32),
                                 rng.randn(FAM_DDPM_STEPS, B, FAM_TP, A).astype(np.float32))


def family_batches(tag, legs=None):
    keys, t = (legs or FAMILY_LEGS)[tag][2:4]
    return [family_batch(20 + i, t, keys, bounded=tag.startswith("diffusion"))
            for i in range(2)]


def family_request(algo, kind, keys, mesh=None):
    """The request of @kind on @algo (this rank's shards under a dp @mesh):
    "context" ``request``'s B rows with their context batch; "window" B
    windows of H steps; "obs" B observations; "diffusion" B windows of 2
    frames; "rnn" FAM_T stepwise calls after ``reset``; "act" FAM_T + 1
    calls after ``reset`` (a chunk, then the next one predicted). Returns
    the global batch's actions of every call, stacked [calls, B, A]."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    def cut(d):
        return d if mesh is None else shard_batch(mesh, d)

    if kind == "context":
        obs = family_batch(7, H, keys)["obs"]
        ctx = family_batch(8, H, keys)
        calls = [lambda: algo.get_action(cut(obs), cut({"obs": ctx["obs"],
                                                           "actions": ctx["actions"]}))]
    elif kind in ("window", "diffusion", "obs"):
        obs = family_batch(7, H if kind == "window" else 2, keys)["obs"]
        if kind == "obs":
            obs = {k: v[:, 0] for k, v in obs.items()}
        calls = [lambda: algo.get_action(cut(obs))]
    else:
        algo.reset()
        n = FAM_T + 1 if kind == "act" else FAM_T
        obs = family_batch(7, n, keys)["obs"]
        calls = [lambda i=i: algo.get_action(cut({k: v[:, i] for k, v in obs.items()}))
                 for i in range(n)]
    return torch.stack([call().detach().cpu().clone() for call in calls])


def family_state(algo, half):
    """``algo_state`` and, for a bf16 leg, every parameter's last gradient
    (the averaged, clipped one the optimizer stepped), the parameters'
    names and each optimizer's in its state's order."""
    out = algo_state(algo)
    if half:
        name_of = {id(p): n for n, p in algo.nets.named_parameters()}
        out["grads"] = {n: algo._full(p.grad).detach().cpu().clone()
                        for n, p in algo.nets.named_parameters() if p.grad is not None}
        out["params"] = list(name_of.values())
        out["opt_params"] = {name: [name_of[id(p)] for g in opt.param_groups
                                    for p in g["params"]]
                             for name, opt in algo.optimizers.items()}
    return out


def run_family_leg(tag, mesh=None, device="cpu"):
    """A leg's algo on @device (under @mesh when given), its two steps (on
    @mesh's shards) and its request after them."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    _, _, keys, _, halves, kind, _, half = FAMILY_LEGS[tag]
    algo = family_algo(tag, device)
    if mesh is not None:
        shard_state(mesh, algo)
    losses = steps(algo, family_batches(tag), mesh, halves)
    return {"losses": losses, **family_state(algo, half),
            "action": family_request(algo, kind, keys, mesh)}


# bf16 legs (``check_half_leg``): gradient tensors whose bf16 terms cancel
# (a LayerNorm bias summed over every token, each rank's sum rounded before
# the average), held at 1e-2 of the network's largest gradient instead of
# their own (measured on the CPU: 1.5 % of its own largest, which is 0.31 of
# the network's)
HALF_CANCELLING = {"mamba_gmm_bf16": ("policy.net.embedding.embed_ln.bias",)}
# parameters where an element whose gradient is bf16 noise may lie beyond
# test_parallel.py's bound by Adam's step (lr a step, its sign rounded
# apart); the check shows that gradient near zero: every Adam first moment
# of such an element within 1e-2 of its tensor's largest (measured on the
# CPU: 2 of LipVQ's 8,192 decoder weights 1.0e-3 apart at AdamW's lr 1e-3,
# their first moments 1.3e-3 of the tensor's largest)
_LIPVQ_OUT = ("policy.net.encoder.action_network.decoder.2.weight",
              "policy.net.encoder.action_network.decoder.2.bias")
HALF_SIGN_NOISE = {"paper_lipvq_bf16": _LIPVQ_OUT, "mamba_gmm_bf16": _LIPVQ_OUT}


def _moments_by_name(state):
    """{parameter name: [(exp_avg, exp_avg_sq) of each optimizer holding
    it]} from a bf16 leg's ``family_state``."""
    out = {}
    for opt_name, names in state["opt_params"].items():
        for i, st in state["opt"][opt_name]["state"].items():
            if "exp_avg" in st:
                out.setdefault(names[i], []).append((st["exp_avg"], st["exp_avg_sq"]))
    return out


def check_half_leg(res, ref, tag, msg, vq_by_mass=False):
    """A bf16 leg @res against the unsharded @ref (``run_family_leg``'s):
    metrics 1e-3 relative; each last
    gradient within 1e-2 of its tensor's largest (``HALF_CANCELLING``: of the
    network's), all of them as one vector within 1e-2 of their norm; every
    Adam moment within test_parallel.py's 5e-4 + 1e-2 |v| and, per tensor,
    the first within 1e-2 and the second within 2e-2 of its tensor's largest
    (``HALF_CANCELLING``: of the network's); the weights within 5e-4 + 1e-2
    |v| (``HALF_SIGN_NOISE``: beyond only where the moments show a gradient
    near zero); buffers 1e-4, of BatchNorm's statistics at most 1 % further,
    all within 5e-4 + 1e-2 |v|. With @vq_by_mass the HVQVAE's codebooks are
    held by their EMA's total mass (which code a row chose may round apart).
    Returns readings."""
    for step, (g, w) in enumerate(zip(res["losses"], ref["losses"], strict=True)):
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-3 * abs(v), f"{msg} step {step} {k}: {g[k]} vs {v}"
    cancelling = HALF_CANCELLING.get(tag, ())
    assert set(res["grads"]) == set(ref["grads"]), msg
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    worst = {}
    for k, g in ref["grads"].items():
        gap = float((res["grads"][k] - g).abs().max())
        own = float(g.abs().max())
        worst[k] = gap / max(own, 1e-30)
        assert gap <= 1e-2 * (top if k in cancelling else own), \
            f"{msg} grad {k}: {gap} ({own} its largest, {top} the network's)"
    want = torch.cat([g.flatten() for g in ref["grads"].values()])
    got = torch.cat([res["grads"][k].flatten() for k in ref["grads"]])
    vec = float((got - want).norm() / want.norm())
    assert vec <= 1e-2, f"{msg} gradients {vec} of their norm apart"
    moments, got_moments = _moments_by_name(ref), _moments_by_name(res)
    m_top = max(float(m.abs().max()) for ms in moments.values() for m, _ in ms)
    v_top = max(float(v.abs().max()) for ms in moments.values() for _, v in ms)
    for k, ms in moments.items():
        for (m, v), (gm, gv) in zip(ms, got_moments[k], strict=True):
            for name, a, b, rel, net_top in (("exp_avg", gm, m, 1e-2, m_top),
                                             ("exp_avg_sq", gv, v, 2e-2, v_top)):
                gap = (a - b).abs()
                assert bool((gap <= 5e-4 + 1e-2 * b.abs()).all()), f"{msg} {k} {name}"
                scale = net_top if k in cancelling else float(b.abs().max())
                assert float(gap.max()) <= rel * scale, \
                    f"{msg} {k} {name}: {float(gap.max())} ({scale})"
    params = set(ref["params"])
    stats, exempt = [], {}
    for k, v in ref["nets"].items():
        got_v = res["nets"][k]
        if not v.is_floating_point():
            assert torch.equal(got_v, v), f"{msg} {k}"
        elif vq_by_mass and k.startswith("vqvae.") and k.rsplit(".", 1)[-1].startswith(
                ("codebook_", "embed_avg_", "cluster_size_")):
            if "cluster_size_" in k:
                assert abs(float(got_v.sum() - v.sum())) <= 2e-3 * abs(float(v.sum())), k
        elif k in params:
            beyond = (got_v - v).abs() > 5e-4 + 1e-2 * v.abs()
            if bool(beyond.any()):
                assert k in HALF_SIGN_NOISE.get(tag, ()), f"{msg} {k} beyond 5e-4 + 1e-2 |v|"
                for m, _ in moments[k]:
                    near = float(m[beyond].abs().max()) / max(float(m.abs().max()), 1e-30)
                    assert near <= 1e-2, f"{msg} {k}: a moved element's moment {near} of the max"
                exempt[k] = (int(beyond.sum()), float((got_v - v).abs().max()))
        elif k.endswith(("running_mean", "running_var")):
            stats.append((got_v, v))
        else:
            assert float((got_v - v).abs().max()) <= 1e-4, f"{msg} {k}"
    flips = n_stats = 0
    for got_v, v in stats:
        gap = (got_v - v).abs()
        assert bool((gap <= 5e-4 + 1e-2 * v.abs()).all()), msg
        flips += int((gap > 1e-4).sum())
        n_stats += v.numel()
    assert flips <= n_stats // 100, (msg, flips, n_stats)
    return {"vector": vec, "worst_grad": max(worst.items(), key=lambda kv: kv[1]),
            "stat_flips": (flips, n_stats), "sign_noise": exempt}


def job_families(rank, world, work, unsharded=False):
    """dp = @world: each leg of ``family_legs(world)``; with @unsharded
    (one process, no mesh) every leg unsharded, the reference."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    if unsharded:
        return {tag: run_family_leg(tag) for tag in FAMILY_LEGS}
    mesh = make_mesh()
    out = {}
    for tag in family_legs(world):
        res = run_family_leg(tag, mesh)
        if rank:
            res["digest"] = digest(res)
            for k in ("nets", "opt", "grads"):
                res.pop(k, None)
        out[tag] = res
        gc.collect()
    return out


def job_card_mp(rank, world, work):
    """``BC_Transformer_GMM`` on a camera at (dp, mp) = (1, 2) on the card
    (gloo: the ranks share it), with the kernels' launches of its steps
    and request. cuDNN runs its default algorithms: each mp rank computes
    the replicated trunk itself, and the ranks must agree to the bit all
    the same."""
    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    cuda_build.build_kernels()
    before = dict(cuda_build.LAUNCHES)
    res = run_mp_family_leg("bc_transformer_gmm_rgb", make_mesh(mp=2, device="cuda"),
                            device="cuda")
    res["launched"] = {k: n - before[k] for k, n in cuda_build.LAUNCHES.items()}
    return res


def job_card_bf16(rank, world, work):
    """The tiny flagship's bf16 leg at dp = @world on the card (gloo: the
    ranks share it), with the kernels' launches of its steps and request
    (the parent built the kernels: each rank loads them)."""
    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    cuda_build.build_kernels()
    before = dict(cuda_build.LAUNCHES)
    res = run_family_leg("flagship_bf16", make_mesh(device="cuda"), device="cuda")
    res["launched"] = {k: n - before[k] for k, n in cuda_build.LAUNCHES.items()}
    return res


# ---------------------------------------------------------------------------
# offline RL, the hierarchical family, the MCR policies and MCR pretraining
# under dp (tests/test_torch_mesh_value.py, tests/test_torch_mesh_mcr.py)
# ---------------------------------------------------------------------------

FLAT = {"flat": (5,)}             # the offline-RL legs' observation, A = 3
VA, VT = 3, 2                     # their action width and window (n-step 2)
# one camera for the image legs: ResNet-18's last map 2 x 2 after the crop
CAM = {"agentview_image": (40, 40, 3)}
VCROP = 36
HIER_OBS = {"robot0_eef_pos": (3,), "object": (4,)}
HIER_SH, HIER_INTERVAL, HIER_CALLS = 3, 2, 3   # subgoal horizon; refreshes at 0, 2


def _set(node, dotted, value):
    *path, leaf = dotted.split(".")
    for p in path:
        node = node[p]
    node[leaf] = value


def _camera(obs, keys):
    """@obs (an observation section) on @keys' low-dim keys and ``CAM``
    through a ResNet-18 core behind a random crop, pooled by its spatial
    mean (SpatialSoftmax is blind to a shift of a channel, so that the last
    BatchNorm bias's true gradient is 0 and its reduction noise, stepped by
    Adam as lr times its sign, would move it by 1e-3)."""
    obs.modalities.obs.low_dim = [k for k, s in keys.items() if len(s) == 1]
    obs.modalities.obs.rgb = list(CAM)
    obs.encoder.rgb.core_class = "VisualCore"
    obs.encoder.rgb.core_kwargs = {
        "feature_dimension": 16, "backbone_class": "ResNet18Conv",
        "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
        "pool_class": "SpatialMeanPool", "pool_kwargs": {}}
    obs.encoder.rgb.obs_randomizer_class = "CropRandomizer"
    obs.encoder.rgb.obs_randomizer_kwargs = {"crop_height": VCROP, "crop_width": VCROP,
                                             "num_crops": 1, "pos_enc": False}


def value_config(cfg, edits=(), images=False):
    """@cfg (``iql``, ``td3_bc``, ``cql`` or ``bcq``) at small widths on
    ``FLAT`` (with @images, beside ``CAM``), lr 1e-3 (with @images the
    template's 1e-4: at 1e-3 Adam's second step turns the reduction noise
    of a trunk's near-zero gradient into 2e-5 of weight) with L2 and a clip
    limit, the BCQ sampler small; @edits ((dotted key under algo, value),
    ...)."""
    with cfg.values_unlocked():
        if images:
            _camera(cfg.observation, {**FLAT, **CAM})
        else:
            cfg.observation.modalities.obs.low_dim = list(FLAT)
            cfg.observation.modalities.obs.rgb = []
        algo = cfg.algo
        algo.critic.layer_dims = algo.actor.layer_dims = [8, 8]
        for name in algo.optim_params:
            p = algo.optim_params[name]
            p.learning_rate.initial = 1e-4 if images else 1e-3
            p.learning_rate.scheduler_type = None
            p.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
        cfg.train.seed = 0
        cfg.train.pallas_pool = images
        if "action_sampler" in algo:
            vae = algo.action_sampler.vae
            vae.latent_dim = 4
            vae.encoder_layer_dims = vae.decoder_layer_dims = vae.prior_layer_dims = [8]
            vae.kl_weight = 0.5
            algo.action_sampler.actor_layer_dims = [8, 8]
            algo.critic.num_action_samples, algo.critic.num_action_samples_rollout = 3, 5
        for key, value in edits:
            _set(algo, key, value)
    return cfg


def _hier_planner(node):
    node.ae.planner_layer_dims = [16]
    node.vae.encoder_layer_dims = node.vae.decoder_layer_dims = [16]
    node.vae.latent_dim, node.vae.kl_weight = 4, 0.5
    node.subgoal_horizon = HIER_SH
    node.optim_params.goal_network.learning_rate.initial = 1e-3
    node.optim_params.goal_network.regularization.L2 = 1e-2


def hier_config(cfg, vae=True, mode="separate"):
    """@cfg (``gl``, ``hbc`` or ``iris``) at small widths on ``HIER_OBS``:
    the planner's subgoals ``HIER_SH`` steps on, the actor a 2-layer LSTM of
    8, subgoals refreshed every ``HIER_INTERVAL`` calls, IRIS's value a BCQ
    scoring 3 subgoals a row."""
    keys = list(HIER_OBS)
    with cfg.values_unlocked():
        cfg.train.max_grad_norm = 1.0
        cfg.train.seed = 0
        cfg.train.seq_length = HIER_SH
        if cfg.algo_name == "gl":
            cfg.observation.modalities.obs.low_dim = keys
            cfg.observation.modalities.subgoal.low_dim = keys
            _hier_planner(cfg.algo)
            cfg.algo.vae.enabled = vae
            return cfg
        cfg.algo.mode = mode
        cfg.algo.subgoal_update_interval = HIER_INTERVAL
        actor = cfg.algo.actor
        actor.actor_layer_dims = []
        actor.rnn.hidden_dim, actor.rnn.num_layers, actor.rnn.horizon = 8, 2, HIER_SH
        actor.optim_params.policy.learning_rate.initial = 1e-3
        cfg.observation.actor.modalities.obs.low_dim = keys
        if cfg.algo_name == "hbc":
            planner, planner_obs = cfg.algo.planner, cfg.observation.planner
        else:
            vp = cfg.algo.value_planner
            planner, planner_obs = vp.planner, cfg.observation.value_planner.planner
            vp.num_samples = 3
            value = vp.value
            value.critic.layer_dims = [16]
            value.critic.num_action_samples, value.critic.num_action_samples_rollout = 2, 3
            svae = value.action_sampler.vae
            svae.latent_dim = 4
            svae.encoder_layer_dims = svae.decoder_layer_dims = svae.prior_layer_dims = [16]
            cfg.observation.value_planner.value.modalities.obs.low_dim = keys
        _hier_planner(planner)
        planner.vae.enabled = vae
        planner_obs.modalities.obs.low_dim = keys
        planner_obs.modalities.subgoal.low_dim = keys
    return cfg


def mcr_config(cfg, images=True):
    """``mcr`` (MCR_GMM, 3 modes) at small widths on ``FLAT`` (with @images
    beside ``CAM``)."""
    with cfg.values_unlocked():
        if images:
            _camera(cfg.observation, {**FLAT, **CAM})
        else:
            cfg.observation.modalities.obs.low_dim = list(FLAT)
            cfg.observation.modalities.obs.rgb = []
        cfg.algo.actor_layer_dims = [16, 16]
        cfg.algo.gmm.num_modes = 3
        cfg.train.max_grad_norm = 0.5
        cfg.train.seed = 0
        cfg.train.pallas_pool = images
    return cfg


# tag: (algo name, configure, obs key shapes, request kind, worlds). Every leg
# takes two steps on ``value_batches`` and a request after them; kinds:
# "obs" get_action on B observations, "subgoal" a planner's predictions of
# the rank's rows, "stepwise" HIER_CALLS get_action calls after a reset.
_IMG = {**FLAT, **CAM}
_TD3_BC = [("n_step", 2), ("infinite_horizon", True), ("critic.ensemble.weight", 0.75)]
VALUE_LEGS = {
    "iql": ("iql", lambda c: value_config(c, [("adv.clip_adv_value", 0.5)]), FLAT, "obs",
            (2, 4)),
    "iql_gmm": ("iql", lambda c: value_config(c, [("actor.net.type", "gmm"),
                                                  ("actor.net.gmm.num_modes", 3)]),
                FLAT, "obs", (2,)),
    "td3_bc": ("td3_bc", lambda c: value_config(c, _TD3_BC), FLAT, "obs", (2, 4)),
    # the JAX oracle's leg: its smoothing noise injected (``job_value``'s)
    "td3_bc_jax": ("td3_bc", lambda c: value_config(c, _TD3_BC), FLAT, "obs", (2,)),
    "cql": ("cql", lambda c: value_config(c, [("n_step", 2), ("critic.num_random_actions", 4),
                                              ("critic.deterministic_backup", False)]),
            FLAT, "obs", (2,)),
    "cql_samples": ("cql", lambda c: value_config(c, [
        ("critic.num_random_actions", 4), ("critic.num_action_samples", 3),
        ("critic.target_q_gap", 1.0)]), FLAT, "obs", (2, 4)),
    "bcq": ("bcq", lambda c: value_config(c, [("n_step", 2), ("actor.enabled", True)]),
            FLAT, "obs", (2, 4)),
    "bcq_gmm": ("bcq", lambda c: value_config(c, [("action_sampler.gmm.enabled", True),
                                                  ("action_sampler.gmm.num_modes", 3)]),
                FLAT, "obs", (2,)),
    "bcq_distributional": ("bcq", lambda c: value_config(c, [
        ("actor.enabled", True), ("critic.distributional.enabled", True),
        ("critic.distributional.num_atoms", 11), ("critic.value_bounds", [-4.0, 4.0])]),
        FLAT, "obs", (2,)),
    "iql_rgb": ("iql", lambda c: value_config(c, images=True), _IMG, "obs", (2, 4)),
    "gl": ("gl", lambda c: hier_config(c, vae=False), HIER_OBS, "subgoal", (2,)),
    "gl_vae": ("gl", hier_config, HIER_OBS, "subgoal", (2, 4)),
    "hbc": ("hbc", hier_config, HIER_OBS, "stepwise", (2, 4)),
    "hbc_cascade": ("hbc", lambda c: hier_config(c, mode="cascade"), HIER_OBS, "stepwise",
                    (2,)),
    "hbc_gl": ("hbc", lambda c: hier_config(c, vae=False), HIER_OBS, "stepwise", (2,)),
    "iris": ("iris", hier_config, HIER_OBS, "stepwise", (2, 4)),
}


def value_algo(tag, device="cpu", legs=None):
    from robot_manipulation_vq_vae_tpu_torch.algo import algo_factory
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils

    name, configure, keys = (legs or VALUE_LEGS)[tag][:3]
    cfg = configure(config_factory(name))
    obs_utils.initialize_obs_utils_with_config(cfg)
    return algo_factory(name, cfg, dict(keys), VA, device=device)


def value_batch(seed, keys, t):
    """B windows of @t steps of (s, a, r, s', done) over @keys (images
    uint8), actions in [-0.9, 0.9], a quarter of the steps done."""
    rng = np.random.RandomState(seed)

    def obs():
        return {k: (rng.randint(0, 255, (B, t) + s).astype(np.uint8) if len(s) == 3
                    else rng.randn(B, t, *s).astype(np.float32)) for k, s in keys.items()}

    return {"obs": obs(), "next_obs": obs(),
            "actions": rng.uniform(-0.9, 0.9, (B, t, VA)).astype(np.float32),
            "rewards": rng.rand(B, t).astype(np.float32),
            "dones": (rng.rand(B, t) < 0.25).astype(np.float32)}


def value_batches(tag, legs=None):
    """The leg's two processed batches (epochs 0 and 1)."""
    keys = (legs or VALUE_LEGS)[tag][2]
    t = HIER_SH if keys is HIER_OBS else VT
    return [value_batch(30 + i, keys, t) for i in range(2)]


def hier_states(algo):
    """``algo_state`` of each algo under a hierarchical or value-planner
    @algo, by its path (``planner``, ``actor``, ``planner.value_net``)."""
    parts = {"": algo}
    out = {}
    while parts:
        path, a = parts.popitem()
        subs = {n: getattr(a, n) for n in ("planner", "actor", "value_net") if hasattr(a, n)}
        if subs:
            parts.update({f"{path}{n}.": v for n, v in subs.items()})
        else:
            out[path] = algo_state(a)
    return out


def flat_losses(info):
    """A nested ``train_on_batch`` info's losses as {path: float}."""
    out = {}
    for k, v in info.items():
        if k == "losses":
            out.update({n: float(x) for n, x in v.items()})
        elif isinstance(v, dict):
            out.update({f"{k}/{n}": x for n, x in flat_losses(v).items()})
    return out


def value_request(algo, kind, keys, mesh=None):
    """The leg's request after its steps (on this rank's shards under
    @mesh): stacked [calls, B, ...] of the global batch's actions, or a
    planner's subgoal predictions of the rank's rows {key: [rows, ...]}."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    rng = np.random.RandomState(7)
    cut = (lambda d: d) if mesh is None else (lambda d: shard_batch(mesh, d))

    def obs():
        return {k: (rng.randint(0, 255, (B,) + s).astype(np.uint8) if len(s) == 3
                    else rng.randn(B, *s).astype(np.float32)) for k, s in keys.items()}

    if kind == "subgoal":
        sub = algo.get_subgoal_predictions(cut(obs()))
        return {k: v.detach().cpu().clone() for k, v in sub.items()}
    if kind == "obs":
        return algo.get_action(cut(obs())).detach().cpu().clone()[None]
    if kind == "window":
        window = {k: np.stack([v] * VT, 1) for k, v in obs().items()}
        return algo.get_action(cut(window)).detach().cpu().clone()[None]
    algo.reset()
    calls = [obs() for _ in range(HIER_CALLS)]
    return torch.stack([algo.get_action(cut(o)).detach().cpu().clone() for o in calls])


def run_value_leg(tag, mesh=None, device="cpu", legs=None, noise=None, start=None):
    """A leg's algo (under @mesh), its two steps (on @mesh's shards) and its
    request; @noise: the steps' ``_noise_hook`` draws, the global batch's;
    @start: a file of its parts' state dicts ({``hier_states`` path: state
    dict}) to start from."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch, shard_state

    legs = legs or VALUE_LEGS
    keys, kind = legs[tag][2], legs[tag][3]
    algo = value_algo(tag, device, legs)
    if start is not None:
        parts = {"planner.": algo.planner, "actor.": algo.actor} if hasattr(
            algo, "planner") else {"": algo}
        for path, sd in torch.load(start).items():
            parts[path].nets.load_state_dict(sd)
    if noise is not None:
        draws = iter(noise)
        algo._noise_hook = lambda: next(draws)
    if mesh is not None:
        shard_state(mesh, algo)
    losses = []
    for epoch, batch in enumerate(value_batches(tag, legs)):
        batch = algo.process_batch_for_training(batch)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        losses.append(flat_losses(algo.train_on_batch(batch, epoch=epoch)))
    return {"losses": losses, "states": hier_states(algo),
            "request": value_request(algo, kind, keys, mesh)}


def _without_whole_states(res):
    """@res with each state as its ``digest`` (the ranks after the first)."""
    res["digests"] = {p: digest(st) for p, st in res.pop("states").items()}
    return res


def job_value(rank, world, work, td3_bc_noise, starts, unsharded=False):
    """dp = @world: each ``VALUE_LEGS`` leg run at that world (``td3_bc_jax``
    with @td3_bc_noise, JAX's draws; a leg in @starts from that file's
    weights); with @unsharded (one process, no mesh) every leg, the
    reference. World 2 also runs every leg at (dp, mp) = (1, 2)."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    def run(tag, mesh=None):
        return run_value_leg(tag, mesh, noise=td3_bc_noise if tag == "td3_bc_jax" else None,
                             start=starts.get(tag))

    if unsharded:
        return {tag: run(tag) for tag in VALUE_LEGS}
    mesh = make_mesh()
    out = {}
    for tag, leg in VALUE_LEGS.items():
        if world in leg[4]:
            res = run(tag, mesh)
            out[tag] = _without_whole_states(res) if rank else res
    if world == 2:
        mp_mesh = make_mesh(mp=2, device="cpu")
        out["mp"] = {tag: run(tag, mp_mesh) for tag in VALUE_LEGS}
        if rank:
            out["mp"] = {t: _without_whole_states(r) for t, r in out["mp"].items()}
    return out


# the MCR policies: MCR_GMM on the camera, warm-started from a pretrained
# ResNet-18 trunk (``RMVQ_MCR_CKPT``), and the transformer GMM on ``FLAT``
def _mcr_transformer(cfg):
    cfg = mcr_config(cfg, images=False)
    with cfg.values_unlocked():
        tx = cfg.algo.transformer
        tx.enabled, tx.context_length, tx.embed_dim, tx.num_layers, tx.num_heads = (
            True, VT, 16, 1, 2)
        tx.emb_dropout = tx.attn_dropout = tx.block_output_dropout = 0.0
        cfg.train.seq_length = VT
    return cfg


MCR_LEGS = {
    "mcr_gmm_rgb": ("mcr", mcr_config, _IMG, "obs", (2, 4)),
    "mcr_transformer_gmm": ("mcr", _mcr_transformer, FLAT, "window", (2,)),
}
# the six MCR classes: (gmm, rnn, transformer) of each
MCR_CLASSES = {"MCR": (False, False, False), "MCR_GMM": (True, False, False),
               "MCR_RNN": (False, True, False), "MCR_RNN_GMM": (True, True, False),
               "MCR_Transformer": (False, False, True),
               "MCR_Transformer_GMM": (True, False, True)}


def mcr_class_config(cfg, cls):
    """@cfg (``mcr``) routed to @cls at small widths on ``FLAT``."""
    gmm, rnn, transformer = MCR_CLASSES[cls]
    cfg = _mcr_transformer(cfg)
    with cfg.values_unlocked():
        cfg.algo.gmm.enabled = gmm
        cfg.algo.rnn.enabled, cfg.algo.rnn.hidden_dim, cfg.algo.rnn.horizon = rnn, 8, VT
        cfg.algo.transformer.enabled = transformer
    return cfg


def mcr_class_algo(cls):
    """The ``mcr`` algo routed to @cls at small widths on ``FLAT``."""
    from robot_manipulation_vq_vae_tpu_torch.algo import algo_factory
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils

    cfg = mcr_class_config(config_factory("mcr"), cls)
    obs_utils.initialize_obs_utils_with_config(cfg)
    return algo_factory("mcr", cfg, dict(FLAT), VA, device="cpu")


# MCR pretraining: ResNet-18 on 32 x 32 frames, all three losses, B quintuples
PRETRAIN = dict(size=18, hidden_dim=16, tcn_weight=1.0, align_state_weight=0.25,
                bc_weight=0.5, action_dim=VA, resize_to_224=False, state_dim=42)
PRETRAIN_IMG, PRETRAIN_LR = 32, 1e-4


def pretrainer(device="cpu", double=False):
    """The trainer from the seed's weights; in float64 with @double."""
    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import (
        MCRPretrainer,
        MCRRepresentation,
    )

    torch.manual_seed(0)
    model = MCRRepresentation(**PRETRAIN)
    return MCRPretrainer(model.double() if double else model, lr=PRETRAIN_LR, device=device)


def pretrain_batches():
    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import synthetic_batches

    return list(synthetic_batches(B, PRETRAIN_IMG, VA, 42, num_batches=3, seed=3))


def run_pretrain(mesh=None, perms=None, double=False):
    """Two steps and an evaluation step of ``pretrainer`` (on @mesh's
    shards): the negatives from its generator, or @perms (each call's, of
    the global batch). Returns its metrics and its state."""
    from robot_manipulation_vq_vae_tpu_torch.algo.algo import _to_cpu
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch, shard_state

    tr = pretrainer(double=double)
    if mesh is not None:
        shard_state(mesh, tr)
    metrics = []
    for i, batch in enumerate(pretrain_batches()):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        metrics.append(tr.update(batch, eval=i == 2,
                                 neg_perms=None if perms is None else perms[i]))
    return {"losses": metrics,
            "states": {"": {"nets": {k: v.detach().cpu().clone()
                                     for k, v in tr.model.state_dict().items()},
                            "opt": {"model": _to_cpu(tr.optimizer.state_dict())}}}}


def job_mcr(rank, world, work, trunk, perms, unsharded=False):
    """dp = @world: each ``MCR_LEGS`` leg at that world (warm-started from
    @trunk), shard_state of each of the six MCR classes, and MCR pretraining
    in float64 (a float32 run's Adam steps turn the reduction noise of
    near-zero gradients into 1e-5 of weight) and, at world 2, with the JAX
    oracle's negatives @perms; with @unsharded every leg and the
    pretraining unsharded (and the six classes' steps). World 2 also runs
    the six classes and the pretraining at (dp, mp) = (1, 2)."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state

    os.environ["RMVQ_MCR_CKPT"] = trunk
    if unsharded:
        out = {tag: run_value_leg(tag, legs=MCR_LEGS) for tag in MCR_LEGS}
        out["pretrain"] = run_pretrain(double=True)
        out["classes_steps"] = {cls: run_value_leg(cls, legs=MCR_CLASS_LEGS)
                                for cls in MCR_CLASSES}
        return out
    mesh = make_mesh()
    out = {tag: run_value_leg(tag, mesh, legs=MCR_LEGS) for tag, leg in MCR_LEGS.items()
           if world in leg[4]}
    out["classes"] = {cls: (type(a).__name__, _refusal(lambda: shard_state(mesh, a)))
                      for cls, a in ((c, mcr_class_algo(c)) for c in MCR_CLASSES)}
    out["pretrain"] = run_pretrain(mesh, double=True)
    if world == 2:
        out["pretrain_pinned"] = run_pretrain(mesh, perms, double=True)
        mp_mesh = make_mesh(mp=2, device="cpu")
        out["mp"] = {cls: run_value_leg(cls, mp_mesh, legs=MCR_CLASS_LEGS)
                     for cls in MCR_CLASSES}
        out["mp"]["pretrain"] = run_pretrain(mp_mesh, double=True)
        if rank:
            out["mp"] = {t: _without_whole_states(r) for t, r in out["mp"].items()}
    if rank:
        out = {k: _without_whole_states(v) if isinstance(v, dict) and "states" in v else v
               for k, v in out.items()}
    return out


# ---------------------------------------------------------------------------
# every family under mp (tests/test_torch_mesh_mp_families.py,
# tests/test_torch_mesh_mp_value.py)
# ---------------------------------------------------------------------------

# the (dp, mp) meshes of a world's ranks
MP_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def gpt_variant_config(cfg, activation="gelu", heads=2, width=16):
    """``BC_Transformer_GMM`` (``icl_family_config``) with the GPT's MLP
    @activation and @heads heads of @width."""
    cfg = icl_family_config(cfg, "transformer_gmm")
    with cfg.values_unlocked():
        tx = cfg.algo.transformer
        tx.activation, tx.num_heads, tx.embed_dim = activation, heads, width
    return cfg


def bc_transformer_rgb_config(cfg):
    """``BC_Transformer_GMM`` (``icl_family_config``) beside ``CAM``'s
    camera (``_camera``: a ResNet-18 behind a crop) on the stem-pool
    kernels."""
    cfg = icl_family_config(cfg, "transformer_gmm")
    with cfg.values_unlocked():
        _camera(cfg.observation, {**OBS_KEYS, **CAM})
        cfg.train.pallas_pool = True
    return cfg


# legs beside ``FAMILY_LEGS``, in its format: the GPT options of the
# placement rules, GEGLU (mlp_fc [8 d, d] split contiguously) and 6 heads
# that mp = 4 does not divide; ACT with its latent draw pinned
# (``act_noise``), as JAX's oracle step takes it; and BC_Transformer_GMM on
# a camera (the card's mp leg)
EXTRA_LEGS = {
    "bc_transformer_gmm_geglu": ("bc", lambda c: gpt_variant_config(c, "geglu"), OBS_KEYS, H,
                                 False, "window", (), False),
    "bc_transformer_gmm_6heads": ("bc", lambda c: gpt_variant_config(c, heads=6, width=24),
                                  OBS_KEYS, H, False, "window", (), False),
    "act_pinned": ("act", act_config, OBS_KEYS, FAM_T, False, "act", (), False),
    "bc_transformer_gmm_rgb": ("bc", bc_transformer_rgb_config, {**OBS_KEYS, **CAM}, H,
                               False, "window", (), False),
}
ACT_SEED, ACT_LATENT = 3, 8


def act_noise():
    """ACT's training latent draw [B, latent] of every step: the first
    normal draw of ``PinnedJaxRandom(ACT_SEED)``, the constant of JAX's
    traced step."""
    return np.random.RandomState(ACT_SEED).randn(B, ACT_LATENT)
# MCR's classes on ``FLAT`` as ``VALUE_LEGS``' legs
MCR_CLASS_LEGS = {
    cls: ("mcr", lambda c, cls=cls: mcr_class_config(c, cls), FLAT,
          "window" if MCR_CLASSES[cls][2] else "stepwise" if MCR_CLASSES[cls][1] else "obs",
          ())
    for cls in MCR_CLASSES}
# the legs of each file: {tag: its legs' table}; "pretrain" is MCR
# pretraining (``run_pretrain``)
MP_LEGS = {
    "families": {**{t: FAMILY_LEGS for t in (
        "paper_lipvq_bf16", "paper_bin", "paper_ln_act", "paper_default", "paper_fast",
        "bc_transformer", "bc_transformer_gmm", "act")},
        **{t: EXTRA_LEGS for t in ("bc_transformer_gmm_geglu", "bc_transformer_gmm_6heads",
                                   "act_pinned")},
        "MCR_Transformer": MCR_CLASS_LEGS},
    "bf16": {t: FAMILY_LEGS for t in ("flagship_bf16", "flagship_packed_bf16")},
    "value": {**{t: FAMILY_LEGS for t in ("icl", "icl_rnn_gmm", "bc_vae", "mamba_gmm",
                                          "diffusion")},
              **{t: VALUE_LEGS for t in ("iql", "td3_bc", "cql", "bcq", "gl_vae", "hbc",
                                         "iris")},
              "MCR_GMM": MCR_CLASS_LEGS, "pretrain": None},
}


def placements(module):
    """{parameter name: (placement, dim)} of @module's parameters: a
    DTensor's, and ("Replicate", None) for a plain tensor."""
    from torch.distributed.tensor import DTensor

    def one(p):
        if not isinstance(p, DTensor):
            return ("Replicate", None)
        return (type(p.placements[0]).__name__, getattr(p.placements[0], "dim", None))

    return {n: one(p) for n, p in module.named_parameters()}


def vit():
    """A tiny MVP ViT (``VisionTransformer``, 2 blocks of width 32, 2 heads,
    8 x 8 patches of a 16 x 16 image) from the seed, and its input."""
    from robot_manipulation_vq_vae_tpu_torch.models.pretrained_nets import VisionTransformer

    torch.manual_seed(0)
    model = VisionTransformer(embed_dim=32, depth=2, num_heads=2, patch_size=8, img_size=16)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 3, 16, 16).astype(np.float32))
    return model, x


def vit_step(mesh=None):
    """The tiny ViT's output and its parameters' gradients (whole) of the
    output's sum of squares, under @mesh's mp (``shard_params``) where
    given, and its placements."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import AxisComm, shard_params
    from robot_manipulation_vq_vae_tpu_torch.utils.tensor_parallel import full_tensor

    model, x = vit()
    comm = None
    if mesh is not None:
        shard_params(mesh, model)
        comm = AxisComm(mesh, "mp")
    out = model(x)
    grads = torch.autograd.grad(out.square().sum(), list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    return {"out": out.detach(), "placements": placements(model),
            "grads": {n: (g if comm is None else full_tensor(g, comm)).detach().clone()
                      for n, g in zip(names, grads)}}


def _family_table(tag):
    return EXTRA_LEGS if tag in EXTRA_LEGS else FAMILY_LEGS


def parted_replicas(mesh):
    """``BC_Transformer_GMM``'s two steps under @mesh with each mp rank's
    replicated gradients moved by its own amount (mp rank r: + r 1e-3), as
    a card's non-deterministic kernels part them: the ``digest`` of the
    state, which every rank must hold alike."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state
    from robot_manipulation_vq_vae_tpu_torch.utils.tensor_parallel import is_sharded

    tag = "bc_transformer_gmm"
    legs = _family_table(tag)
    algo = shard_state(mesh, family_algo(tag, "cpu", legs))
    shift = mesh.get_local_rank("mp") * 1e-3
    for p in algo.nets.parameters():
        if p.requires_grad and not is_sharded(p):
            p.register_hook(lambda g: g + shift)
    steps(algo, family_batches(tag, legs), mesh, legs[tag][4])
    return digest(algo_state(algo))


def run_mp_family_leg(tag, mesh=None, device="cpu"):
    """A ``FAMILY_LEGS`` or ``EXTRA_LEGS`` leg on @device under @mesh (None:
    unsharded): two steps on the dp shards, ``serialize`` with the
    optimizers (whole tensors; the generator's state before the request),
    the request, and a fresh algo under @mesh from that checkpoint serving
    it again."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    legs = _family_table(tag)
    _, _, keys, _, halves, kind, _, half = legs[tag]

    def build():
        algo = family_algo(tag, device, legs)
        return algo if mesh is None else shard_state(mesh, algo)

    algo = build()
    out = {"losses": steps(algo, family_batches(tag, legs), mesh, halves),
           **family_state(algo, half), "placements": placements(algo.nets)}
    out["serialized"] = algo.serialize(include_optimizer=True)
    out["action"] = family_request(algo, kind, keys, mesh)
    again = build()
    again.deserialize(out["serialized"])
    out["reloaded"] = family_request(again, kind, keys, mesh)
    return out


def run_mp_value_leg(tag, legs, mesh=None):
    """A ``VALUE_LEGS``-style leg under @mesh as ``run_mp_family_leg``."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch, shard_state

    keys, kind = legs[tag][2], legs[tag][3]

    def build():
        algo = value_algo(tag, legs=legs)
        return algo if mesh is None else shard_state(mesh, algo)

    algo = build()
    losses = []
    for epoch, batch in enumerate(value_batches(tag, legs)):
        batch = algo.process_batch_for_training(batch)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        losses.append(flat_losses(algo.train_on_batch(batch, epoch=epoch)))
    out = {"losses": losses, "states": hier_states(algo), "placements": placements(algo.nets),
           "serialized": algo.serialize(include_optimizer=True)}
    out["request"] = value_request(algo, kind, keys, mesh)
    again = build()
    again.deserialize(out["serialized"])
    out["reloaded"] = value_request(again, kind, keys, mesh)
    return out


_UNSHARDED = {}


def serve_checkpoint(tag, table, serialized):
    """An unsharded algo of @table's leg @tag (built once, then reloaded)
    from what ``serialize`` wrote (under mp: whole tensors), serving the
    leg's request."""
    legs = table[tag]
    family = legs in (FAMILY_LEGS, EXTRA_LEGS)
    if tag not in _UNSHARDED:
        _UNSHARDED[tag] = family_algo(tag, legs=legs) if family else value_algo(tag, legs=legs)
    algo = _UNSHARDED[tag]
    algo.deserialize(serialized)
    if family:
        return family_request(algo, legs[tag][5], legs[tag][2])
    return value_request(algo, legs[tag][3], legs[tag][2])


def leg_digest(res):
    """The ``digest`` of a leg's state: of each part's, by path, where it
    has parts (``hier_states``)."""
    if "states" in res:
        return {p: digest(st) for p, st in res["states"].items()}
    return digest(res)


def run_mp_leg(tag, table, mesh=None):
    """One leg of @table (``MP_LEGS``' entry) under @mesh (None: unsharded)."""
    if tag == "pretrain":
        return run_pretrain(mesh, double=True)
    if table[tag] in (FAMILY_LEGS, EXTRA_LEGS):
        return run_mp_family_leg(tag, mesh)
    return run_mp_value_leg(tag, table[tag], mesh)


def job_mp_families(rank, world, work, which, unsharded=False, tags=None):
    """Every leg of ``MP_LEGS[@which]`` (@tags of it, where given) at each
    mesh of ``MP_MESHES[@world]`` ({(dp, mp, tag): result}); with @unsharded
    (one process, no mesh) every leg unsharded, the reference ({tag:
    result}). Rank 0 keeps the states; the others their digests."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    table = {t: v for t, v in MP_LEGS[which].items() if tags is None or t in tags}
    if unsharded:
        out = {tag: run_mp_leg(tag, table) for tag in table}
        if which == "families":
            out["vit"] = vit_step()
        return out
    out = {}
    for dp, mp in MP_MESHES[world]:
        mesh = make_mesh(mp=mp, device="cpu")
        if which == "families":
            out[(dp, mp, "vit")] = vit_step(mesh)
            out[(dp, mp, "parted_replicas")] = parted_replicas(mesh)
        for tag in table:
            t0 = time.perf_counter()
            res = run_mp_leg(tag, table, mesh)
            res["seconds"] = time.perf_counter() - t0
            if rank:
                res = {"digest": leg_digest(res), **{
                    k: v for k, v in res.items()
                    if k not in ("nets", "opt", "grads", "states", "serialized")}}
            out[(dp, mp, tag)] = res
            gc.collect()
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
        out = []
        for r in range(world):
            path = os.path.join(work, f"rank{r}.pt")
            out.append(torch.load(path, weights_only=False))
            os.remove(path)   # the flagship's states take hundreds of MB
        return out

    return results
