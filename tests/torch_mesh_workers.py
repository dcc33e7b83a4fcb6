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


def refusals(mesh):
    """What shard_state and train_on_batch refuse under dp > 1 (dropout,
    keypoint noise and the randomizers are covered since the draws are
    global)."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

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
        "bin": _refusal(lambda: shard_state(mesh, bin_paper())),
        "mixed_precision": _refusal(lambda: shard_state(mesh, flagship(mixed_precision=True))),
        "packed_rgb_encoders": _refusal(
            lambda: shard_state(mesh, flagship(packed_rgb_encoders=True))),
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
