"""Drive the PyTorch port (robot_manipulation_vq_vae_tpu_torch) on one NVIDIA
card and check it.

    python3 chip_smoke.py            # what the checks need: one card
    python3 chip_smoke.py --profile  # also device-time breakdowns of get_action
                                     # and of one training step

Phases, each of which fails the run when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. the assign kernel against its plain version at D in {976, 210},
     K = 1024, N in {16, 256, 65536}, and its backward (L2Nearest) against
     plain autograd at N = 512, D = 976;
  4. the roundtrip kernel against its plain version on 65,536 x 12 chunks
     with weights ~N(0, 0.5^2);
  5. the tokenizer path: LipVQVAE.roundtrip_fused at 65,536 chunks;
  6. the stem pool's kernels (forward, backward) against their plain versions
     at the training path's [512, 64, 58, 58] and at [2, 64, 57, 59], on
     inputs after a ReLU (about 60 % zeros, so windows tie): maxima and
     offsets bit-equal, dx within 1e-6 max|g|;
  7. the policy path: icl_gmm_paper get_action at full width (6 layers, width
     512, 8 heads, context 16, 3 cameras of 128x128 cropped to 116, FiLM
     ResNet-18, LipVQ with 1024 codes over the 976-d encoder output), random
     weights from a seed, 3 requests at B = 1 and 3 at B = 16, held against
     the same model with the plain quantizer; then one B = 16 request with
     train.pallas_pool on, whose GMM must equal the F.max_pool2d model's bit
     for bit;
  8. the training path: icl_gmm_paper train_on_batch at full width with
     train.pallas_pool on, B = 64, T = 16, random 116x116 crops, dropout 0.1:
     one warm-up step and 3 timed steps (launch counts per step asserted),
     then one step of the kernel model and one of the plain model from the
     same weights, batch and random draws, held together.
Each path runs with the launch counts set to 0 just before it and read just
after; a kernel of the path that was never launched fails the run.

The comparisons run in full fp32: TF32 is switched off for matmul and cuDNN.
Output: one line per measurement, then a JSON line {"kernels": [...]}, the
card's name and power limit, and last {"ok": true, "device": {...}}. Exits
non-zero, printing no result, without a CUDA device or without the port.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FP32_PEAK = 67e12          # H100 SXM, fp32 outside the tensor cores (FLOP/s)
HBM_RATE = 3.35e12         # H100 SXM device memory (bytes/s)
SOURCE = "robot_manipulation_vq_vae_tpu_torch/csrc"
TPU_KERNELS = "robot_manipulation_vq_vae_tpu/ops/pallas/lipvq_kernel.py"
TPU_POOL = "robot_manipulation_vq_vae_tpu/ops/pallas/stem_pool.py"
TIE_REL = 1e-5             # rows whose two best distances are closer may flip
MAX_FLIP_SHARE = 1e-3      # ... and at most 0.1% of the rows may

ASSIGN_DS, ASSIGN_NS = (976, 210), (16, 256, 512, 65536)
TOKENIZER_CHUNKS = 65536
IMG, CROP = 128, 116       # camera images, center-cropped at eval
BATCHES = (1, 16)          # one env, and the 16-env batch
REQUESTS = 3
# the training path's stem pool input (3 cameras x 2 groups of 32 x 16
# frames per step, each [512, 64, 58, 58]) and a small odd shape
POOL_SHAPES = ((512, 64, 58, 58), (2, 64, 57, 59))
TRAIN_B, TRAIN_STEPS = 64, 3   # bench_train.py's batch; 3 timed steps
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """Fail the run unless @ok (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3, repeats=5):
    """Device time of @fn (CUDA events): the mean over @iters back-to-back
    calls, repeated @repeats times. Returns (median, min, max) in ms."""
    import torch

    for _ in range(warmup):
        fn()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means), min(means), max(means)


def fmt(t):
    return f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]"


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_RATE * 1e3, n_ops / FP32_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def near_ties(z, codebook):
    """Rows whose best and second-best squared distances (float64) differ by
    at most TIE_REL relative to the best."""
    import torch

    cb = codebook.double()
    c_sq = (cb * cb).sum(-1)
    out = []
    for zc in z.double().split(8192):
        d = (zc * zc).sum(-1, keepdim=True) - 2.0 * zc @ cb.t() + c_sq[None]
        two = d.topk(2, dim=-1, largest=False).values
        out.append((two[:, 1] - two[:, 0]) <= TIE_REL * two[:, 0].abs().clamp_min(1e-30))
    return torch.cat(out)


def check_assignments(tag, idx_k, idx_p, ties):
    """idx agree on every row that is not a near tie; flips <= 0.1%."""
    flips = idx_k.long() != idx_p.long()
    n_flip, n_ties = int(flips.sum()), int(ties.sum())
    bad = int((flips & ~ties).sum())
    log(f"  {tag}: {n_flip} flipped rows, {n_ties} near ties (rel gap <= {TIE_REL}), "
        f"{bad} flips off a tie")
    check(bad == 0, f"{tag}: {bad} rows disagree away from a tie")
    check(n_flip <= MAX_FLIP_SHARE * len(idx_k), f"{tag}: {n_flip} flips")
    return ~flips


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_assign(K, dev):
    import torch

    log("phase 3: assign kernel vs plain")
    rows = {}
    gen = torch.Generator(dev).manual_seed(3)
    for d in ASSIGN_DS:
        cb = (torch.rand(1024, d, generator=gen, device=dev) * 2 - 1) * (6.0 / d) ** 0.5
        for n in ASSIGN_NS:
            z = torch.sigmoid(torch.randn(n, d, generator=gen, device=dev))
            idx_k, zq_k = K.l2_nearest_cuda(z, cb)
            idx_p, zq_p = K.l2_nearest_plain(z, cb)
            torch.cuda.synchronize()
            agree = check_assignments(f"D={d} N={n}", idx_k, idx_p, near_ties(z, cb))
            check(torch.equal(zq_k, cb[idx_k.long()]), f"D={d} N={n}: z_q != C[idx]")
            err = float((zq_k[agree] - zq_p[agree]).abs().max())
            ms = cuda_ms(lambda: K.l2_nearest_cuda(z, cb))
            plain = cuda_ms(lambda: K.l2_nearest_plain(z, cb))
            b, by = bound_ms((2 * n * d + 1024 * d + 1024 + n) * 4, 2 * n * 1024 * d)
            log(f"  D={d} N={n}: kernel {fmt(ms)}, plain {fmt(plain)}, "
                f"bound {b:.4f} ms ({by}), max|err| {err}")
            rows[(d, n)] = dict(ms=ms[0], plain_ms=plain[0], bound_ms=b,
                                bound_by=by, max_abs_err=err)
    return rows


def tokenizer_model(dev):
    """LipVQVAE at the tokenizer bench's sizes, every parameter ~N(0, 0.5^2)."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE

    model = LipVQVAE(feature_dim=12, latent_dim=210, num_codes=1024).to(dev).eval()
    gen = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.5 * torch.randn(p.shape, generator=gen, device=dev))
    return model


def roundtrip_flops(n):
    macs = 12 * 64 + 64 * 128 + 128 * 210 + 1024 * 210 + 210 * 64 + 64 * 128 + 128 * 12
    return 2 * n * macs


def phase_roundtrip(K, dev, model, x):
    import torch
    import torch.nn.functional as F

    log(f"phase 4: roundtrip kernel vs plain ({x.shape[0]} x 12, weights ~N(0, 0.5^2))")
    with torch.no_grad():
        w = model.fused_weights()
        rec_k, idx_k = K.lipvq_roundtrip_cuda(x, **w)
        rec_p, idx_p = K.lipvq_roundtrip_plain(x, **w)
        torch.cuda.synchronize()
        xd = x.double()
        (w1, b1), (w2, b2) = [(a.double(), b.double()) for a, b in w["enc_w"]]
        h = F.gelu(xd @ w1 + b1, approximate="tanh")
        h = F.gelu(h @ w2 + b2, approximate="tanh")
        z = torch.sigmoid(h @ w["lip_w"][0].double() + w["lip_w"][1].double())
        agree = check_assignments(f"N={x.shape[0]}", idx_k, idx_p, near_ties(z, w["codebook"]))
        diff = (rec_k[agree] - rec_p[agree]).abs()
        err = float(diff.max())
        rel = float((diff / rec_p[agree].abs().clamp_min(1.0)).max())
        log(f"  recon max|err| {err} (values up to {float(rec_p.abs().max()):.1f}); "
            f"max err / max(1, |value|) {rel}")
        check(rel <= 1e-4, f"recon disagrees: {rel}")
        ms = cuda_ms(lambda: K.lipvq_roundtrip_cuda(x, **w))
        plain = cuda_ms(lambda: K.lipvq_roundtrip_plain(x, **w))
    n = x.shape[0]
    weight_bytes = sum(t.numel() for t in (*sum(w["enc_w"], ()), *w["lip_w"],
                                           *sum(w["dec_w"], ()))) * 4
    b, by = bound_ms(n * (12 + 12 + 1) * 4 + weight_bytes + 1024 * 211 * 4,
                     roundtrip_flops(n))
    log(f"  kernel {fmt(ms)} ({n / ms[0] * 1e3:.0f} chunks/s), plain {fmt(plain)}, "
        f"bound {b:.4f} ms ({by})")
    return dict(ms=ms[0], plain_ms=plain[0], bound_ms=b, bound_by=by, max_abs_err=err)


def phase_tokenizer_path(CB, model, x):
    import torch

    log(f"phase 5: tokenizer path, LipVQVAE.roundtrip_fused at {x.shape[0]} chunks")
    model.roundtrip_fused(x)  # warm
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        recon, idx = model.roundtrip_fused(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(CB.LAUNCHES)
    check(counts["lipvq_roundtrip"] == REQUESTS, f"roundtrip launches {counts}")
    check(recon.shape == x.shape and bool(torch.isfinite(recon).all()),
          "roundtrip_fused: recon is not finite or has the wrong shape")
    check(int(idx.min()) >= 0 and int(idx.max()) < 1024, "roundtrip_fused: codes out of range")
    med = statistics.median(times)
    log(f"  launches {counts}; median {med:.4f} ms per call "
        f"({x.shape[0] / med * 1e3:.0f} chunks/s with the weight preparation)")
    return counts


CAMS = ["robot0_agentview_left_image", "robot0_agentview_right_image",
        "robot0_eye_in_hand_image"]
LOW_DIM = {"robot0_base_to_eef_pos": (3,), "robot0_base_to_eef_quat": (4,),
           "robot0_base_pos": (3,), "robot0_base_quat": (4,),
           "robot0_gripper_qpos": (2,)}
SHAPES = {**LOW_DIM, **{c: (IMG, IMG, 3) for c in CAMS}, "lang_emb": (768,)}


def paper_config(pallas_pool=False):
    """icl_gmm_paper's own algo settings with the flagship observation spec;
    @pallas_pool selects the stem pool's recorded-argmax kernels."""
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory

    cfg = config_factory("icl_gmm_paper")
    with cfg.values_unlocked():
        cfg.train.pallas_pool = pallas_pool
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": CROP, "crop_width": CROP, "num_crops": 1, "pos_enc": False,
        }
    return cfg


def make_request(rng, b, t):
    def obs():
        o = {k: rng.randn(b, t, *s).astype(np.float32) for k, s in LOW_DIM.items()}
        o.update({c: rng.randint(0, 256, (b, t, IMG, IMG, 3), dtype=np.uint8)
                  for c in CAMS})
        o["lang_emb"] = rng.randn(b, t, 768).astype(np.float32)
        return o
    return obs(), {"obs": obs(), "actions": rng.uniform(-1, 1, (b, t, 12)).astype(np.float32)}


def phase_assign_backward(K, dev):
    """L2Nearest's codebook gradient (index_add_ of the z_q cotangent by
    code) against autograd through the plain gather, at the training path's
    assign shape: the context half's 32 x 16 rows, D = 976, K = 1024."""
    import torch

    log("phase 3b: assign backward (L2Nearest) vs plain autograd, N=512 D=976")
    gen = torch.Generator(dev).manual_seed(5)
    d = 976
    cb = (torch.rand(1024, d, generator=gen, device=dev) * 2 - 1) * (6.0 / d) ** 0.5
    z = torch.sigmoid(torch.randn(512, d, generator=gen, device=dev))
    w = torch.randn(512, d, generator=gen, device=dev)
    zk, cbk = z.clone().requires_grad_(True), cb.clone().requires_grad_(True)
    idx_k, zq = K.l2_nearest(zk, cbk)
    (zq * w).sum().backward()
    idx_p, _ = K.l2_nearest_plain(z, cb)
    check_assignments("N=512", idx_k, idx_p, near_ties(z, cb))
    cbp = cb.clone().requires_grad_(True)
    (cbp[idx_k.long()] * w).sum().backward()   # the same assignment, plain
    torch.cuda.synchronize()
    check(zk.grad is None, "z got a gradient through L2Nearest")
    # many rows share a code, so a codebook row's gradient is a sum of up to
    # hundreds of rows, added in another order: held relative to its size
    err = float((cbk.grad - cbp.grad).abs().max())
    gmax = float(cbp.grad.abs().max())
    log(f"  codebook grad max|kernel - plain| {err} (max|grad| {gmax:.3f}, "
        f"{int(idx_k.unique().numel())} codes used); z grad None")
    check(err <= 1e-5 * max(gmax, 1.0), f"codebook gradients differ by {err}")


def relu_input(shape, gen, dev):
    """randn - 0.25 after a ReLU: about 60 % zeros, so windows tie at 0."""
    import torch

    return torch.relu(torch.randn(shape, generator=gen, device=dev) - 0.25)


def phase_stem_pool(S, dev):
    import torch
    import torch.nn.functional as F

    log("phase 6: stem pool kernels vs plain (inputs after a ReLU)")
    gen = torch.Generator(dev).manual_seed(13)
    rows = {}
    for shape in POOL_SHAPES:
        x = relu_input(shape, gen, dev)
        hw = shape[2:]
        out_k, idx_k = S.pool_fwd_cuda(x)
        out_p, idx_p = S.pool_fwd_plain(x)
        g = torch.randn(out_k.shape, generator=gen, device=dev)
        dx_k = S.pool_bwd_cuda(idx_k, g, hw)
        dx_p = S.pool_bwd_plain(idx_p, g, hw)
        torch.cuda.synchronize()
        tag = "x".join(map(str, shape))
        n_idx = int((idx_k != idx_p).sum())
        fwd_err = float((out_k - out_p).abs().max())
        bwd_err = float((dx_k - dx_p).abs().max())
        gmax = float(g.abs().max())
        log(f"  {tag}: {float((x == 0).float().mean()):.3f} zeros; max|out err| "
            f"{fwd_err}, {n_idx} offsets differ; max|dx err| {bwd_err} "
            f"(max|g| {gmax:.3f})")
        check(torch.equal(out_k, out_p), f"{tag}: maxima differ")
        check(n_idx == 0, f"{tag}: {n_idx} offsets differ")
        check(bwd_err <= 1e-6 * gmax, f"{tag}: dx differs by {bwd_err}")
        if shape != POOL_SHAPES[0]:
            continue
        n_in, n_out = x.numel(), out_k.numel()
        _, lib_idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        timed = {
            "stem_pool_fwd": (
                lambda: S.pool_fwd_cuda(x), lambda: S.pool_fwd_plain(x),
                lambda: F.max_pool2d(x, 3, 2, 1, return_indices=True),
                # x read once; max (fp32) and offset (int8) written once; 8
                # compares per output
                (4 * n_in + 5 * n_out, 8 * n_out), fwd_err),
            "stem_pool_bwd": (
                lambda: S.pool_bwd_cuda(idx_k, g, hw), lambda: S.pool_bwd_plain(idx_p, g, hw),
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx),
                # offset and g read once, dx written once; one add per output
                (5 * n_out + 4 * n_in, n_out), bwd_err),
        }
        for name, (kern, plain, lib, (n_bytes, n_ops), err) in timed.items():
            ms, plain_ms, lib_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(lib)
            b, by = bound_ms(n_bytes, n_ops)
            log(f"  {name} at {tag}: kernel {fmt(ms)}, plain {fmt(plain_ms)}, "
                f"library {fmt(lib_ms)}, bound {b:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB)")
            rows[name] = dict(ms=ms[0], plain_ms=plain_ms[0], library_ms=lib_ms[0],
                              bound_ms=b, bound_by=by, max_abs_err=err)
    return rows


def phase_policy_path(CB, dev, profile):
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    log("phase 7: policy path, icl_gmm_paper get_action at full width")
    cfg = paper_config()
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)
    plain = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                              use_kernels=False)
    plain.nets.load_state_dict(algo.nets.state_dict())
    encoder = algo.nets["policy"].net.encoder
    tc = cfg.algo.transformer
    log(f"  {tc.num_layers} layers, width {tc.embed_dim}, {tc.num_heads} heads, "
        f"context {tc.context_length} ({3 * tc.context_length} tokens); LipVQ "
        f"latent {encoder.action_network.latent_dim}, "
        f"{encoder.action_network.quantizer.codebook.shape[0]} codes; "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters")
    check(encoder.action_network.latent_dim == 3 * 64 + 16 + 768, "LipVQ latent is not 976")

    rng = np.random.RandomState(0)
    t = tc.context_length
    requests = {b: [make_request(rng, b, t) for _ in range(REQUESTS)]
                for b in BATCHES}
    for b in BATCHES:  # warm: cuDNN plans, allocator
        algo.get_action(*requests[b][0])
        plain.get_action(*requests[b][0])
    torch.cuda.synchronize()

    def serve(model, obs, ctx):
        t0 = time.perf_counter()
        action = model.get_action(obs, ctx)
        torch.cuda.synchronize()
        return action, (time.perf_counter() - t0) * 1e3

    # the kernel model and the plain-quantizer model serve each request in
    # turns (plain, kernel, kernel, plain, ...); the plain model launches no
    # kernel, so the counts below are the kernel model's alone
    CB.reset_launch_counts()
    times = {}
    for b in BATCHES:
        times[b] = {"kernel": [], "plain": []}
        for r, (obs, ctx) in enumerate(requests[b]):
            order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
            for which in order:
                before = CB.LAUNCHES["lipvq_assign"]
                action, ms = serve(algo if which == "kernel" else plain, obs, ctx)
                times[b][which].append(ms)
                launched = CB.LAUNCHES["lipvq_assign"] - before
                check(launched == (which == "kernel"),
                      f"{which} model launched the assign kernel {launched} times")
                check(action.shape == (b, 12) and bool(torch.isfinite(action).all()),
                      f"B={b}: action {tuple(action.shape)} is not a finite [B, 12]")
    counts = dict(CB.LAUNCHES)
    check(counts["lipvq_assign"] == REQUESTS * len(BATCHES), f"assign launches {counts}")
    check(counts["stem_pool_fwd"] == 0, "the default stem launched the pool kernel")
    for b in BATCHES:
        for which in ("kernel", "plain"):
            ts = times[b][which]
            log(f"  B={b}: get_action ({which} quantizer) median "
                f"{statistics.median(ts):.3f} ms per request "
                f"(all: {', '.join(f'{v:.3f}' for v in ts)})")

    for b in BATCHES:
        obs, ctx = requests[b][-1]
        dist_k, loss_k = algo.action_distribution(obs, ctx)
        dist_p, loss_p = plain.action_distribution(obs, ctx)
        for name in ("means", "scales", "logits"):
            a, p = getattr(dist_k, name), getattr(dist_p, name)
            check(bool(torch.isfinite(a).all()), f"B={b} {name} not finite")
            err = float((a - p).abs().max())
            log(f"  B={b} {name}: max|kernel - plain| {err}")
            check(err <= 1e-4, f"B={b} {name}: kernel and plain models differ by {err}")
        acts = torch.as_tensor(ctx["actions"], device=dev).reshape(-1, 12)
        with torch.inference_mode():
            z_k, idx_k = encoder.action_network.encode(acts)
            _, idx_p = plain.nets["policy"].net.encoder.action_network.encode(acts)
        check_assignments(f"B={b} LipVQ codes",
                          idx_k, idx_p, near_ties(z_k, encoder.action_network.quantizer.codebook))
        log(f"  B={b} vq loss kernel {float(loss_k)} plain {float(loss_p)}")

    if profile:
        for b in BATCHES:
            obs, ctx = requests[b][0]
            device_profile(f"get_action B={b}", lambda: algo.get_action(obs, ctx))
    del plain
    serve_with_pool_switch(CB, dev, algo, requests[BATCHES[-1]][-1])
    return counts


def serve_with_pool_switch(CB, dev, algo, request):
    """One B = 16 request through a model with train.pallas_pool on and the
    weights of @algo (F.max_pool2d): the pool is exact, so the GMMs must be
    equal bit for bit, and kernel 3 must run once per stem: 3 cameras x the
    query and the context group."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo

    switch = Algo.algo_factory("icl_gmm_paper", paper_config(pallas_pool=True),
                               SHAPES, 12, device=dev)
    switch.nets.load_state_dict(algo.nets.state_dict())
    CB.reset_launch_counts()
    dist_s, _ = switch.action_distribution(*request)
    torch.cuda.synchronize()
    counts = dict(CB.LAUNCHES)
    dist_a, _ = algo.action_distribution(*request)
    log(f"  B={request[1]['actions'].shape[0]} with train.pallas_pool on: launches {counts}")
    check(counts["stem_pool_fwd"] == 6 and counts["stem_pool_bwd"] == 0,
          f"stem pool launches {counts}")
    for name in ("means", "scales", "logits"):
        err = float((getattr(dist_s, name) - getattr(dist_a, name)).abs().max())
        log(f"  {name}: max|pallas_pool - max_pool2d| {err}")
        check(torch.equal(getattr(dist_s, name), getattr(dist_a, name)),
              f"{name} differ by {err} with the pool switch on")


def make_train_batch(gen, dev):
    """A seeded synthetic training batch on the card: [64, 16] sequences of
    uint8 camera images, low-dim states, language embeddings and actions."""
    import torch

    def randn(*shape):
        return torch.randn((TRAIN_B, 16, *shape), generator=gen, device=dev)

    obs = {k: randn(*s) for k, s in LOW_DIM.items()}
    obs.update({c: torch.randint(0, 256, (TRAIN_B, 16, IMG, IMG, 3), generator=gen,
                                 device=dev, dtype=torch.uint8) for c in CAMS})
    obs["lang_emb"] = randn(768)
    actions = torch.rand((TRAIN_B, 16, 12), generator=gen, device=dev) * 2 - 1
    return {"obs": obs, "actions": actions}


def phase_training_path(CB, dev, profile):
    import gc

    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo

    log(f"phase 8: training path, icl_gmm_paper train_on_batch at full width, "
        f"B={TRAIN_B} T=16, train.pallas_pool on, random {CROP}x{CROP} crops, dropout 0.1")
    cfg = paper_config(pallas_pool=True)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)
    gen = torch.Generator(dev).manual_seed(21)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    algo.train_on_batch(batches[0], epoch=0)   # warm: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    CB.reset_launch_counts()
    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        losses = algo.train_on_batch(batch, epoch=0)["losses"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in losses.items()}
        log(f"  step: {', '.join(f'{k} {v:.6g}' for k, v in vals.items())}")
        check(all(np.isfinite(v) for v in vals.values()), f"metrics not finite: {vals}")
    counts = dict(CB.LAUNCHES)
    want = {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1, "lipvq_roundtrip": 0}
    log(f"  launches over {TRAIN_STEPS} steps {counts}; per step "
        f"{ {k: v / TRAIN_STEPS for k, v in counts.items()} }")
    for name, n in want.items():
        check(counts[name] == n * TRAIN_STEPS, f"{name}: {counts[name]} launches, "
              f"expected {n} per step")
    med = statistics.median(times)
    log(f"  median {med:.3f} ms per step ({TRAIN_B / med * 1e3:.1f} samples/s; all: "
        f"{', '.join(f'{v:.3f}' for v in times)}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if profile:
        device_profile("train step", lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))

    # one step of the kernel model and one of the plain model
    # (use_kernels=False) from the same weights, batch and random draws
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    res_k = one_step(algo, batches[0])
    del algo   # free the card for the plain model
    gc.collect()
    torch.cuda.empty_cache()
    plain = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                              use_kernels=False)
    plain.nets.load_state_dict(state)
    compare_steps(res_k, one_step(plain, batches[0]))
    return counts


def one_step(model, batch):
    """A training step with the crop and dropout generators seeded: (metrics,
    every parameter's gradient, the BatchNorm statistics)."""
    import torch

    model.generator.manual_seed(7)
    torch.manual_seed(7)   # dropout draws from the global generator
    losses = model.train_on_batch(batch, epoch=0)["losses"]
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.nets.named_parameters()}
    stats = {k: v.clone() for k, v in model.nets.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in losses.items()}, grads, stats


def compare_steps(res_k, res_p):
    """The kernel model's step against the plain model's: the two differ only
    where the kernels run, and the rest (cuDNN's backward, index_add_) may add
    in another order from run to run."""
    for k in ("action_loss", "vq_vae_loss", "policy_grad_norms"):
        rel = abs(res_k[0][k] - res_p[0][k]) / max(abs(res_p[0][k]), 1e-30)
        log(f"  {k}: kernel {res_k[0][k]!r} plain {res_p[0][k]!r} (rel {rel:.3g})")
        check(rel <= 1e-5, f"{k} differs by {rel} relative")
    worst = max(((res_k[1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in res_p[1].items())
    zero = [n for n, g in res_p[1].items() if not bool(g.abs().max() > 0)]
    bn = max(float((res_k[2][k] - v).abs().max()) for k, v in res_p[2].items())
    log(f"  gradients: max over {len(res_p[1])} tensors of max|kernel - plain| / "
        f"max|plain| {worst:.3g} ({len(zero)} all-zero, the LipVQ's); BatchNorm "
        f"statistics max|kernel - plain| {bn}")
    check(worst <= 1e-4, f"gradients differ by {worst} of their max")
    check(bn <= 1e-6, f"BatchNorm statistics differ by {bn}")


def device_profile(tag, fn, share=()):
    """Device time by kernel for one call of @fn (torch.profiler): busy time,
    idle share of the wall time, the top kernels, and the share of the busy
    time of kernels whose names contain one of @share."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    log(f"profile {tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}, {launches} device activities")
    if share:
        part = sum(v[0] for n, v in by_name.items() if any(s in n for s in share))
        log(f"  {' + '.join(share)}: {part:.3f} ms, {part / max(busy, 1e-9):.4f} of busy")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:90]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print device-time breakdowns of get_action and "
                             "of one training step")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB
        from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
        from robot_manipulation_vq_vae_tpu_torch.ops import stem_pool as S
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    log("TF32 off for matmul and cuDNN: every comparison and time is full fp32")

    card = nvidia_smi()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    seconds = CB.build_kernels()
    log(f"phase 2: kernels built in {seconds:.2f} s")
    for src in sorted({k[0] for k in CB.KERNELS.values()}):
        for line in CB.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    assign = phase_assign(K, dev)
    phase_assign_backward(K, dev)
    tok_model = tokenizer_model(dev)
    x = torch.randn(TOKENIZER_CHUNKS, 12, generator=torch.Generator(dev).manual_seed(7),
                    device=dev)
    roundtrip = phase_roundtrip(K, dev, tok_model, x)
    tok_counts = phase_tokenizer_path(CB, tok_model, x)
    del tok_model, x
    pool = phase_stem_pool(S, dev)
    torch.cuda.empty_cache()
    pol_counts = phase_policy_path(CB, dev, args.profile)
    torch.cuda.empty_cache()
    train_counts = phase_training_path(CB, dev, args.profile)

    # the assign kernel's row: the B = 16 request's shape, N = 16 x 16 rows
    main_assign = assign[(ASSIGN_DS[0], BATCHES[-1] * 16)]
    kernels = [
        dict(name="lipvq_assign", route="cuda", source=f"{SOURCE}/lipvq_assign.cu",
             replaces=f"{TPU_KERNELS}:39", launches=pol_counts["lipvq_assign"],
             library_ms=None, **main_assign),
        dict(name="lipvq_roundtrip", route="cuda",
             source=f"{SOURCE}/lipvq_roundtrip.cu", replaces=f"{TPU_KERNELS}:142",
             launches=tok_counts["lipvq_roundtrip"], library_ms=None, **roundtrip),
        dict(name="stem_pool_fwd", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:60", launches=train_counts["stem_pool_fwd"],
             **pool["stem_pool_fwd"]),
        dict(name="stem_pool_bwd", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:113", launches=train_counts["stem_pool_bwd"],
             **pool["stem_pool_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
