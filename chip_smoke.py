"""Drive the PyTorch port (robot_manipulation_vq_vae_tpu_torch) on one NVIDIA
card and check it.

    python3 chip_smoke.py            # what the checks need: one card
    python3 chip_smoke.py --profile  # also device-time breakdowns of get_action
                                     # and of the training steps

Phases, each of which fails the run when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. the assign kernel against its plain version at D in {976, 210},
     K = 1024, N in {16, 256, 512, 65536} (each time with its achieved
     TFLOP/s and the tile width and splits the wrapper chose), and its
     backward (L2Nearest) against plain autograd at N = 512, D = 976;
  4. the roundtrip kernel against its plain version on 65,536 x 12 chunks
     with weights ~N(0, 0.5^2), timed with its achieved TFLOP/s;
  5. the tokenizer path: LipVQVAE.roundtrip_fused at 65,536 chunks;
  6. the stem pool's kernels (forward, backward) in fp32 against their plain
     versions at the paper training path's [512, 64, 58, 58], the flagship
     fp32 step's [1024, 64, 58, 58] (both timed) and at [2, 64, 57, 59], on
     inputs after a ReLU (about 60 % zeros, so windows tie): maxima, offsets
     and dx bit-equal; each timed forward with the path its launcher took
     (runs of whole planes or tiles, blocks, shared memory);
  6b. the stem pool's kernels in bf16 at the flagship's [1024, 64, 58, 58]:
     maxima, offsets and dx bit-equal to the plain versions;
  6c. kernel 5 (pool_route, the equality-routing pool backward) against its
     plain version at [3072, 64, 58, 58] in bf16 and fp32, on ReLU'd inputs
     (ties) and distinct values, bit-equal, each timed, with the path its
     launcher took (runs of whole planes or rows); the op's path,
     max_pool_3x3_s2 forward and backward, one launch per backward;
     [2, 64, 57, 59] takes torch's gradient and launches nothing;
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
     same weights, batch and random draws, held together;
  9. flagship serving: ICLTransformerHVQVAE get_action at bench_infer.py's
     configuration (ResNet-18, no language, center crop, HVQVAE-reconstructed
     context actions, fp32), 3 requests at B = 1 and 3 at B = 16;
  10. flagship training at bench_train.py's configuration (6 layers, width
     512, context 16, FiLM ResNet-18, HVQVAE 1024/512 codes, 2 x 4 layers,
     B = 64, T = 16, train.pallas_pool), in fp32 (10a) and in bf16 mixed
     precision (10b): a warm-up step with the k-means init, 3 timed steps
     (3 + 3 stem pool launches per step in the step's dtype), then a kernel
     step against a plain step with cuDNN's deterministic algorithms.
Each path runs with the launch counts set to 0 just before it and read just
after; a kernel of the path that was never launched fails the run.

TF32 is switched off for matmul and cuDNN: the fp32 comparisons and times are
full fp32, and the bf16 ones compare in bf16.
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
TPU_ROUTE = "robot_manipulation_vq_vae_tpu/ops/pallas/pool_kernel.py"
TIE_REL = 1e-5             # rows whose two best distances are closer may flip
MAX_FLIP_SHARE = 1e-3      # ... and at most 0.1% of the rows may

ASSIGN_DS, ASSIGN_NS = (976, 210), (16, 256, 512, 65536)
TOKENIZER_CHUNKS = 65536
IMG, CROP = 128, 116       # camera images, center-cropped at eval
BATCHES = (1, 16)          # one env, and the 16-env batch
REQUESTS = 3
# the flagship's stem pool input: 3 cameras of 64 x 16 frames per step, each
# [1024, 64, 58, 58]
FLAGSHIP_POOL = (1024, 64, 58, 58)
# the paper training path's stem pool input (3 cameras x 2 groups of 32 x 16
# frames per step, each [512, 64, 58, 58]), the flagship's in fp32, and a
# small odd shape; the first two are timed, the first feeds the kernels line
POOL_SHAPES = ((512, 64, 58, 58), FLAGSHIP_POOL, (2, 64, 57, 59))
# kernel 5's op at the flagship stem activation as the JAX package drives it
# (scripts/mfu_campaign.py, [3072, 58, 58, 64] NHWC), and a shape it must
# leave to torch's own gradient
ROUTE_SHAPE, ODD_SHAPE = (3072, 64, 58, 58), (2, 64, 57, 59)
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


def tflops(n_ops, ms):
    """Achieved fp32 rate of @n_ops operations in @ms, and its share of the
    card's 67 TFLOP/s."""
    rate = n_ops / ms / 1e9
    return f"{rate:.2f} TFLOP/s, {rate * 1e12 / FP32_PEAK:.3f} of {FP32_PEAK / 1e12:.0f}"


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
            flops = 2 * n * 1024 * d
            b, by = bound_ms((2 * n * d + 1024 * d + 1024 + n) * 4, flops)
            width, splits, _ = K._assign_splits(n, 1024, sms)
            log(f"  D={d} N={n}: kernel {fmt(ms)}, plain {fmt(plain)}, "
                f"bound {b:.4f} ms ({by}), max|err| {err}; {tflops(flops, ms[0])}; "
                f"{width}-code tiles, {splits} splits")
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
        f"bound {b:.4f} ms ({by}); {tflops(roundtrip_flops(n), ms[0])}; 64-row tiles, "
        "dense layers in 64- or 128-column passes, the argmin in 128-code tiles, "
        "no split")
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


def relu_input(shape, gen, dev, relu=True):
    """randn - 0.25 after a ReLU: about 60 % zeros, so windows tie at 0
    (with @relu False, plain randn: distinct values)."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev)
    return torch.relu(x - 0.25) if relu else x


def fwd_path(S, x):
    """The path kernel 3's launcher takes for @x, as its log line says it."""
    per_block, blocks, smem = S.pool_fwd_plan(x.shape, x.dtype)
    how = (f"runs of {per_block} whole planes a block" if per_block
           else "8 x 32 output tiles (planes past a block's budget)")
    return f"{how}, {blocks} blocks of {smem} B of shared memory"


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
        check(torch.equal(dx_k, dx_p), f"{tag}: dx differs by {bwd_err}")
        if shape not in POOL_SHAPES[:2]:
            continue
        n_in, n_out = x.numel(), out_k.numel()
        _, lib_idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        log(f"  stem_pool_fwd at {tag}: {fwd_path(S, x)}")
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
        timed_rows = time_kernels(timed, tag)
        if shape == POOL_SHAPES[0]:
            rows.update(timed_rows)
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
            device_profile(f"get_action B={b}", lambda: algo.get_action(obs, ctx),
                           share=("assign_kernel", "merge_kernel"))
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


def one_step(model, batch, deterministic=False):
    """A training step with the crop and dropout generators seeded (and, with
    @deterministic, cuDNN's deterministic algorithms): (metrics, every
    parameter's gradient, the floating buffers: BatchNorm statistics and, in
    the flagship, the HVQVAE's codebooks and EMA statistics)."""
    import torch

    model.generator.manual_seed(7)
    torch.manual_seed(7)   # dropout draws from the global generator
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        losses = model.train_on_batch(batch, epoch=0)["losses"]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = before
    grads = {n: p.grad.clone() for n, p in model.nets.named_parameters()}
    buffers = {k: v.clone() for k, v in model.nets.named_buffers()
               if v.is_floating_point()}
    return {k: float(v) for k, v in losses.items()}, grads, buffers


def compare_steps(res_k, res_p, keys=("action_loss", "vq_vae_loss", "policy_grad_norms"),
                  metric_tol=1e-5, grad_tol=1e-4, buffer_tol=1e-6):
    """The kernel model's step against the plain model's: the two differ only
    where the kernels run, and the rest (cuDNN's backward, index_add_) may add
    in another order from run to run. Metrics within @metric_tol relative,
    gradients within @grad_tol of each tensor's largest, buffers within
    @buffer_tol."""
    for k in keys:
        rel = abs(res_k[0][k] - res_p[0][k]) / max(abs(res_p[0][k]), 1e-30)
        log(f"  {k}: kernel {res_k[0][k]!r} plain {res_p[0][k]!r} (rel {rel:.3g})")
        check(rel <= metric_tol, f"{k} differs by {rel} relative")
    worst = max(((res_k[1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in res_p[1].items())
    zero = [n for n, g in res_p[1].items() if not bool(g.abs().max() > 0)]
    buf = max(float((res_k[2][k] - v).abs().max()) for k, v in res_p[2].items())
    log(f"  gradients: max over {len(res_p[1])} tensors of max|kernel - plain| / "
        f"max|plain| {worst:.3g} ({len(zero)} all-zero); buffers ({len(res_p[2])}: "
        f"BatchNorm statistics and codebooks) max|kernel - plain| {buf}")
    check(worst <= grad_tol, f"gradients differ by {worst} of their max")
    check(buf <= buffer_tol, f"buffers differ by {buf}")


# ---------------------------------------------------------------------------
# the bf16 stem pool, kernel 5, and the flagship ICLTransformerHVQVAE
# ---------------------------------------------------------------------------

def phase_stem_pool_bf16(S, dev):
    """Kernels 3 and 4 in bf16 at the flagship's mixed-precision stem
    activation: maxima, offsets and dx bit-equal to the plain versions."""
    import torch
    import torch.nn.functional as F

    log(f"phase 6b: stem pool kernels in bf16 vs plain at {FLAGSHIP_POOL} "
        "(inputs after a ReLU)")
    gen = torch.Generator(dev).manual_seed(17)
    x = relu_input(FLAGSHIP_POOL, gen, dev).bfloat16()
    hw = FLAGSHIP_POOL[2:]
    out_k, idx_k = S.pool_fwd_cuda(x)
    out_p, idx_p = S.pool_fwd_plain(x)
    g = torch.randn(out_k.shape, generator=gen, device=dev).bfloat16()
    dx_k = S.pool_bwd_cuda(idx_k, g, hw)
    dx_p = S.pool_bwd_plain(idx_p, g, hw)
    torch.cuda.synchronize()
    n_idx = int((idx_k != idx_p).sum())
    fwd_err = float((out_k.float() - out_p.float()).abs().max())
    bwd_err = float((dx_k.float() - dx_p.float()).abs().max())
    log(f"  {float((x == 0).float().mean()):.3f} zeros; max|out err| {fwd_err}, "
        f"{n_idx} offsets differ; max|dx err| {bwd_err}")
    check(torch.equal(out_k, out_p) and n_idx == 0, "bf16 maxima or offsets differ")
    check(torch.equal(dx_k, dx_p), f"bf16 dx differs by {bwd_err}")
    n_in, n_out = x.numel(), out_k.numel()
    _, lib_idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    log(f"  stem_pool_fwd_bf16 at {'x'.join(map(str, FLAGSHIP_POOL))}: {fwd_path(S, x)}")
    timed = {
        # x read once (2 bytes); max (2) and offset (1) written once
        "stem_pool_fwd_bf16": (
            lambda: S.pool_fwd_cuda(x), lambda: S.pool_fwd_plain(x),
            lambda: F.max_pool2d(x, 3, 2, 1, return_indices=True),
            (2 * n_in + 3 * n_out, 8 * n_out), fwd_err),
        # offset (1) and g (2) read once, dx (2) written once
        "stem_pool_bwd_bf16": (
            lambda: S.pool_bwd_cuda(idx_k, g, hw), lambda: S.pool_bwd_plain(idx_p, g, hw),
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx),
            (3 * n_out + 2 * n_in, n_out), bwd_err),
    }
    return time_kernels(timed, "x".join(map(str, FLAGSHIP_POOL)))


def time_kernels(timed, tag):
    """{name: (kernel, plain, library or None, (bytes, operations), err)} ->
    the kernels-line fields of each, measured now."""
    rows = {}
    for name, (kern, plain, lib, (n_bytes, n_ops), err) in timed.items():
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        b, by = bound_ms(n_bytes, n_ops)
        log(f"  {name} at {tag}: kernel {fmt(ms)}, plain {fmt(plain_ms)}, library "
            f"{fmt(lib_ms) if lib_ms else 'none'}, bound {b:.4f} ms ({by}, "
            f"{n_bytes / 1e6:.1f} MB); kernel {ms[0] / b:.2f} x the bound "
            f"(bound / kernel {b / ms[0]:.3f})")
        rows[name] = dict(ms=ms[0], plain_ms=plain_ms[0],
                          library_ms=lib_ms[0] if lib_ms else None,
                          bound_ms=b, bound_by=by, max_abs_err=err)
    return rows


def route_path(P, x):
    """The path kernel 5's launcher takes for @x, as its log line says it,
    and whether it is the plane runs."""
    per_block, blocks, smem = P.pool_route_plan(x.shape, x.dtype)
    how = (f"runs of {per_block} whole planes a block" if per_block
           else "a warp per input row (planes past a block's budget)")
    return f"{how}, {blocks} blocks of {smem} B of shared memory", per_block > 0


def phase_pool_route(CB, P, dev):
    """Kernel 5 against its plain version at the flagship stem activation in
    bf16 and fp32, on ReLU'd inputs (ties; the stem's real input) and
    distinct values, each timed; the odd shape takes torch's gradient; then
    the op's main path: max_pool_3x3_s2's forward and backward through
    autograd, one launch per backward."""
    import torch
    import torch.nn.functional as F

    log(f"phase 6c: pool_route (kernel 5) vs plain at {ROUTE_SHAPE}, bf16 and fp32")
    gen = torch.Generator(dev).manual_seed(19)
    tag = "x".join(map(str, ROUTE_SHAPE))
    rows, counts = {}, {}
    for dtype, name in ((torch.bfloat16, "pool_route_bf16"), (torch.float32, "pool_route")):
        for kind in ("relu", "distinct"):
            x = relu_input(ROUTE_SHAPE, gen, dev, kind == "relu").to(dtype)
            z = F.max_pool2d(x, 3, 2, 1)
            dz = torch.randn(z.shape, generator=gen, device=dev).to(dtype)
            dx_k = P.pool_route_cuda(x, z, dz)
            dx_p = P.pool_route_plain(x, z, dz)
            torch.cuda.synchronize()
            err = float((dx_k.float() - dx_p.float()).abs().max())
            log(f"  {name} {kind}: {float((x == 0).float().mean()):.3f} zeros, "
                f"max|dx err| {err}")
            check(torch.equal(dx_k, dx_p), f"{name} {kind}: dx differs by {err}")
            del dx_p, dx_k
            if kind == "relu":
                path, runs = route_path(P, x)
                log(f"  {name} at {tag}: {path}")
                check(runs, f"{name}: the stem's planes must take the plane runs")
            size = x.element_size()
            n_in, n_out = x.numel(), z.numel()
            timed = time_kernels({name: (
                lambda: P.pool_route_cuda(x, z, dz), lambda: P.pool_route_plain(x, z, dz),
                None,
                # x read and dx written once, z and dz read once; 4 compares and
                # 4 adds per input cell
                (size * (2 * n_in + 2 * n_out), 8 * n_in), err)}, f"{tag} {kind}")
            # the kernels line takes the ReLU'd input, the stem's real one
            if kind == "relu":
                rows.update(timed)
            del x, z, dz
            torch.cuda.empty_cache()

        # the op's main path: forward and backward through autograd
        x = relu_input(ROUTE_SHAPE, gen, dev).to(dtype).requires_grad_(True)
        CB.reset_launch_counts()
        out = P.max_pool_3x3_s2(x)
        (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
        torch.cuda.synchronize()
        counts[name] = CB.LAUNCHES[name]
        check(counts[name] == 1, f"max_pool backward launched {name} {counts[name]} times")
        check(bool(torch.isfinite(dx).all()) and dx.shape == x.shape, "max_pool dx")
        # every tied cell gets its window's cotangent: more than one per window
        log(f"  max_pool_3x3_s2 {dtype}: launches {dict(CB.LAUNCHES)}; routed "
            f"{float(dx.float().sum()):.0f} for {out.numel()} windows")
        check(float(dx.float().sum()) > out.numel(), "ties were not routed to every cell")
        del x, out, dx
        torch.cuda.empty_cache()

    x = relu_input(ODD_SHAPE, gen, dev, relu=False).requires_grad_(True)
    CB.reset_launch_counts()
    out = P.max_pool_3x3_s2(x)
    g = torch.randn(out.shape, generator=gen, device=dev)
    (dx,) = torch.autograd.grad(out, x, g)
    (dx_t,) = torch.autograd.grad(F.max_pool2d(x, 3, 2, 1), x, g)
    torch.cuda.synchronize()
    launched = CB.LAUNCHES["pool_route"] + CB.LAUNCHES["pool_route_bf16"]
    err = float((dx - dx_t).abs().max())
    log(f"  {ODD_SHAPE}: {launched} kernel 5 launches, max|dx - torch's| {err}")
    check(launched == 0 and err == 0.0, "the odd shape must take torch's own gradient")
    return rows, counts


def flagship_config(serving, mixed_precision=False):
    """bench_train.py's flagship (FiLM ResNet-18, language, random crops,
    train.pallas_pool) or bench_infer.py's (ResNet-18, no language, center
    crop): ICLTransformerHVQVAE at full width."""
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory

    cfg = config_factory("icl")
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ([] if serving else ["lang_emb"])
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = (
            "VisualCore" if serving else "VisualCoreLanguageConditioned")
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64,
            "backbone_class": "ResNet18Conv" if serving else "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32} if serving else {
                "num_kp": 32, "learnable_temperature": False, "temperature": 1.0,
                "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": CROP, "crop_width": CROP, "num_crops": 1, "pos_enc": False,
        }
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.causal = True, 16, False
        tc.supervise_all_steps = tc.pred_future_acs = True
        tc.vq_vae_enabled = True
        if not serving:
            tc.ln_act_enabled = True
            cfg.train.batch_size = TRAIN_B
            cfg.train.max_grad_norm = 100.0
            cfg.train.mixed_precision = mixed_precision
            cfg.train.pallas_pool = True
    return cfg


def flagship_shapes(serving):
    return {k: v for k, v in SHAPES.items() if not (serving and k == "lang_emb")}


def phase_flagship_serving(CB, dev, profile):
    """get_action of the flagship at bench_infer.py's configuration, B = 1
    and 16, fp32, HVQVAE-reconstructed context actions; no kernel runs."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    log("phase 9: flagship serving, ICLTransformerHVQVAE get_action (ResNet-18, "
        "no language, center crop, fp32)")
    cfg = flagship_config(serving=True)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl", cfg, flagship_shapes(True), 12, device=dev)
    tc, vq = cfg.algo.transformer, cfg.algo.transformer.vqvae
    log(f"  {type(algo).__name__}: {tc.num_layers} layers, width {tc.embed_dim}, "
        f"context {tc.context_length}; HVQVAE embed {vq.embed_dim}, codes "
        f"{vq.num_subclusters}/{vq.num_clusters}, {vq.num_stages}x{vq.num_layers_per_stage} "
        f"layers; {sum(p.numel() for p in algo.nets.parameters())} parameters")
    rng = np.random.RandomState(2)
    requests = {}
    for b in BATCHES:
        requests[b] = []
        for _ in range(REQUESTS):
            obs, ctx = make_request(rng, b, 16)
            obs.pop("lang_emb")
            requests[b].append((obs, {"actions": ctx["actions"]}))
        algo.get_action(*requests[b][0])   # warm: cuDNN plans, allocator
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    for b in BATCHES:
        times = []
        for obs, ctx in requests[b]:
            t0 = time.perf_counter()
            action = algo.get_action(obs, ctx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(action.shape == (b, 12) and bool(torch.isfinite(action).all())
                  and float(action.abs().max()) <= 1.0,
                  f"B={b}: action {tuple(action.shape)} is not a finite tanh [B, 12]")
        log(f"  B={b}: get_action median {statistics.median(times):.3f} ms per request "
            f"(all: {', '.join(f'{v:.3f}' for v in times)})")
    check(sum(CB.LAUNCHES.values()) == 0, f"serving launched {dict(CB.LAUNCHES)}")
    # what keeping the HVQVAE forward costs: the policy ignores its output
    # (XLA drops it from the JAX package's jitted get_action)
    vqvae = algo.nets["vqvae"]
    for b in BATCHES:
        acts = torch.as_tensor(requests[b][0][1]["actions"], device=dev)
        with torch.inference_mode():
            t = cuda_ms(lambda: vqvae(acts), iters=10, warmup=2, repeats=3)
        log(f"  B={b}: the HVQVAE reconstruction of the context actions, which the "
            f"policy ignores: {fmt(t)} per request (CUDA events over back-to-back "
            f"calls, host dispatch included)")
    # eval-mode BatchNorm: each environment's action is its own, whatever
    # the batch it is served in
    obs, ctx = requests[BATCHES[-1]][0]
    one = algo.get_action({k: v[:1] for k, v in obs.items()},
                          {"actions": ctx["actions"][:1]})
    err = float((one[0] - algo.get_action(obs, ctx)[0]).abs().max())
    log(f"  env 0 served alone vs in the B={BATCHES[-1]} batch: max|diff| {err}")
    check(err <= 1e-4, f"env 0's action depends on its batch: {err}")
    if profile:
        obs, ctx = requests[BATCHES[-1]][0]
        device_profile(f"flagship get_action B={BATCHES[-1]}",
                       lambda: algo.get_action(obs, ctx))


def phase_flagship_training(CB, dev, mixed_precision, profile):
    """train_on_batch of the flagship at bench_train.py's configuration, B =
    64, T = 16, train.pallas_pool on: a warm-up step (the k-means init) and 3
    timed steps, each launching the stem pool's kernels 3 + 3 times in the
    step's dtype; then a kernel-model step against a plain-model step."""
    import gc

    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    mode = "bf16 mixed precision" if mixed_precision else "fp32"
    log(f"phase 10{'b' if mixed_precision else 'a'}: flagship training, "
        f"ICLTransformerHVQVAE train_on_batch, {mode}, B={TRAIN_B} T=16, "
        f"train.pallas_pool on, random {CROP}x{CROP} crops, dropout 0.1")
    cfg = flagship_config(serving=False, mixed_precision=mixed_precision)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl", cfg, flagship_shapes(False), 12, device=dev)
    check(algo.mixed_precision == mixed_precision, "mixed_precision not taken")
    gen = torch.Generator(dev).manual_seed(23)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    algo.train_on_batch(batches[0], epoch=0)   # warm, and the k-means init
    torch.cuda.synchronize()
    log(f"  warm-up step with the k-means init: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(algo.nets["vqvae"]._initialized, "the codebooks were not initialized")
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
    suffix = "_bf16" if mixed_precision else ""
    want = {f"stem_pool_fwd{suffix}": 3, f"stem_pool_bwd{suffix}": 3}
    log(f"  launches over {TRAIN_STEPS} steps {counts}")
    for name, n in counts.items():
        check(n == want.get(name, 0) * TRAIN_STEPS,
              f"{name}: {n} launches, expected {want.get(name, 0)} per step")
    med = statistics.median(times)
    log(f"  median {med:.3f} ms per step ({TRAIN_B / med * 1e3:.1f} samples/s; all: "
        f"{', '.join(f'{v:.3f}' for v in times)}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    usage = algo.log_info({"losses": losses})
    log(f"  codebooks: Z {usage['VQ-VAE/Z_Utilization']} used, "
        f"{usage['VQ-VAE/Z_Dead_Codes']} dead; Q {usage['VQ-VAE/Q_Utilization']} used")
    if profile:
        device_profile(f"flagship train step {mode}",
                       lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))

    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    res_k = one_step(algo, batches[0], deterministic=True)
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    plain = Algo.algo_factory("icl", cfg, flagship_shapes(False), 12, device=dev,
                              use_kernels=False)
    plain.nets.load_state_dict(state)
    res_p = one_step(plain, batches[0], deterministic=True)
    tol = (1e-3, 1e-2, 1e-4) if mixed_precision else (1e-5, 1e-4, 1e-6)
    compare_steps(res_k, res_p, ("action_loss", "vqvae_loss", "policy_grad_norms",
                                 "vqvae_grad_norms"), *tol)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return counts


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
        from robot_manipulation_vq_vae_tpu_torch.ops import pool as P
        from robot_manipulation_vq_vae_tpu_torch.ops import stem_pool as S
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    log("TF32 off for matmul and cuDNN: the fp32 comparisons and times are full fp32")

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
    pool.update(phase_stem_pool_bf16(S, dev))
    torch.cuda.empty_cache()
    route, route_counts = phase_pool_route(CB, P, dev)
    torch.cuda.empty_cache()
    pol_counts = phase_policy_path(CB, dev, args.profile)
    torch.cuda.empty_cache()
    train_counts = phase_training_path(CB, dev, args.profile)
    torch.cuda.empty_cache()
    phase_flagship_serving(CB, dev, args.profile)
    torch.cuda.empty_cache()
    flagship = {mp: phase_flagship_training(CB, dev, mp, args.profile)
                for mp in (False, True)}

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
        # the bf16 instances: launches on the flagship's bf16 training path
        dict(name="stem_pool_fwd_bf16", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:60",
             launches=flagship[True]["stem_pool_fwd_bf16"],
             **pool["stem_pool_fwd_bf16"]),
        dict(name="stem_pool_bwd_bf16", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:113",
             launches=flagship[True]["stem_pool_bwd_bf16"],
             **pool["stem_pool_bwd_bf16"]),
        # kernel 5: launches on its op's path (max_pool_3x3_s2's backward)
        *(dict(name=name, route="cuda", source=f"{SOURCE}/pool_route.cu",
               replaces=f"{TPU_ROUTE}:50", launches=route_counts[name], **route[name])
          for name in ("pool_route", "pool_route_bf16")),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
