"""Drive the PyTorch port (robot_manipulation_vq_vae_tpu_torch) on one NVIDIA
card and check it.

    python3 chip_smoke.py            # what the checks need: one card
    python3 chip_smoke.py --profile  # also a device-time breakdown of get_action

Phases, each of which fails the run when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. the assign kernel against its plain version at D in {976, 210},
     K = 1024, N in {16, 256, 65536};
  4. the roundtrip kernel against its plain version on 65,536 x 12 chunks
     with weights ~N(0, 0.5^2);
  5. the tokenizer path: LipVQVAE.roundtrip_fused at 65,536 chunks;
  6. the policy path: icl_gmm_paper get_action at full width (6 layers, width
     512, 8 heads, context 16, 3 cameras of 128x128 cropped to 116, FiLM
     ResNet-18, LipVQ with 1024 codes over the 976-d encoder output), random
     weights from a seed, 3 requests at B = 1 and 3 at B = 16, held against
     the same model with the plain quantizer.
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
TIE_REL = 1e-5             # rows whose two best distances are closer may flip
MAX_FLIP_SHARE = 1e-3      # ... and at most 0.1% of the rows may

ASSIGN_DS, ASSIGN_NS = (976, 210), (16, 256, 65536)
TOKENIZER_CHUNKS = 65536
IMG, CROP = 128, 116       # camera images, center-cropped at eval
BATCHES = (1, 16)          # one env, and the 16-env batch
REQUESTS = 3
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


def phase_tokenizer_path(K, model, x):
    import torch

    log(f"phase 5: tokenizer path, LipVQVAE.roundtrip_fused at {x.shape[0]} chunks")
    model.roundtrip_fused(x)  # warm
    torch.cuda.synchronize()
    K.reset_launch_counts()
    times = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        recon, idx = model.roundtrip_fused(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(K.LAUNCHES)
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


def paper_config():
    """icl_gmm_paper's own algo settings with the flagship observation spec."""
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory

    cfg = config_factory("icl_gmm_paper")
    with cfg.values_unlocked():
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


def phase_policy_path(K, dev, profile):
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    log("phase 6: policy path, icl_gmm_paper get_action at full width")
    cfg = paper_config()
    ObsUtils.initialize_obs_utils_with_config(cfg)
    shapes = {**LOW_DIM, **{c: (IMG, IMG, 3) for c in CAMS}, "lang_emb": (768,)}
    algo = Algo.algo_factory("icl_gmm_paper", cfg, shapes, 12, device=dev)
    plain = Algo.algo_factory("icl_gmm_paper", cfg, shapes, 12, device=dev,
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
    K.reset_launch_counts()
    times = {}
    for b in BATCHES:
        times[b] = {"kernel": [], "plain": []}
        for r, (obs, ctx) in enumerate(requests[b]):
            order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
            for which in order:
                before = K.LAUNCHES["lipvq_assign"]
                action, ms = serve(algo if which == "kernel" else plain, obs, ctx)
                times[b][which].append(ms)
                launched = K.LAUNCHES["lipvq_assign"] - before
                check(launched == (which == "kernel"),
                      f"{which} model launched the assign kernel {launched} times")
                check(action.shape == (b, 12) and bool(torch.isfinite(action).all()),
                      f"B={b}: action {tuple(action.shape)} is not a finite [B, 12]")
    counts = dict(K.LAUNCHES)
    check(counts["lipvq_assign"] == REQUESTS * len(BATCHES), f"assign launches {counts}")
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
            profile_request(algo, requests[b][0])
    return counts


def profile_request(algo, request):
    """Device time by kernel for one request (torch.profiler): busy time,
    idle share of the wall time, top kernels."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algo.get_action(*request)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    log(f"profile B={request[1]['actions'].shape[0]}: wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
        f"{launches} device activities")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:90]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a device-time breakdown of get_action")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    log("TF32 off for matmul and cuDNN: every comparison and time is full fp32")

    card = nvidia_smi()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    seconds = K.build_kernels()
    log(f"phase 2: kernels built in {seconds:.2f} s")
    for name in K.LAUNCHES:
        for line in K.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    assign = phase_assign(K, dev)
    tok_model = tokenizer_model(dev)
    x = torch.randn(TOKENIZER_CHUNKS, 12, generator=torch.Generator(dev).manual_seed(7),
                    device=dev)
    roundtrip = phase_roundtrip(K, dev, tok_model, x)
    tok_counts = phase_tokenizer_path(K, tok_model, x)
    pol_counts = phase_policy_path(K, dev, args.profile)

    # the assign kernel's row: the B = 16 request's shape, N = 16 x 16 rows
    main_assign = assign[(ASSIGN_DS[0], BATCHES[-1] * 16)]
    kernels = [
        dict(name="lipvq_assign", route="cuda", source=f"{SOURCE}/lipvq_assign.cu",
             replaces=f"{TPU_KERNELS}:39", launches=pol_counts["lipvq_assign"],
             library_ms=None, **main_assign),
        dict(name="lipvq_roundtrip", route="cuda",
             source=f"{SOURCE}/lipvq_roundtrip.cu", replaces=f"{TPU_KERNELS}:142",
             launches=tok_counts["lipvq_roundtrip"], library_ms=None, **roundtrip),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
