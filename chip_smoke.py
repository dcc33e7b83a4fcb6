"""Drive the PyTorch port (robot_manipulation_vq_vae_tpu_torch) on one NVIDIA
card and check it.

    python3 chip_smoke.py            # what the checks need: one card
    python3 chip_smoke.py --profile  # also device-time breakdowns of get_action,
                                     # the training steps (phase 20's bf16
                                     # ones too), a rollout lockstep, a
                                     # diffusion-policy request and an MCR
                                     # pretraining step

Phases, each of which fails the run when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. the assign kernel against its plain version at D in {976, 210},
     K = 1024, N in {10, 16, 160, 256, 320, 512, 65536} (each time with its achieved
     TFLOP/s and the tile width and splits the wrapper chose), and its
     backward (L2Nearest) against plain autograd at N = 512, D = 976;
  4. the roundtrip kernel against its plain version on 65,536 x 12 chunks
     with weights ~N(0, 0.5^2), timed with its achieved TFLOP/s;
  5. the tokenizer path: LipVQVAE.roundtrip_fused at 65,536 chunks;
  6. the stem pool's kernels (forward, backward) in fp32 against their plain
     versions at the paper training path's [512, 64, 58, 58], the flagship
     fp32 step's [1024, 64, 58, 58], phase 15's training shapes [100 | 1000
     | 320 | 640, 64, 58, 58], the diffusion policy's [200, 64, 58, 58]
     (phase 17) and the requests' [1 | 2 | 10 | 16 | 32 | 160 | 256, 64,
     58, 58] (all timed; [2] and [32] the diffusion policy's To = 2 frames) and at [2, 64, 57, 59], on
     inputs after a ReLU (about 60 % zeros, so windows tie): maxima, offsets
     and dx bit-equal; each timed forward with the path its launcher took
     (runs of whole planes or bands of rows, blocks, shared memory); the
     requests' forwards also by device time alone (graph_ms: calls
     replayed from a CUDA graph), beside F.max_pool2d's, and the wrapper's
     host us a call at [1]; R3M's stem shapes [1 | 16 | 100, 64, 112, 112]
     (the band kernel) bit-equal too; and MCR pretraining's stem [160, 64,
     112, 112] (rows 3h / 4g: kernel 3's band kernel, kernel 4 on whole
     planes, both asserted from their plans), bit-equal, timed back to back
     and by device time beside max_pool2d and its indices' backward;
  6b. the stem pool's kernels in bf16 at the paper's [512, 64, 58, 58],
     the flagship's [1024, 64, 58, 58] and phase 20's stems ([320 | 1000
     | 200 | 100, 64, 58, 58] and R3M's [1 | 16 | 100, 64, 112, 112], each
     on runs of whole planes, also by device time beside max_pool2d and
     its indices' backward): maxima, offsets and dx bit-equal to the plain
     versions, each timed; and at [2, 64, 160, 160], the band kernel's bf16
     instance, bit-equal;
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
     step against a plain step with cuDNN's deterministic algorithms;
  11. the flagship's first epoch from disk through the port's training entry
     point, scripts/train.train: 16 synthetic demos of 200 steps with the
     flagship's observations (3,200 frames, 472 MB of uint8 images) in an
     HDF5 file, or in a MemoryStore where h5py is missing, windows of 31
     steps gathered natively, copied through the pinned side-stream
     prefetcher, one bf16 epoch of 50 steps at B = 64 (3 + 3 bf16 stem pool
     launches per step), a .pth checkpoint with the optimizers; the epoch's
     samples/s, Train_Batch median (beside phase 10b's), Data_Loading share,
     host gather and H2D rates; the checkpoint, loaded into a fresh algo,
     serves a B = 16 request bit-equal to the trained model's;
  12. rollouts over a spawn-context pool of 16 fake envs (one frame a step:
     3 cameras of 128x128x3 uint8, 5 low-dim keys, a language string; the
     port's FrameStackWrapper stacks 16) with shared-memory observations:
     12a, icl_gmm_paper at phase 7's width with train.pallas_pool through
     ICLRolloutPolicy (observation and action statistics, a context window
     tiled to the envs) and run_batched_rollout, a warm-up of 2 steps and a
     timed pass of 25: actions/s, the lockstep median beside phase 7's B = 16
     get_action, the lockstep's split, 1 assign and 6 stem-pool launches per
     lockstep, the first and last lockstep replayed bit-equal to the echoed
     actions; 12b, phase 11's checkpoint through policy_from_checkpoint and
     rollout_with_stats (horizon 10; 3 fp32 stem-pool launches per lockstep),
     every echoed action bit-equal to the in-memory trained algo's on the
     recorded observations;
  13. the paper's other action tokenizers: icl_gmm_paper at phase 8's width
     with bin, LN-act, the default encoder and FAST (a deterministic stand-in
     for its processor and CLIP), LipVQ off, train.pallas_pool on: for each,
     a warm-up and 3 timed training steps at B = 64 (6 + 6 stem pool
     launches a step, no assign), the host syncs of one more step (torch's
     sync debug mode), a kernel step against a plain step (the
     bin statistics and spectral vectors within 1e-6), 3 requests at B = 1
     and 3 at B = 16, the B = 16 GMM bit-equal to the F.max_pool2d model's;
     the step and request medians beside phases 8 and 7, and FAST's host
     encoding share of a request;
  14. the opt-in training modes: 14a, the assign kernel's bf16 instance (a
     bf16 codebook, z in fp32 as the bf16 paper step gives it) against its
     plain version at D = 976, N in {256, 320, 512, 65536}, timed;
     14b, icl_gmm_paper's bf16 mixed-precision step at phase 8's width and
     batch (6 + 6 bf16 stem-pool launches and 1 bf16 assign a step, the
     median beside phase 8's, a kernel step against a plain step within
     phase 10b's bf16 tolerances), and two bf16 steps of each other
     tokenizer; 14c, the flagship with packed_rgb_encoders: an fp32 and a
     bf16 step under cuDNN's deterministic algorithms against the unpacked
     model's from one state (phase 10a's and 10b's tolerances; the bf16
     gradients, as one vector, no further apart than the unpacked bf16
     step's from its fp32 step's), the bf16 step's median
     beside phase 10b's, no stem-pool launch; 14d, flagship bf16 steps with
     frozen_batch_norm (the fresh statistics unchanged to the bit) and with
     pool_free_stem (no stem-pool launch), each median beside phase 10b's;
  15. the rest of the ICL family on phase 8's observations, fp32,
     train.pallas_pool on: 15a, ICL, ICLGaussian and ICLGMM at
     exps/templates/icl.json's widths (MLP [1024, 1024], 5 modes), B = 100:
     a warm-up and 3 timed steps (3 + 3 stem-pool launches a step), a
     kernel step against a plain step, 3 requests at B = 1 and 3 at B = 16,
     the B = 16 action bit-equal to the F.max_pool2d model's (the GMM
     sampled with injected draws); 15b, ICLRNN and ICLRNN_GMM (2-layer
     LSTM of 400, horizon 10), B = 100 x T = 10, trained as 15a, then 20
     stepwise get_action calls at B = 16 (the state reset at call 10), each
     bit-equal to the F.max_pool2d model's; 15c, icl_mamba's ICLMamba_GMM
     at its template's widths (6 Mamba layers of 512, context 10) with
     LipVQ, B = 64 (6 + 6 stem-pool launches and 1 assign a step), a kernel
     step against a plain step, requests, the Mamba backbone's forward and
     backward alone, then 1 + 2 steps with the template's LN-act tokenizer
     and with ICLMambaHVQVAE; every median beside phase 8's GPT step;
  16. the other vision cores and observation options, fp32,
     train.pallas_pool on: 16a, icl_gmm_paper at phase 8's width,
     observations and batch on ResNet-34 FiLM trunks with the crop and
     ColorRandomizer's defaults (6 + 6 stem-pool launches and 1 assign a
     step, the median beside phase 8's, the peak device memory, a kernel
     step against a plain step, 3 requests at B = 1 and 16, the B = 16 GMM
     bit-equal to the F.max_pool2d model's); 16b, the same on ResNet-50 FiLM
     trunks at B = 32 (R50_TRAIN_B says why); 16c, phase 15a's ICL policy on
     a frozen R3M ResNet-50 per camera (random trunk weights; 3 stem-pool
     forwards a step on [100, 64, 112, 112] and a request on [1 or 16, 64,
     112, 112], kernel 3's band kernel, no backward; the trunk unchanged to
     the bit; the B = 16 action bit-equal to the F.max_pool2d model's), and
     kernel 3 alone at each of those three shapes against its plain
     version, timed back to back and by device time alone beside
     F.max_pool2d, with the wrapper's host us a call at [1] (row 3g); 16d,
     the same policy on MVP's ViT-B
     (no kernel on that path); 16e, one step and one B = 16 request each
     with ResNet-18 (group norm, coord-conv, SpatialSoftmax with a learnable
     temperature and keypoint noise), ShallowConv + SpatialMeanPool,
     ResNet-18 FiLM with the cross-attention, ResNet-34, ResNet-50, Gaussian
     noise on the low-dim keys, and a ScanCore on a synthetic scan key, each
     with its stem-pool launches checked;
  17. the imitation baselines at their templates' widths on phase 8's
     observations (the FiLM ResNet-18 trunks, which all three take), fp32,
     train.pallas_pool on, B = 100, a warm-up and 2 timed steps each (3 + 3
     stem-pool launches a step), the peak device memory, requests at B = 1
     and 16, the B = 16 action bit-equal to the F.max_pool2d twin's with the
     same draws, and a kernel step against a plain step: 17a bc's
     BC_Transformer_GMM (GPT 6 x 512, context 10, 5 modes; windows of 10,
     [1000, 64, 58, 58]); 17b bc's BC_VAE ([100, ...]), then one step of
     BC_RNN_GMM (2-layer LSTM of 400, 100 x 10); 17c DiffusionPolicyUNet
     (the UNet 256 / 512 / 1024, To 2, Tp 16, EMA, GroupNorm trunks at
     [200, ...]): DDPM requests (100 UNet calls each) and DDIM ones (10);
     17d ACT (512 wide, 3200 feed-forward, 4 + 7 layers, chunk 10): after a
     reset, 11 calls at B = 1 and 16, the first and the last predicting a
     chunk (3 stem-pool launches), the others popping it (none);
  18. the offline-RL family at its templates' widths, fp32, B = 100: 18a
     IQL (actor and 2 critics [300, 400], Gaussian actor), 18b TD3-BC
     ([256, 256]; D4RL HalfCheetah's 17-d state, A = 6), 18c CQL ([300,
     400], tanh-Gaussian actor, 10 random actions), 18d BCQ (2 critics [300,
     400], a VAE sampler of latent 14, 10 candidates a backup and 100 a
     request, ensemble weight 0.75), each on robomimic Lift's low-dim keys
     (A = 7) but TD3-BC: a warm-up and 3 timed steps, 3 requests at B = 1
     and 16, no kernel; then one step and one request each of BCQ_GMM and
     BCQ_Distributional (51 atoms); 18e the four on phase 8's observations
     with train.pallas_pool: a warm-up and one timed step (the stem-pool
     launches and input shapes of each, the peak device memory under 60
     GiB; CQL's actor also pools [1000]: s and s' tiled 10 times), 3
     requests at B = 1 and 16 (BCQ's 100 candidates a row scored on each
     row's features, encoded once), the B = 16 action bit-equal to the
     F.max_pool2d twin's with the same draws, and a kernel step against a
     plain step from the same weights and optimizer state.
  19. the hierarchical family and MCR at their templates' widths, fp32, B =
     100 windows of 10 steps (the subgoal horizon and the actor's RNN
     horizon): 19a GL and GL_VAE (gl.json: [300, 400], latent 16) on
     robomimic Lift's low-dim keys, 1 + 2 steps, 3 subgoal predictions at
     B = 1 and 16; 19b HBC (GL_VAE planner, BC_RNN actor: LSTM 2 x 400,
     MLP [1024, 1024]) in separate and cascade modes and 19c IRIS (a
     ValuePlanner of GL_VAE and BCQ, 100 subgoals a row) on the same keys,
     1 + 2 steps and 20 stepwise get_action calls at B = 1 and 16, the
     subgoal refreshed at calls 0 and 10 alone; no kernel; 19d HBC
     (separate, cascade) and IRIS with the planner and actor on phase 8's
     observations, train.pallas_pool: 6 + 6 stem-pool launches a step
     (cascade 9 + 6) at [100] and [1000], 6 at a refresh and 3 at the other
     calls, every B = 16 call bit-equal to the F.max_pool2d twin's, a kernel
     step against a plain step from the same weights and optimizer state;
     19f MCR pretraining through scripts/train_mcr_representation.py at
     its defaults with --size 50 (32 quintuples of 224 x 224 frames: the
     stem at [160, 64, 112, 112], 1 + 1 launches a step), the
     script's first step with an evaluation and its snapshots, 2 timed
     steps, a kernel step against a plain step, the trunk exported; 19e
     the mcr policy (MCR_GMM, ResNet50Conv / SpatialSoftmax) on phase 8's
     cameras warm-started from that trunk through RMVQ_MCR_CKPT (each
     backbone equal to the export to the bit), 1 + 2 steps (3 + 3 launches
     at [100]), requests, the B = 16 action bit-equal to the twin's, a
     kernel step against a plain step.
  20. the bf16 training steps (train.mixed_precision) taken from the JAX
     package's transformer, GMM and diffusion steps, train.pallas_pool on:
     20a ICLMamba_GMM at 15c's configuration (6 + 6 bf16 stem-pool
     launches and 1 bf16 assign a step, N = 320), 20b BC_Transformer at
     17a's widths, B = 100 x 10 (its fp32 step timed beside it), 20c the
     diffusion policy at 17c's, 20d icl_gmm_paper on ResNet-34 and
     ResNet-50 FiLM with the crop and ColorRandomizer at B = 64 (the
     jitter's fp32 draws keep the trunks, and their pools, fp32; ResNet-50
     FiLM cut to 16b's B = 32 where B = 64 runs out of memory, which the
     log says), each a warm-up and 2 timed steps with its peak memory; 20e
     one bf16 step of BC_Transformer at B = 10 x 10 on each of 16e's cores
     and options and on frozen R3M (ResNet-50) and MVP (ViT-B) cores, then
     one MCR_Transformer step on mcr's ResNet-50 core. Every cell: the
     fp32 masters fp32 and moved, a B = 1 and a B = 16 request equal to
     the bit to the fp32-mode algo's from the same weights; 20a-20d and
     MCR_Transformer a kernel step against a plain step from the same
     state within phase 10b's bf16 tolerances (metrics 1e-3, gradients
     1e-2 of each tensor's max, buffers 1e-4). With --profile, one step of
     20a, 20c and 20d's ResNet-34 FiLM by kernel.
  21. the tokenizer zoo and the mesh: 21a VQVAE (128 codes), LFQVAE,
     LSTMVQVAE ([4096, 16, 12] windows), LFQQuantizerEMA and its k-means
     variant (1024 codes) and HierarchicalLFQHVQVAE (1024 / 512 codes, q_dim
     64, hidden 128) at the tokenizer bench's widths (feature 12, latent
     210): 3 training steps at N = 4096 (Adam where a class has parameters;
     the EMA updates, the k-means init and the dead-code replacement) against
     the use_kernel=False twin from the same state and draws (assignments
     equal but at near ties, losses, parameters and buffers), one eval
     forward of each at N = 65,536, kernel 1's launches on each path
     (1 a forward, 2 for the hierarchical one), kernel 1 alone at the zoo's
     (N, D, K); PRISE where the host has `tokenizers`; 21b make_mesh under
     nccl at dp = 1 in this process: 3 steps of the flagship (phase 10a's
     configuration) and of icl_gmm_paper (phase 8's) at B = 32 under
     shard_state equal to the bit to 3 unsharded steps, kernels 1, 3 and 4
     counted; 21c dp = 2 on the one card: two spawned processes over gloo
     (the collectives staged through pinned host memory), the same steps
     with dropout 0 and no crops, draw-free beside 22a (the flagship's
     codebooks seeded first),
     against one process's unsharded steps within tests/test_parallel.py's
     tolerances (the HVQVAE's codebook rows reported beside the unsharded
     steps' own drift under a 1e-6 change of its encoder's weights), each
     rank's launches; the steps after the first timed by CUDA events.
  22. the mesh with the shipped draws, serving under it, and mp > 1: two
     spawned processes on the one card over gloo, each cell on a pair of
     phases 23-25's pairs, its rank 0 taking the unsharded run itself from
     a deep copy of the algo it built. 22a dp = 2: 3 steps of
     the flagship as shipped (phase 10a: crops 128 -> 116, dropout 0.1 in
     the GPT and the HVQVAE, fp32, train.pallas_pool) and of icl_gmm_paper
     (phase 8's, dropout 0.1, the halves layout) at global B = 64, each
     draw taken at the global batch's shape, against one process's 3
     unsharded steps from the same state and generator state: metrics,
     weights and the policy's Adam moments within tests/test_parallel.py's
     tolerances, the HVQVAE's codebook rows reported; kernels 1, 3 and 4
     counted on each rank, the steps after the first timed by CUDA events;
     22b get_action at B = 16 on each rank's shards (the paper's GMM
     sampled from the gathered mixture) against unsharded serving from the
     same weights and generator state (max |diff| <= 1e-3); 22c (dp, mp) =
     (1, 2): the GPT tensor-parallel, 3 steps of 22a's flagship at B = 32
     (a 22a rank's: every mp rank takes the whole batch) against the same
     unsharded steps, a B = 16 request under mp against unsharded
     serving, and the mp run's .pth loaded into an unsharded algo serving
     the mp run's actions within 1e-5.
  23. the policy families at dp = 2: two spawned processes on the one card
     over gloo, each cell of MESH23_CELLS with its shipped draws, a B = 16
     request on the ranks' shards and 2 steps, against one process's
     unsharded request and steps from the same start state and generator
     state: 23a the flagship in bf16 and with packed trunks in bf16 (global
     B = 64), 23b icl_gmm_paper (B = 64, the halves layout) with bin, LN-act,
     the default encoder and FAST in fp32 and LipVQ in bf16, 23c
     ICLMamba_GMM with LipVQ in bf16 and ICLMambaHVQVAE, 23d BC_RNN_GMM,
     BC_VAE, BC_Transformer_GMM, the diffusion policy with DDIM requests
     (fp32 and bf16) and ACT at phase 17's B = 100. Each rank launches
     kernels 1, 3 and 4 as the unsharded run does, on half the rows; the
     requests within 1e-3, the fp32 steps within tests/test_parallel.py's
     bounds, the bf16 ones at fixed bounds (MESH23_BF16: metrics 1e-3
     relative, the gradients 0.1 of their norm at the first step and the
     last, each gradient tensor and Adam moment 0.5 of its own norm, at
     most 1 % of the BatchNorm statistics beyond 1e-4, the weights at
     test_parallel.py's bounds), with each rank's planted faults (its
     gradient not averaged, half of the batch left out) read above the
     gradients' bound and two witnesses reported (the unsharded step on
     the ranks' shapes, and with the dp step's arithmetic too), the ranks
     equal to the bit; each stem shape the ranks pooled held against the
     plain pool; each cell's dp = 2 / unsharded ratio of its second step.
  24. offline RL (IQL, TD3-BC, CQL, BCQ on phase 8's cameras), HBC and
     IRIS (19d's), MCR_GMM (19e's) and MCR pretraining (19f's) at dp = 2
     as phase 23: 2 steps and a request a cell, the states and Adam
     moments after the first step within tests/test_parallel.py's bounds
     (a weight element beyond them only by Adam's 2 lr), each rank's
     launches the unsharded run's on half the rows.
  25. every family at (dp, mp) = (1, 2), each GPT split as JAX's
     _param_spec splits it (ACT's style blocks too) and the rest replicated
     over mp (MESH25_CELLS, MESH25_NESTED): the flagship in bf16 and with
     packed trunks in bf16 and the paper with LipVQ in bf16 (B = 32, a
     phase-23 rank's batch: every mp rank takes the whole global batch),
     the paper with bin, LN-act, the default encoder and FAST (B = 32),
     BC_Transformer_GMM and ACT (B = 50, half of 23d's), MCR_Transformer on
     mcr's ResNet-50 core (20e's 10 x 10), ICLMamba_GMM with LipVQ in bf16
     (B = 32) and HBC (B = 50, half of 24's); 2 steps and a B = 16 request
     a cell against the unsharded run that the pair's rank 0 takes from a
     deep copy, at phase 23's and 24's bounds (bf16: MESH23_BF16's, without
     the dp step's planted faults), each rank's launches of kernels 1, 3
     and 4 the unsharded run's, the ranks equal to the bit, each rank's
     peak reserved memory logged, each stem shape held in phase 6 and
     against the plain pool; the mp = 2 / unsharded ratio of the second
     step.
Each path runs with the launch counts set to 0 just before it and read just
after; a kernel of the path that was never launched fails the run. The
kernels line gives each kernel's launches on every path that ran it.

TF32 is switched off for matmul and cuDNN: the fp32 comparisons and times are
full fp32, and the bf16 ones compare in bf16.
Output: one line per measurement, then a JSON line {"kernels": [...]}, the
card's name and power limit, and last {"ok": true, "device": {...}}. Exits
non-zero, printing no result, without a CUDA device or without the port.
"""

import argparse
import contextlib
import copy
import glob
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
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

# N: icl_mamba's B = 1 request (10 rows), a B = 16 paper request's 16 x 16
# rows, icl_mamba's B = 16 request (160), 256, icl_mamba's step (its context
# half, 32 x 10 rows), the paper step's 512, and the tokenizer's
ASSIGN_DS, ASSIGN_NS = (976, 210), (10, 16, 160, 256, 320, 512, 65536)
# kernel 1's bf16 instance: 14b's 512 rows, ICLMamba_GMM's bf16 step's 320
# (20a: its context half, 32 x 10 rows)
ASSIGN_NS_BF16 = (256, 320, 512, 65536)
TOKENIZER_CHUNKS = 65536
IMG, CROP = 128, 116       # camera images, center-cropped at eval
BATCHES = (1, 16)          # one env, and the 16-env batch
REQUESTS = 3
# the flagship's stem pool input: 3 cameras of 64 x 16 frames per step, each
# [1024, 64, 58, 58]
FLAGSHIP_POOL = (1024, 64, 58, 58)
# the paper training path's stem pool input (3 cameras x 2 groups of 32 x 16
# frames per step, each [512, 64, 58, 58]), the flagship's in fp32, the ICL
# family's training steps (phase 15: the MLP policies' 100 frames, the RNN
# policies' 100 x 10, icl_mamba's 32 x 10 a group, ICLMambaHVQVAE's 64 x
# 10; phase 17: BC_Transformer_GMM's 100 x 10, the diffusion policy's 100 x
# 2 on its GroupNorm trunks; phase 18e: the offline-RL steps' 100 and CQL's
# actor's 1000; phase 24: each of two dp ranks' half, 50 and 500), the
# requests' (an MLP or RNN policy's B = 1 and 16 frames,
# the offline-RL policies' too,
# the diffusion policy's 1 x 2 and 16 x 2, icl_mamba's 1 x 10 and 16 x 10 a
# group, the paper's 16 x 16 at B = 16 and in the rollout), and a small odd
# shape; all but the odd one are timed, the
# first feeds the kernels line
FAMILY_POOL_SHAPES = ((100, 64, 58, 58), (1000, 64, 58, 58), (320, 64, 58, 58),
                      (640, 64, 58, 58), (200, 64, 58, 58), (50, 64, 58, 58),
                      (500, 64, 58, 58))
REQUEST_POOL_SHAPES = tuple((n, 64, 58, 58) for n in (1, 2, 10, 16, 32, 160, 256))
POOL_SHAPES = ((512, 64, 58, 58), FLAGSHIP_POOL, *FAMILY_POOL_SHAPES,
               *REQUEST_POOL_SHAPES, (2, 64, 57, 59))
# kernel 5's op at the flagship stem activation as the JAX package drives it
# (scripts/mfu_campaign.py, [3072, 58, 58, 64] NHWC), and a shape it must
# leave to torch's own gradient
ROUTE_SHAPE, ODD_SHAPE = (3072, 64, 58, 58), (2, 64, 57, 59)
# 16c: R3M resizes the 116 x 116 crop to 256 and takes the center 224, so its
# stem pools [N, 64, 112, 112]: planes past a block's staging budget in fp32,
# which kernel 3's launcher gives to its band kernel. N is a request's B (1,
# 16) or the training step's B = 100 (exps/templates/icl.json's batch_size)
R3M_POOL_SHAPES = tuple((n, 64, 112, 112) for n in (*BATCHES, 100))
TRAIN_B, TRAIN_STEPS = 64, 3   # bench_train.py's batch; 3 timed steps
# phase 11's demos: 16 x 200 steps, 50 steps of B = 64 per epoch
EPOCH_DEMOS, DEMO_STEPS = 16, 200
# phase 12: 16 envs of 16 stacked frames (bench_infer.py's rollout leg),
# horizons 25 (12a) and 10 (12b)
ROLLOUT_ENVS, ROLLOUT_T, ROLLOUT_HORIZON, ROLLOUT_HORIZON_12B = 16, 16, 25, 10
ROLLOUT_LANG = "put the cup in the cabinet"
DEVICE = "cuda"


# where log() writes: stdout, or a list that a rank of phases 23 / 24 hands
# its parent, which prints each cell's lines in order (``mesh_cells_rank``)
LOG_SINK = None


def log(msg):
    if LOG_SINK is None:
        print(msg, flush=True)
    else:
        LOG_SINK.append(msg)


def check(ok, msg):
    """Fail the run unless @ok (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# each main-path run's launches: {path: {kernel: launches}}, for the
# kernels line's launches_by_path
PATH_LAUNCHES = {}


def record_path(path, counts):
    """Add @counts, the launches of one run of @path, to PATH_LAUNCHES."""
    total = PATH_LAUNCHES.setdefault(path, {})
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3, repeats=5, budget_ms=60.0):
    """Device time of @fn (CUDA events): the mean over @iters back-to-back
    calls (fewer for a slow @fn: as many as the warm-up's pace fits in
    @budget_ms, at least 3), repeated @repeats times. Returns (median, min,
    max) in ms."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pace = (time.perf_counter() - t) * 1e3 / max(warmup, 1)
    iters = max(min(3, iters), min(iters, int(budget_ms / max(pace, 1e-6))))
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


def graph_ms(fn, iters=20, repeats=5):
    """Device time of @fn without the host's share: @iters calls captured in
    one CUDA graph after a warm-up outside the capture, the graph replayed
    between CUDA events @repeats times. Returns (median, min, max) of the ms
    a call. The capture's calls are not launches of a path: LAUNCHES and
    PATH_LAUNCHES are restored to what they were."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB

    counts, paths = dict(CB.LAUNCHES), copy.deepcopy(PATH_LAUNCHES)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    CB.LAUNCHES.update(counts)
    PATH_LAUNCHES.clear()
    PATH_LAUNCHES.update(paths)
    graph.replay()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(means), min(means), max(means)


def wrapper_host_us(S, x, calls=200):
    """Host us a call of kernel 3's wrapper on @x, of each part of it, and of
    F.max_pool2d with its indices: the mean over @calls calls on the host
    clock, fewer than the launch queue holds, so that the host never waits
    for the card. The launches are not a path's: LAUNCHES is restored."""
    import torch
    import torch.nn.functional as F

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB

    counts = dict(CB.LAUNCHES)
    n, c, h, w = x.shape
    ho, wo = S.pooled_hw(h, w)
    name = CB.kernel_name("stem_pool_fwd", x.dtype)
    entry = getattr(CB.library(name), CB.KERNELS[name][1])
    out, idx = S.pool_fwd_cuda(x)
    args = (x.data_ptr(), n * c, h, w, out.data_ptr(), idx.data_ptr(), CB.stream_of(x))
    parts = {
        "wrapper": lambda: S.pool_fwd_cuda(x),
        "check_cuda_inputs": lambda: CB.check_cuda_inputs(name, (x,), dtypes=(x.dtype,)),
        "two torch.empty": lambda: (
            torch.empty(n, c, ho, wo, dtype=x.dtype, device=x.device),
            torch.empty(n, c, ho, wo, dtype=torch.int8, device=x.device)),
        "current stream": lambda: CB.stream_of(x),
        "ctypes call alone": lambda: entry(*args),
        "F.max_pool2d": lambda: F.max_pool2d(x, 3, 2, 1, return_indices=True),
    }
    us = {}
    for part, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[part] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    CB.LAUNCHES.update(counts)
    log(f"  host us a call at {'x'.join(map(str, x.shape))} ({calls} calls, host clock): "
        + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    return us


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
    record_path("phase 5 tokenizer", counts)
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


def paper_config(pallas_pool=False, mixed_precision=False, backbone="ResNet18ConvFiLM",
                 color=False):
    """icl_gmm_paper's own algo settings with the flagship observation spec;
    @pallas_pool selects the stem pool's recorded-argmax kernels,
    @mixed_precision the bf16 step, @backbone the cameras' FiLM trunk, and
    @color adds ColorRandomizer (its defaults) after the crop."""
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory

    cfg = config_factory("icl_gmm_paper")
    with cfg.values_unlocked():
        cfg.train.pallas_pool = pallas_pool
        cfg.train.mixed_precision = mixed_precision
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64, "backbone_class": backbone,
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        crop = {"crop_height": CROP, "crop_width": CROP, "num_crops": 1, "pos_enc": False}
        cfg.observation.encoder.rgb.obs_randomizer_class = (
            ["CropRandomizer", "ColorRandomizer"] if color else "CropRandomizer")
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = [crop, {}] if color else crop
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
    per_block, blocks, smem, rows = S.pool_fwd_plan(x.shape, x.dtype)
    how = (f"runs of {per_block} whole planes a block" if per_block
           else f"bands of {rows} output rows (planes past a block's budget)")
    return f"{how}, {blocks} blocks of {smem} B of shared memory"


def check_band_forward(S, x, tag):
    """Kernel 3 on @x through the band kernel (asserted from the plan):
    maxima and offsets bit-equal to the plain version, and kernel 4's dx
    from the band kernel's offsets bit-equal too. Returns max|out err|."""
    import torch

    plan = S.pool_fwd_plan(x.shape, x.dtype)
    check(plan[0] == 0 and plan[3] > 0, f"{tag}: kernel 3 took whole planes {plan}, "
          "not the band kernel")
    out_k, idx_k = S.pool_fwd_cuda(x)
    out_p, idx_p = S.pool_fwd_plain(x)
    g = torch.randn(out_k.shape, generator=torch.Generator(x.device).manual_seed(29),
                    device=x.device).to(x.dtype)
    dx_k = S.pool_bwd_cuda(idx_k, g, x.shape[2:])
    dx_p = S.pool_bwd_plain(idx_p, g, x.shape[2:])
    torch.cuda.synchronize()
    n_idx = int((idx_k != idx_p).sum())
    err = float((out_k.float() - out_p.float()).abs().max())
    check(torch.equal(out_k, out_p) and n_idx == 0,
          f"{tag}: band kernel differs (max|err| {err}, {n_idx} offsets)")
    check(torch.equal(dx_k, dx_p), f"{tag}: dx from the band kernel's offsets differs")
    log(f"  {tag} {str(x.dtype)[6:]} ({float((x == 0).float().mean()):.3f} zeros): maxima, "
        f"offsets and dx bit-equal; {fwd_path(S, x)}")
    return err


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
        if shape == POOL_SHAPES[-1]:
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
        request = shape in REQUEST_POOL_SHAPES
        timed_rows = time_kernels(timed, tag, graph=("stem_pool_fwd",) if request else ())
        if request and shape[0] == 1:
            wrapper_host_us(S, x)
        if shape == POOL_SHAPES[0]:
            rows.update(timed_rows)
    # R3M's stem (phase 16c), planes past a block's budget: the band kernel
    for shape in R3M_POOL_SHAPES:
        check_band_forward(S, relu_input(shape, gen, dev), "x".join(map(str, shape)))
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
                action, ms = served(algo if which == "kernel" else plain, obs, ctx)
                times[b][which].append(ms)
                launched = CB.LAUNCHES["lipvq_assign"] - before
                check(launched == (which == "kernel"),
                      f"{which} model launched the assign kernel {launched} times")
                check(action.shape == (b, 12) and bool(torch.isfinite(action).all()),
                      f"B={b}: action {tuple(action.shape)} is not a finite [B, 12]")
    counts = dict(CB.LAUNCHES)
    check(counts["lipvq_assign"] == REQUESTS * len(BATCHES), f"assign launches {counts}")
    check(counts["stem_pool_fwd"] == 0, "the default stem launched the pool kernel")
    record_path("phase 7 icl_gmm_paper serving", counts)
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
    serve_with_pool_switch(CB, dev, algo, requests[BATCHES[-1]][-1],
                           path="phase 7 icl_gmm_paper serving, train.pallas_pool")
    return counts, {b: statistics.median(times[b]["kernel"]) for b in BATCHES}


def serve_with_pool_switch(CB, dev, algo, request, path, switch=None):
    """One B = 16 request through a model with train.pallas_pool on
    (@switch, or a new paper model) and the weights of @algo (F.max_pool2d):
    the pool is exact, so the GMMs must be equal bit for bit, and kernel 3
    must run once per stem: 3 cameras x the query and the context group.
    The launches go to @path's in the kernels line."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo

    if switch is None:
        switch = Algo.algo_factory("icl_gmm_paper", paper_config(pallas_pool=True),
                                   SHAPES, 12, device=dev)
    switch.nets.load_state_dict(algo.nets.state_dict())
    CB.reset_launch_counts()
    dist_s, _ = switch.action_distribution(*request)
    torch.cuda.synchronize()
    counts = dict(CB.LAUNCHES)
    dist_a, _ = algo.action_distribution(*request)
    log(f"  B={request[1]['actions'].shape[0]} with train.pallas_pool on: launches {counts}")
    record_path(path, counts)
    check(counts["stem_pool_fwd"] == 6 and counts["stem_pool_bwd"] == 0,
          f"stem pool launches {counts}")
    for name in ("means", "scales", "logits"):
        err = float((getattr(dist_s, name) - getattr(dist_a, name)).abs().max())
        log(f"  {name}: max|pallas_pool - max_pool2d| {err}")
        check(torch.equal(getattr(dist_s, name), getattr(dist_a, name)),
              f"{name} differ by {err} with the pool switch on")


def make_train_batch(gen, dev, b=None, t=16):
    """A seeded synthetic training batch on the card: [@b (TRAIN_B), @t]
    sequences of uint8 camera images, low-dim states, language embeddings
    and actions."""
    import torch

    b = TRAIN_B if b is None else b

    def randn(*shape):
        return torch.randn((b, t, *shape), generator=gen, device=dev)

    obs = {k: randn(*s) for k, s in LOW_DIM.items()}
    obs.update({c: torch.randint(0, 256, (b, t, IMG, IMG, 3), generator=gen,
                                 device=dev, dtype=torch.uint8) for c in CAMS})
    obs["lang_emb"] = randn(768)
    actions = torch.rand((b, t, 12), generator=gen, device=dev) * 2 - 1
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
    record_path("phase 8 icl_gmm_paper training", counts)
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
    return counts, med


def algos_of(model):
    """@model, or the algos that a hierarchical one is made of (its planner,
    value network and actor)."""
    if hasattr(model, "generator"):
        return [model]
    return [a for name in ("planner", "value_net", "actor") if hasattr(model, name)
            for a in algos_of(getattr(model, name))]


def step_metrics(model, info):
    """A training step's metrics: its ``losses``, or a hierarchical algo's
    ``log_info`` (``Planner/...``, ``Actor/...``)."""
    return info["losses"] if "losses" in info else model.log_info(info)


def one_step(model, batch, deterministic=False):
    """A training step with the crop and dropout generators seeded (and, with
    @deterministic, cuDNN's deterministic algorithms): (metrics, every
    parameter's gradient, the floating buffers: BatchNorm statistics and, in
    the flagship, the HVQVAE's codebooks and EMA statistics)."""
    import torch

    for algo in algos_of(model):
        algo.generator.manual_seed(7)
    torch.manual_seed(7)   # the dropouts outside base_nets draw from the global one
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        losses = step_metrics(model, model.train_on_batch(batch, epoch=0))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = before
    # frozen tensors (the diffusion policy's EMA shadows) are left out; a
    # trained parameter without a gradient fails
    grads = {}
    for n, p in model.nets.named_parameters():
        if p.requires_grad:
            check(p.grad is not None, f"{n}: trained, but the step gave it no gradient")
            grads[n] = p.grad.clone()
    buffers = {k: v.clone() for k, v in model.nets.named_buffers()
               if v.is_floating_point()}
    return {k: float(v) for k, v in losses.items()}, grads, buffers


def grad_gap(res_a, res_b):
    """||a - b|| / ||b|| over the gradients of two steps as one vector."""
    diff_sq = sum(float(((res_a[1][n] - g).double() ** 2).sum()) for n, g in res_b[1].items())
    norm_sq = sum(float((g.double() ** 2).sum()) for g in res_b[1].values())
    return (diff_sq / max(norm_sq, 1e-300)) ** 0.5


def compare_steps(res_k, res_p, keys=("action_loss", "vq_vae_loss", "policy_grad_norms"),
                  metric_tol=1e-5, grad_tol=1e-4, buffer_tol=1e-6, grad_by_norm=False):
    """The kernel model's step against the plain model's: the two differ only
    where the kernels run, and the rest (cuDNN's backward, index_add_) may add
    in another order from run to run. Metrics within @metric_tol relative,
    gradients within @grad_tol of each tensor's largest, buffers within
    @buffer_tol. With @grad_by_norm the gradients are held as one vector
    instead, ``grad_gap`` within @grad_tol: for two steps whose convolutions
    round differently in bf16, where a tensor whose true gradient is 0 or
    cancels (SpatialSoftmax's keypoint bias: the softmax does not see a
    constant) holds rounding alone."""
    for k in keys:
        rel = abs(res_k[0][k] - res_p[0][k]) / max(abs(res_p[0][k]), 1e-30)
        log(f"  {k}: kernel {res_k[0][k]!r} plain {res_p[0][k]!r} (rel {rel:.3g})")
        check(rel <= metric_tol, f"{k} differs by {rel} relative")
    rel = sorted((((res_k[1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item(),
                  n) for n, g in res_p[1].items())
    worst = rel[-1][0]
    whole = grad_gap(res_k, res_p)
    zero = [n for n, g in res_p[1].items() if not bool(g.abs().max() > 0)]
    buf = max((float((res_k[2][k] - v).abs().max()) for k, v in res_p[2].items()),
              default=0.0)
    log(f"  gradients: max over {len(res_p[1])} tensors of max|kernel - plain| / "
        f"max|plain| {worst:.3g} ({len(zero)} all-zero; largest: "
        f"{', '.join(f'{n} {r:.3g}' for r, n in rel[-3:])}); as one vector "
        f"||kernel - plain|| / ||plain|| {whole:.3g}; buffers ({len(res_p[2])}: "
        f"BatchNorm statistics and codebooks) max|kernel - plain| {buf}")
    if grad_by_norm:
        check(whole <= grad_tol, f"gradients differ by {whole} of their norm")
    else:
        check(worst <= grad_tol, f"gradients differ by {worst} of their max")
    check(buf <= buffer_tol, f"buffers differ by {buf}")


# ---------------------------------------------------------------------------
# the bf16 stem pool, kernel 5, and the flagship ICLTransformerHVQVAE
# ---------------------------------------------------------------------------

# kernels 3 and 4 in bf16 at the stems of phase 20's bf16 steps: 20a
# ICLMamba_GMM's 32 x 10 frames a group, 20b BC_Transformer's 100 x 10, 20c
# the diffusion policy's 100 x 2, 20e's 10 x 10; and R3M's stem in bf16 at
# its request and training N (a 112 x 112 bf16 plane, 25,088 B, fits a
# block: runs of whole planes, not the band kernel fp32 takes there)
BF16_STEP_POOL_SHAPES = ((320, 64, 58, 58), (1000, 64, 58, 58), (200, 64, 58, 58),
                         (100, 64, 58, 58), *R3M_POOL_SHAPES)
# the bf16 stems of the meshes' ranks: the paper's LipVQ bf16 step at a
# global B = 32 (16 x 16 frames a group; a phase-23 rank's half of B = 64,
# phase 25's whole batch) and ICLMamba_GMM's (its context half, 16 x 10)
MESH_POOL_SHAPES_BF16 = ((256, 64, 58, 58), (160, 64, 58, 58))
# kernels 3 and 4 in bf16: the paper's mixed-precision step's stem
# activation, phase 20's shapes, the meshes', and the flagship's, which
# feeds the kernels line
POOL_SHAPES_BF16 = (POOL_SHAPES[0], *BF16_STEP_POOL_SHAPES, *MESH_POOL_SHAPES_BF16,
                    FLAGSHIP_POOL)
BF16_BAND_SHAPE = (2, 64, 160, 160)   # bf16 planes past a block's budget


def phase_stem_pool_bf16(S, dev):
    """Kernels 3 and 4 in bf16 at the stem activations of the paper's and
    the flagship's mixed-precision steps and of phase 20's bf16 steps:
    maxima, offsets and dx bit-equal to the plain versions, each shape timed
    with its bound, phase 20's also by device time alone (graph_ms) beside
    max_pool2d's and its indices' backward, and on runs of whole planes.
    Returns the flagship shape's kernels-line fields, and a row a shape for
    phase 20's ({kernel: [row, ...]})."""
    import torch
    import torch.nn.functional as F

    log(f"phase 6b: stem pool kernels in bf16 vs plain at {POOL_SHAPES_BF16} "
        "(inputs after a ReLU)")
    gen = torch.Generator(dev).manual_seed(17)
    rows, step_rows = {}, {"stem_pool_fwd_bf16": [], "stem_pool_bwd_bf16": []}
    for shape in POOL_SHAPES_BF16:
        tag = "x".join(map(str, shape))
        x = relu_input(shape, gen, dev).bfloat16()
        step_shape = shape in BF16_STEP_POOL_SHAPES
        if step_shape:
            check(S.pool_fwd_plan(shape, x.dtype)[0] > 0,
                  f"{tag}: kernel 3 took bands, not runs of whole bf16 planes")
        hw = shape[2:]
        out_k, idx_k = S.pool_fwd_cuda(x)
        out_p, idx_p = S.pool_fwd_plain(x)
        g = torch.randn(out_k.shape, generator=gen, device=dev).bfloat16()
        dx_k = S.pool_bwd_cuda(idx_k, g, hw)
        dx_p = S.pool_bwd_plain(idx_p, g, hw)
        torch.cuda.synchronize()
        n_idx = int((idx_k != idx_p).sum())
        fwd_err = float((out_k.float() - out_p.float()).abs().max())
        bwd_err = float((dx_k.float() - dx_p.float()).abs().max())
        log(f"  {tag}: {float((x == 0).float().mean()):.3f} zeros; max|out err| "
            f"{fwd_err}, {n_idx} offsets differ; max|dx err| {bwd_err}")
        check(torch.equal(out_k, out_p) and n_idx == 0,
              f"{tag}: bf16 maxima or offsets differ")
        check(torch.equal(dx_k, dx_p), f"{tag}: bf16 dx differs by {bwd_err}")
        n_in, n_out = x.numel(), out_k.numel()
        _, lib_idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        log(f"  stem_pool_fwd_bf16 at {tag}: {fwd_path(S, x)}")
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
        rows = time_kernels(timed, tag, graph=tuple(timed) if step_shape else ())
        if step_shape:
            for name, row in rows.items():
                step_rows[name].append(dict(row, shape=list(shape)))
        del x, out_k, idx_k, out_p, idx_p, g, dx_k, dx_p, lib_idx
    # the band kernel's bf16 instance: a bf16 plane passes a block's budget
    # from about 160 x 160
    check_band_forward(S, relu_input(BF16_BAND_SHAPE, gen, dev).bfloat16(),
                       "x".join(map(str, BF16_BAND_SHAPE)))
    return rows, step_rows


def time_kernels(timed, tag, graph=()):
    """{name: (kernel, plain, library or None, (bytes, operations), err)} ->
    the kernels-line fields of each, measured now; those named in @graph
    also by device time alone (graph_ms), the kernel and its library call."""
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
        if name in graph:
            g_ms, lib_g_ms = graph_ms(kern), graph_ms(lib)
            log(f"  {name} at {tag} by device time (a CUDA graph of 20 calls): kernel "
                f"{fmt(g_ms)}, library {fmt(lib_g_ms)}; kernel {g_ms[0] / b:.2f} x the "
                f"bound, {g_ms[0] / lib_g_ms[0]:.3f} x the library")
            rows[name].update(graph_ms=g_ms[0], library_graph_ms=lib_g_ms[0])
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
        record_path("phase 6c pool op", dict(CB.LAUNCHES))
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


def flagship_config(serving, mixed_precision=False, **train):
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
            for k, v in train.items():
                cfg.train[k] = v
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
    record_path(f"phase 10{'b' if mixed_precision else 'a'} flagship training", counts)
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
    return counts, med


def write_demos(f, rng):
    """The flagship's observations, actions [T, 12], the environment metadata
    and a language string per demo, into @f: an h5py File or a MemoryStore."""
    f.create_group("data").attrs["env_args"] = json.dumps(
        {"env_name": "Flagship", "type": 1, "env_kwargs": {}})
    for i in range(EPOCH_DEMOS):
        ep = f.create_group(f"data/demo_{i}")
        ep.attrs["num_samples"] = DEMO_STEPS
        ep.attrs["ep_meta"] = json.dumps({"lang": f"task {i % 4}"})
        for k, shape in LOW_DIM.items():
            ep.create_dataset(f"obs/{k}", data=rng.standard_normal(
                (DEMO_STEPS, *shape), dtype=np.float32))
        for c in CAMS:
            ep.create_dataset(f"obs/{c}", data=rng.integers(
                0, 256, (DEMO_STEPS, IMG, IMG, 3), dtype=np.uint8))
        ep.create_dataset("actions", data=rng.uniform(
            -1, 1, (DEMO_STEPS, 12)).astype(np.float32))


def epoch_config(data, output_dir):
    """Phase 10b's flagship (bf16, train.pallas_pool) trained from @data by
    scripts/train.py: windows of 2 x 16 - 1 steps (the first 16 observations,
    actions 15..30), one epoch of the loader, a checkpoint with the
    optimizers, no rollouts."""
    cfg = flagship_config(serving=False, mixed_precision=True)
    with cfg.values_unlocked():
        exp = cfg.experiment
        exp.name = "chip_smoke_epoch"
        exp.validate = False
        exp.logging.terminal_output_to_txt = False
        exp.logging.log_tb = False
        exp.rollout.enabled = False
        exp.epoch_every_n_steps = EPOCH_DEMOS * DEMO_STEPS // TRAIN_B
        exp.save.enabled = True
        exp.save.every_n_epochs = 1
        exp.save.include_optimizer = True
        cfg.train.data = data
        cfg.train.output_dir = output_dir
        cfg.train.num_data_workers = 2
        cfg.train.hdf5_cache_mode = "all"
        cfg.train.hdf5_load_next_obs = False
        cfg.train.dataset_keys = ["actions"]
        cfg.train.seq_length = 2 * cfg.algo.transformer.context_length - 1
        cfg.train.frame_stack = 1
        cfg.train.num_epochs = 1
    cfg.lock()
    return cfg


def phase_epoch(CB, dev, step_median):
    """One bf16 epoch of the flagship from a demo store through
    scripts/train.train, and its checkpoint served from a fresh algo.
    @step_median is phase 10b's step median (ms). Returns the launch counts,
    the trained algo (eval mode) and the checkpoint's dict."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch import native
    from robot_manipulation_vq_vae_tpu_torch.data import dataset as D
    from robot_manipulation_vq_vae_tpu_torch.data.memory_store import MemoryStore
    from robot_manipulation_vq_vae_tpu_torch.scripts import train as Train
    from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils

    steps = EPOCH_DEMOS * DEMO_STEPS // TRAIN_B
    log(f"phase 11: the flagship's first epoch from disk, scripts/train.train, bf16, "
        f"B={TRAIN_B}, {EPOCH_DEMOS} demos x {DEMO_STEPS} steps ({steps} steps)")
    rng = np.random.default_rng(31)
    opener, trained, step_ms = D.open_hdf5, {}, []
    cls = Algo.ICLTransformerHVQVAE
    step = cls.train_on_batch

    def timed_step(self, batch, epoch, validate=False):
        """The step as run_epoch's Train_Batch times it, kept per step."""
        trained["algo"] = self
        t0 = time.perf_counter()
        out = step(self, batch, epoch, validate)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_epoch_") as tmp:
        try:
            import h5py
        except ImportError:
            h5py = None
        t0 = time.perf_counter()
        if h5py is None:
            log("h5py absent: in-memory demo store")
            store = MemoryStore()
            write_demos(store, rng)
            D.open_hdf5 = lambda *args, **kwargs: store
            data = "memory-store"
        else:
            data = os.path.join(tmp, "demos.hdf5")
            with h5py.File(data, "w") as f:
                write_demos(f, rng)
            log(f"  HDF5 demo file: {os.path.getsize(data) / 1e6:.1f} MB")
        log(f"  demos written in {time.perf_counter() - t0:.2f} s")
        cfg = epoch_config(data, os.path.join(tmp, "out"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cls.train_on_batch = timed_step
        CB.reset_launch_counts()
        train_log = os.path.join(tmp, "train.log")
        try:
            # train() prints the config and the model; keep them out of the log
            with open(train_log, "w") as fh, contextlib.redirect_stdout(fh):
                t0 = time.perf_counter()
                history = Train.train(cfg)
                wall = time.perf_counter() - t0
        finally:
            del cls.train_on_batch
            D.open_hdf5 = opener
        with open(train_log) as fh:
            lines = fh.read().splitlines()
        log(f"  train() printed {len(lines)} lines; the last: {lines[-1] if lines else ''}")
        counts = dict(CB.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ckpts = glob.glob(os.path.join(tmp, "out", cfg.experiment.name, "*", "models",
                                       "model_epoch_1.pth"))
        check(len(ckpts) == 1, f"checkpoints written: {ckpts}")
        h = history[0]
        log(f"  launches over the epoch {counts}")
        record_path("phase 11 flagship bf16 epoch", counts)
        for name, n in counts.items():
            want = 3 * steps if name in ("stem_pool_fwd_bf16", "stem_pool_bwd_bf16") else 0
            check(n == want, f"{name}: {n} launches, expected {want}")
        check(len(step_ms) == steps and h["prefetch/batches"] == steps,
              f"{len(step_ms)} steps timed, {h['prefetch/batches']} batches consumed")
        check(np.isfinite(h["Loss"]) and np.isfinite(h["VQ-VAE/Total_Loss"]),
              f"epoch losses not finite: {h}")
        check(native.is_available(), "the native window gather is not the active path")
        check(bool(h["prefetch/pinned"]), "the prefetcher did not stage in pinned memory")
        epoch_s = h["Time_Epoch"] * 60
        med = statistics.median(step_ms)
        batches = h["prefetch/batches"]
        log(f"  epoch {epoch_s:.3f} s (train() {wall:.3f} s with set-up and the "
            f"checkpoint): {TRAIN_B * steps / epoch_s:.1f} samples/s over the epoch "
            f"(limit 128), {TRAIN_B * (steps - 1) / (epoch_s - step_ms[0] / 1e3):.1f} "
            f"without its first step; phase 10b's step: {TRAIN_B / step_median * 1e3:.1f}")
        log(f"  Train_Batch median {med:.3f} ms (phase 10b {step_median:.3f} ms, "
            f"{med / step_median:.3f} x); first step (k-means init) {step_ms[0]:.1f} ms; "
            f"loss {h['Loss']:.6g}")
        log(f"  Data_Loading (the wait for a batch on the card) "
            f"{h['Time_Data_Loading'] * 60:.3f} s, {h['Time_Data_Loading'] / h['Time_Epoch']:.4f}"
            f" of the epoch")
        log(f"  prefetcher per batch: host gather {h['prefetch/host_load_s'] / batches * 1e3:.3f}"
            f" ms, prepare {h['prefetch/host_process_s'] / batches * 1e3:.3f} ms, pinned "
            f"staging {h['prefetch/stage_s'] / batches * 1e3:.3f} ms, H2D "
            f"{h['prefetch/transfer_mbytes'] / batches:.1f} MB in "
            f"{h['prefetch/transfer_s'] / batches * 1e3:.3f} ms "
            f"({h['prefetch/transfer_mbytes_per_sec']:.1f} MB/s, CUDA events)")
        log(f"  native window gather active: {native.is_available()}; pinned side-stream "
            f"staging: {bool(h['prefetch/pinned'])}; peak device memory {peak:.2f} GiB")

        # the checkpoint in a fresh algo serves what the trained model serves
        model = trained.pop("algo")
        model.set_eval()
        fresh, ckpt = FileUtils.algo_from_checkpoint(ckpt_path=ckpts[0])
        log(f"  checkpoint {os.path.getsize(ckpts[0]) / 1e6:.1f} MB, "
            f"{len(ckpt['model']) - 1} tensors, step {ckpt['model']['training_state']['step']}")
        obs, ctx = make_request(np.random.RandomState(5), BATCHES[-1],
                                cfg.algo.transformer.context_length)
        ctx = {"actions": ctx["actions"]}
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            want = model.get_action(obs, ctx)
            got = fresh.get_action(obs, ctx)
        finally:
            torch.backends.cudnn.deterministic = before
        check(got.shape == (BATCHES[-1], 12) and bool(torch.isfinite(got).all()),
              f"get_action {tuple(got.shape)} not a finite [B, 12]")
        err = float((got - want).abs().max())
        log(f"  the reloaded checkpoint's get_action at B={BATCHES[-1]} vs the trained "
            f"model's: equal {torch.equal(got, want)} (max|diff| {err})")
        check(torch.equal(got, want), f"the reloaded model serves other actions: {err}")
        del fresh
    torch.cuda.empty_cache()
    return counts, model, ckpt


# ---------------------------------------------------------------------------
# phase 12: rollouts
# ---------------------------------------------------------------------------

class SmokeEnv:
    """A fake env for the rollout phases, at module level so that a spawned
    worker imports it (as ``__mp_main__`` when this file runs as a script).
    One frame a step: the 3 cameras of IMG x IMG x 3 uint8 (a frame of a
    seeded ring of 4, rolled by the step), the LOW_DIM keys (seeded, moved
    by the step); the language string in ``env_lang``; ``info`` echoes the
    action. The port's FrameStackWrapper stacks the frames, as for users.
    It never succeeds and never ends."""

    def __init__(self, env_name="SmokeEnv", render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False, seed=0, img=IMG,
                 env_lang=ROLLOUT_LANG, **kwargs):
        rng = np.random.default_rng(seed)
        self._imgs = {c: rng.integers(0, 256, (4, img, img, 3), dtype=np.uint8)
                      for c in CAMS}
        self._low = {k: rng.standard_normal(s, dtype=np.float32)
                     for k, s in LOW_DIM.items()}
        self.env_lang, self.name, self._t = env_lang, env_name, 0

    def _obs(self):
        obs = {c: np.roll(v[self._t % 4], self._t, axis=0) for c, v in self._imgs.items()}
        obs.update({k: v + np.float32(0.01 * self._t) for k, v in self._low.items()})
        return obs

    def reset(self):
        self._t = 0
        return self._obs()

    def step(self, action):
        self._t += 1
        return self._obs(), 1.0, False, {"action": np.array(action)}

    def is_success(self):
        return {"task": False}

    @property
    def action_dimension(self):
        return 12


def rollout_pool(n, frame_stack, obs_specs):
    """A spawn-context pool of @n SmokeEnvs with shared-memory observations,
    each stacking @frame_stack frames; the pool's echoed actions and the time
    of each step_batched are kept."""
    from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv
    from robot_manipulation_vq_vae_tpu_torch.utils.env_utils import EnvFactory

    class EchoPool(SubprocVectorEnv):
        def step_batched(self, actions):
            t0 = time.perf_counter()
            out = super().step_batched(actions)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.echoed.append(np.stack([info["action"] for info in out[3]]))
            return out

    factories = [EnvFactory({"env_name": "SmokeEnv", "type": -1,
                             "env_kwargs": {"seed": i, "img": IMG}},
                            obs_specs, frame_stack=frame_stack, env_class=SmokeEnv)
                 for i in range(n)]
    pool = EchoPool(factories, shared_obs=True)
    pool.echoed, pool.step_ms = [], []
    return pool


class Recorder:
    """A rollout policy that times each query and the algo's get_action in
    it (ending in a synchronize, as the action's copy to the host does), and
    keeps copies of the observation batch and the algo's generator state of
    the queries @keep names (indices into the queries), timing the copies
    (the smoke test's work, not the path's)."""

    def __init__(self, policy, keep=()):
        import torch

        self.policy, self.algo, self.keep = policy, policy.policy, set(keep)
        self.kept, self.starts, self.call_ms, self.get_action_ms = {}, [], [], []
        self.copy_ms = []
        get_action = self.algo.get_action

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = get_action(*args, **kwargs)
            torch.cuda.synchronize()
            self.get_action_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.algo.get_action = timed

    def start_episode(self, lang=None):
        self.policy.start_episode(lang)

    def __call__(self, ob, context_batch=None, batched=False):
        i = len(self.starts)
        t0 = time.perf_counter()
        if i in self.keep:   # the pool's shared block: copied before the next step
            self.kept[i] = ({k: np.array(v) for k, v in ob.items()},
                            self.algo.generator.get_state())
        self.copy_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        self.starts.append(t0)
        ac = self.policy(ob, context_batch=context_batch, batched=batched)
        self.call_ms.append((time.perf_counter() - t0) * 1e3)
        return ac

    def close(self):
        del self.algo.get_action


def rollout_report(tag, rec, step_ms, end, n_envs):
    """Log the lockstep's time split (@step_ms: the pass's step_batched
    times; the recorder's copies, which fall between two locksteps, are
    taken out); returns (lockstep median ms, actions/s, share of the
    lockstep outside get_action)."""
    lockstep = np.diff(np.array(rec.starts + [end])) * 1e3
    lockstep -= np.array(rec.copy_ms[1:] + [0.0])
    total = float(lockstep.sum())
    get_action, call = float(np.sum(rec.get_action_ms)), float(np.sum(rec.call_ms))
    step = float(np.sum(step_ms))
    outside = 1 - get_action / total
    fps = n_envs * len(lockstep) / (total / 1e3)
    med = float(np.median(lockstep))
    log(f"  {tag}: {len(lockstep)} locksteps of {n_envs} envs in {total:.3f} ms: "
        f"{fps:.1f} actions/s (rollout_fps); lockstep median {med:.3f} ms "
        f"(min {lockstep.min():.3f}, max {lockstep.max():.3f}); get_action median "
        f"{np.median(rec.get_action_ms):.3f} ms; the recorder's copies, not counted: "
        f"{sum(rec.copy_ms):.3f} ms")
    log(f"  {tag} split of the lockstep: get_action {get_action / total:.4f} (H2D, the "
        f"model, the action to the host); the rest of the policy query (normalization, "
        f"language and context tiling, unnormalization) {(call - get_action) / total:.4f}; "
        f"step_batched (the workers' step and frame stacking, the shared block, the "
        f"pipes) {step / total:.4f}; is_success and the loop {(total - call - step) / total:.4f}"
        f"; outside get_action {outside:.4f}")
    return med, fps, outside


def phase_rollout_paper(CB, dev, get_action_b16_ms, profile):
    """12a: the paper policy's batched rollout: icl_gmm_paper at phase 7's
    width with train.pallas_pool and 16 stacked frames, ICLRolloutPolicy
    with observation and action statistics and a context of one window
    tiled to the envs, run_batched_rollout over a spawned pool of 16 envs
    with shared memory: a warm-up pass of 2 steps, a timed pass of 25.
    Launches: 1 assign and 6 stem-pool forwards per lockstep. The first and
    last lockstep replayed from their recorded observations and generator
    states give the actions the envs echoed, bit for bit. With @profile,
    the device time of one lockstep (the query and the pool's step)."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as LangUtils
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
    from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils

    log(f"phase 12a: paper policy, batched rollout: {ROLLOUT_ENVS} spawned envs with "
        f"shared-memory observations, {ROLLOUT_T} stacked frames, horizon "
        f"{ROLLOUT_HORIZON} after a warm-up of 2")
    shm = os.statvfs("/dev/shm")
    log(f"  /dev/shm: {shm.f_blocks * shm.f_frsize / 2**20:.0f} MiB")
    cfg = paper_config(pallas_pool=True)
    with cfg.values_unlocked():
        cfg.train.frame_stack = ROLLOUT_T
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)
    rng = np.random.default_rng(41)
    obs_stats = {k: {"offset": rng.standard_normal((1, *s), dtype=np.float32),
                     "scale": rng.uniform(0.5, 2.0, (1, *s)).astype(np.float32)}
                 for k, s in LOW_DIM.items()}
    action_stats = {"actions": {"offset": rng.uniform(-0.1, 0.1, (1, 12)).astype(np.float32),
                                "scale": rng.uniform(0.5, 1.5, (1, 12)).astype(np.float32)}}
    policy = Algo.ICLRolloutPolicy(algo, obs_normalization_stats=obs_stats,
                                   action_normalization_stats=action_stats,
                                   lang_encoder=LangUtils.LangEncoder())
    _, ctx = make_request(np.random.RandomState(43), 1, ROLLOUT_T)
    t0 = time.perf_counter()
    pool = rollout_pool(ROLLOUT_ENVS, ROLLOUT_T, [cfg.observation.modalities.to_dict()])
    try:
        first = pool.reset_batched()
        start_s = time.perf_counter() - t0
        log(f"  pool start-up (spawn {ROLLOUT_ENVS} workers, first reset, shared block "
            f"of {sum(v.nbytes for v in first.values()) / 1e6:.1f} MB): {start_s:.3f} s")
        check(first[CAMS[0]].shape == (ROLLOUT_ENVS, ROLLOUT_T, IMG, IMG, 3),
              f"stacked images {first[CAMS[0]].shape}")
        del first
        TrainUtils.run_batched_rollout(policy, pool, horizon=2, context_batch=ctx)
        torch.cuda.synchronize()
        rec = Recorder(policy, keep=(0, ROLLOUT_HORIZON - 1))
        CB.reset_launch_counts()
        infos = TrainUtils.run_batched_rollout(rec, pool, horizon=ROLLOUT_HORIZON,
                                               context_batch=ctx)
        end = time.perf_counter()
        counts = dict(CB.LAUNCHES)
        rec.close()
        echoed = pool.echoed[-ROLLOUT_HORIZON:]
        step_ms = pool.step_ms[-ROLLOUT_HORIZON:]
        if profile:
            ob = pool.reset_batched()
            device_profile(f"rollout lockstep, {ROLLOUT_ENVS} envs (query and step)",
                           lambda: pool.step_batched(policy(ob, context_batch=ctx,
                                                            batched=True)),
                           share=("assign_kernel", "merge_kernel", "pool_fwd_kernel"))
    finally:
        pool.close()
    log(f"  launches over {ROLLOUT_HORIZON} locksteps {counts}")
    record_path("phase 12a paper rollout", counts)
    want = {"lipvq_assign": 1, "stem_pool_fwd": 6}
    for name, n in counts.items():
        check(n == want.get(name, 0) * ROLLOUT_HORIZON,
              f"{name}: {n} launches, expected {want.get(name, 0)} per lockstep")
    check(len(infos) == ROLLOUT_ENVS and all(i["Horizon"] == ROLLOUT_HORIZON
                                              and i["Return"] == ROLLOUT_HORIZON
                                              for i in infos), f"rollout results {infos[:2]}")
    check(len(echoed) == ROLLOUT_HORIZON and all(
        a.shape == (ROLLOUT_ENVS, 12) and np.isfinite(a).all() for a in echoed),
        "echoed actions are not finite [16, 12]")
    med, fps, outside = rollout_report("12a", rec, step_ms, end, ROLLOUT_ENVS)
    log(f"  lockstep median / phase 7's B={BATCHES[-1]} get_action median "
        f"{get_action_b16_ms:.3f} ms: {med / get_action_b16_ms:.3f} x (expected <= 1.3); "
        f"/ the rollout's own get_action median: {med / np.median(rec.get_action_ms):.3f} x")
    for i, (ob, state) in sorted(rec.kept.items()):
        algo.generator.set_state(state)
        replay = policy(ob, context_batch=ctx, batched=True)
        err = float(np.abs(replay - echoed[i]).max())
        log(f"  lockstep {i}: replayed actions vs the echoed: equal "
            f"{np.array_equal(replay, echoed[i])} (max|diff| {err})")
        check(np.array_equal(replay, echoed[i]), f"lockstep {i}: replay differs by {err}")
    del algo, policy
    return med, fps, outside


def phase_rollout_checkpoint(CB, dev, trained, ckpt):
    """12b: phase 11's checkpoint through policy_from_checkpoint to an
    ICLRolloutPolicy (fp32 get_action with the stem pool's fp32 kernel: 3
    launches per lockstep), rollout_with_stats over a spawned pool of 16
    envs of horizon 10; every echoed action equals, bit for bit, the action
    of phase 11's in-memory trained algo in the same rollout policy on the
    recorded observations."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
    from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils

    horizon = ROLLOUT_HORIZON_12B
    log(f"phase 12b: the flagship from phase 11's checkpoint, policy_from_checkpoint, "
        f"rollout_with_stats over {ROLLOUT_ENVS} spawned envs, horizon {horizon}")
    policy, _ = FileUtils.policy_from_checkpoint(ckpt_dict=ckpt)
    check(isinstance(policy, Algo.ICLRolloutPolicy), f"{type(policy).__name__}")
    cfg = policy.policy.global_config
    t = cfg.algo.transformer.context_length
    _, ctx = make_request(np.random.RandomState(47), 1, t)
    pool = rollout_pool(ROLLOUT_ENVS, t, [cfg.observation.modalities.to_dict()])
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rec = Recorder(policy, keep=range(horizon))
        CB.reset_launch_counts()
        logs, _ = TrainUtils.rollout_with_stats(rec, {"SmokeEnv": pool}, horizon=horizon,
                                                context_batch=ctx,
                                                num_episodes=ROLLOUT_ENVS)
        end = time.perf_counter()
        counts = dict(CB.LAUNCHES)
        rec.close()
        echoed = pool.echoed[-horizon:]
        log(f"  logs {json.dumps(logs['SmokeEnv'], sort_keys=True)}")
        check("Return" in logs["SmokeEnv"] and logs["SmokeEnv"]["Return"] == horizon,
              "an episode failed inside rollout_with_stats")
        log(f"  launches over {horizon} locksteps {counts}")
        record_path("phase 12b checkpoint rollout", counts)
        for name, n in counts.items():
            want = 3 * horizon if name == "stem_pool_fwd" else 0
            check(n == want, f"{name}: {n} launches, expected {want}")
        rollout_report("12b", rec, pool.step_ms[-horizon:], end, ROLLOUT_ENVS)
        # the in-memory trained algo in the same rollout policy
        same = Algo.ICLRolloutPolicy(
            trained, obs_normalization_stats=policy.obs_normalization_stats,
            action_normalization_stats=policy.action_normalization_stats,
            lang_encoder=policy.lang_encoder)
        same.start_episode(lang=ROLLOUT_LANG)
        for i in range(horizon):
            want = same(rec.kept[i][0], context_batch=ctx, batched=True)
            check(want.shape == (ROLLOUT_ENVS, 12) and np.array_equal(want, echoed[i]),
                  f"lockstep {i}: the trained algo's actions differ by "
                  f"{float(np.abs(want - echoed[i]).max())}")
        log(f"  the trained in-memory algo's actions on the {horizon} recorded observation "
            f"batches equal the echoed ones, bit for bit")
    finally:
        torch.backends.cudnn.deterministic = before
        pool.close()


# ---------------------------------------------------------------------------
# phase 13: the paper's other action tokenizers
# ---------------------------------------------------------------------------

MODALITIES = {"bin": "bin_enabled", "ln_act": "ln_act_enabled", "default": None,
              "fast": "fast_enabled"}


class SmokeFastProcessor:
    """A deterministic stand-in for the FAST processor (not in the
    repository, never downloaded): [1, T, A] actions -> [[2..13 token ids]]
    from a hash of the chunk, so both of resample_latents' branches run. The
    tests inject it too, into both packages' FastHostEncoder."""

    def __call__(self, actions_batch):
        chunk = np.asarray(actions_batch)[0]
        h = hashlib.sha256(np.round(chunk, 4).tobytes()).digest()
        return [[int.from_bytes(h[i:i + 2], "big") for i in range(2 + h[0] % 12)]]


def smoke_clip_encode(texts):
    """A deterministic stand-in for the CLIP text encoder: each text -> a
    vector in R^512 seeded by its hash."""
    out = np.zeros((len(texts), 512), np.float32)
    for i, text in enumerate(texts):
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
        out[i] = np.random.RandomState(seed).randn(512)
    return out


def host_syncs(fn):
    """How many times @fn makes the host wait for the card, as
    torch.cuda.set_sync_debug_mode sees it (a prototype: it may miss some)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def modality_algo(modality, dev, pallas_pool=True, use_kernels=True,
                  mixed_precision=False):
    """icl_gmm_paper at phase 8's width with @modality's tokenizer, LipVQ
    off; FAST gets the stand-in host stage."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import (
        FastHostEncoder,
    )
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = paper_config(pallas_pool=pallas_pool, mixed_precision=mixed_precision)
    with cfg.values_unlocked():
        tc = cfg.algo.transformer
        tc.vq_vae_enabled = False
        for name, flag in MODALITIES.items():
            if flag:
                tc[flag] = name == modality
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                             use_kernels=use_kernels)
    if modality == "fast":
        algo.set_fast_tokenizer(FastHostEncoder.from_components(
            SmokeFastProcessor(), smoke_clip_encode))
    return algo


def phase_modality(CB, dev, modality, profile):
    """One tokenizer of phase 13: train, kernel against plain, serve.
    Returns (step median, {B: request median}, FAST's host share or None)."""
    import gc

    import torch

    algo = modality_algo(modality, dev)
    tokenizer = algo.nets["policy"].net.encoder.action_network
    log(f"phase 13 {modality}: {type(tokenizer).__name__}, "
        f"{sum(p.numel() for p in tokenizer.parameters())} tokenizer parameters, "
        f"{sum(p.numel() for p in algo.nets.parameters())} in all; optimizers "
        f"{sorted(algo.optimizers)}")
    check(algo.nets["policy"].net.encoder.output_dim == 976, "the feature is not 976-d")
    check(set(algo.optimizers) == {"policy"}, f"optimizers {sorted(algo.optimizers)}")

    gen = torch.Generator(dev).manual_seed(21)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    algo.train_on_batch(batches[0], epoch=0)   # warm: cuDNN plans, allocator
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        losses = algo.train_on_batch(batch, epoch=0)["losses"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in losses.items()}
        check(set(vals) == {"log_probs", "action_loss", "policy_grad_norms"},
              f"metrics {sorted(vals)}")
        check(all(np.isfinite(v) for v in vals.values()), f"metrics not finite: {vals}")
    counts = dict(CB.LAUNCHES)
    log(f"  launches over {TRAIN_STEPS} steps {counts}")
    record_path(f"phase 13 {modality} training", counts)
    want = {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 0, "lipvq_roundtrip": 0}
    for name, n in want.items():
        check(counts[name] == n * TRAIN_STEPS, f"{modality} {name}: {counts[name]} "
              f"launches, expected {n} per step")
    step_ms = statistics.median(times)
    log(f"  train step median {step_ms:.3f} ms ({TRAIN_B / step_ms * 1e3:.1f} samples/s; "
        f"all: {', '.join(f'{v:.3f}' for v in times)}); last {vals}")
    # the batch is on the card: only FAST's host stage needs it back
    log(f"  host syncs in a training step: "
        f"{host_syncs(lambda: algo.train_on_batch(batches[0], epoch=0))}")
    if profile:
        device_profile(f"{modality} train step",
                       lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))
    buffers = {k: v for k, v in tokenizer.state_dict().items()
               if k.endswith(("running_min", "running_max", "num_step", ".u"))}
    for k, v in buffers.items():
        log(f"  {k}: {v.flatten()[:4].tolist()}")

    rng = np.random.RandomState(13)
    t = algo.context_length
    requests = {b: [make_request(rng, b, t) for _ in range(REQUESTS)] for b in BATCHES}
    for b in BATCHES:
        algo.get_action(*requests[b][0])
    torch.cuda.synchronize()
    request_ms, host_share = {}, None
    for b in BATCHES:
        ts = []
        for obs, ctx in requests[b]:
            CB.reset_launch_counts()
            t0 = time.perf_counter()
            action = algo.get_action(obs, ctx)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
            check(action.shape == (b, 12) and bool(torch.isfinite(action).all()),
                  f"B={b}: action {tuple(action.shape)} is not a finite [B, 12]")
            check(CB.LAUNCHES["stem_pool_fwd"] == 6 and CB.LAUNCHES["stem_pool_bwd"] == 0,
                  f"request launches {dict(CB.LAUNCHES)}")
            record_path(f"phase 13 {modality} serving", dict(CB.LAUNCHES))
        request_ms[b] = statistics.median(ts)
        line = (f"  B={b}: get_action median {request_ms[b]:.3f} ms "
                f"(all: {', '.join(f'{v:.3f}' for v in ts)})")
        if modality == "fast":
            host = []
            for _, ctx in requests[b]:
                t0 = time.perf_counter()
                algo._get_fast_tokenizer().encode_batch(ctx["actions"], seq_len=t)
                host.append((time.perf_counter() - t0) * 1e3)
            host_share = statistics.median(host) / request_ms[b]
            line += (f"; host FAST encode median {statistics.median(host):.3f} ms, "
                     f"{host_share:.3f} of the request")
        log(line)

    # the same weights with F.max_pool2d: the served GMM bit for bit
    twin = modality_algo(modality, dev, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    serve_with_pool_switch(CB, dev, twin, requests[BATCHES[-1]][-1],
                           f"phase 13 {modality} serving", switch=algo)
    del twin

    # one step of the kernel model and one of the plain model from the same
    # weights, batch and random draws; the tokenizer's buffers held as well
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    res_k = one_step(algo, batches[0])
    del algo, tokenizer
    gc.collect()
    torch.cuda.empty_cache()
    plain = modality_algo(modality, dev, use_kernels=False)
    plain.nets.load_state_dict(state)
    res_p = one_step(plain, batches[0])
    for k in buffers:
        key = f"policy.net.encoder.action_network.{k}"
        if res_p[2].get(key) is not None:
            err = float((res_k[2][key] - res_p[2][key]).abs().max())
            log(f"  {k} after the step: max|kernel - plain| {err}")
            check(err <= 1e-6, f"{k} differs by {err}")
    compare_steps(res_k, res_p, keys=("action_loss", "policy_grad_norms"))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return step_ms, request_ms, host_share


def phase_modalities(CB, dev, paper_step_ms, paper_request_ms, profile):
    """13: icl_gmm_paper at full width with each of the paper's other action
    tokenizers (bin, LN-act, the default encoder, FAST with a stand-in host
    stage), LipVQ off, train.pallas_pool on: a warm-up step and 3 timed
    steps at B = 64 (6 + 6 stem pool launches a step, no assign), the host
    syncs of a step, a kernel step against a plain step (tokenizer buffers
    within 1e-6), 3 requests
    at B = 1 and 3 at B = 16 (6 pool launches each), the B = 16 GMM bit-equal
    to the F.max_pool2d model's; each beside phases 7 and 8 (LipVQ)."""
    log(f"phase 13: the other action tokenizers in icl_gmm_paper at full width, "
        f"train.pallas_pool on, B={TRAIN_B} training, B in {BATCHES} serving")
    rows = {m: phase_modality(CB, dev, m, profile) for m in MODALITIES}
    log(f"  {'tokenizer':10s} {'step ms':>10s}"
        + "".join(f" {f'B={b} ms':>10s}" for b in BATCHES))
    rows = {"lipvq": (paper_step_ms, paper_request_ms, None), **rows}
    for m, (step_ms, req, host) in rows.items():
        extra = ("  (phases 8 and 7)" if m == "lipvq" else "" if host is None
                 else f"  (host FAST encode {host:.3f} of B={BATCHES[-1]})")
        log(f"  {m:10s} {step_ms:10.3f}" + "".join(f" {req[b]:10.3f}" for b in BATCHES)
            + extra)


# ---------------------------------------------------------------------------
# 14: the opt-in training modes
# ---------------------------------------------------------------------------

PAPER_ASSIGN_N = 512   # the paper step's context half, 32 x 16 rows


def phase_assign_bf16(K, dev):
    """14a: kernel 1's bf16 instance (a bf16 codebook, z in fp32 as the
    mixed-precision paper step gives it) against its plain version at
    D = 976, K = 1024, N in ASSIGN_NS_BF16: codes equal off near ties, z_q
    the code's fp32 value to the bit; timed with its bound."""
    import torch

    log("phase 14a: the assign kernel's bf16 instance vs plain, D=976 K=1024")
    rows = {}
    gen = torch.Generator(dev).manual_seed(14)
    d = ASSIGN_DS[0]
    cb = ((torch.rand(1024, d, generator=gen, device=dev) * 2 - 1)
          * (6.0 / d) ** 0.5).bfloat16()
    for n in ASSIGN_NS_BF16:
        z = torch.sigmoid(torch.randn(n, d, generator=gen, device=dev))
        tag = f"N={n}"
        idx_k, zq_k = K.l2_nearest_cuda(z, cb)
        idx_p, zq_p = K.l2_nearest_plain(z, cb)
        torch.cuda.synchronize()
        agree = check_assignments(tag, idx_k, idx_p, near_ties(z, cb.float()))
        check(zq_k.dtype == torch.float32 and torch.equal(zq_k, cb[idx_k.long()].float()),
              f"{tag}: z_q is not C[idx] in fp32")
        err = float((zq_k[agree] - zq_p[agree]).abs().max())
        check(err == 0.0, f"{tag}: z_q differs by {err} where the codes agree")
        ms = cuda_ms(lambda: K.l2_nearest_cuda(z, cb))
        plain = cuda_ms(lambda: K.l2_nearest_plain(z, cb))
        flops = 2 * n * 1024 * d
        # z and z_q fp32, the codebook bf16, c_sq and idx 4 bytes each
        b, by = bound_ms(2 * n * d * 4 + 1024 * d * 2 + 1024 * 4 + n * 4, flops)
        log(f"  N={n}: kernel {fmt(ms)}, plain {fmt(plain)}, bound {b:.4f} ms "
            f"({by}), max|err| {err}; {tflops(flops, ms[0])}")
        rows[n] = dict(ms=ms[0], plain_ms=plain[0], bound_ms=b, bound_by=by,
                       max_abs_err=err)
    return rows


def timed_steps(CB, algo, batches, tag, path):
    """A warm-up step, then the launch counts from 0 over len(@batches) - 1
    timed steps, added to @path's in the kernels line. Returns (counts,
    median ms, last metrics)."""
    import torch

    algo.train_on_batch(batches[0], epoch=0)   # warm: cuDNN plans, allocator
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        losses = step_metrics(algo, algo.train_on_batch(batch, epoch=0))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in losses.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"{tag}: metrics {vals}")
    counts = dict(CB.LAUNCHES)
    record_path(path, counts)
    med = statistics.median(times)
    b = len((batches[0]["actor"] if "actor" in batches[0] else batches[0])["actions"])
    log(f"  {tag}: median {med:.3f} ms per step ({b / med * 1e3:.1f} samples/s at B={b}; "
        f"all: {', '.join(f'{v:.3f}' for v in times)}); last {vals}; launches over "
        f"{len(times)} steps { {k: v for k, v in counts.items() if v} }")
    return counts, med, vals


def check_launches(tag, counts, per_step, steps):
    """Every kernel launched exactly @per_step[name] times a step (0 for the
    kernels not named)."""
    for name, n in counts.items():
        check(n == per_step.get(name, 0) * steps,
              f"{tag}: {name} launched {n} times, expected {per_step.get(name, 0)} a step")


def free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_paper_bf16(CB, dev, fp32_step_ms):
    """14b: icl_gmm_paper's bf16 mixed-precision step at phase 8's width and
    batch with LipVQ and train.pallas_pool: 6 + 6 bf16 stem-pool launches and
    one bf16 assign a step, the median beside phase 8's fp32 step, a kernel
    step against a plain step within phase 10b's bf16 tolerances; then two
    bf16 steps of each other tokenizer. Returns (launch counts, median)."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    log(f"phase 14b: icl_gmm_paper bf16 mixed precision, B={TRAIN_B} T=16, LipVQ, "
        f"train.pallas_pool on")
    cfg = paper_config(pallas_pool=True, mixed_precision=True)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)
    check(algo.mixed_precision, "mixed_precision not taken")
    gen = torch.Generator(dev).manual_seed(21)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    counts, med, vals = timed_steps(CB, algo, batches, "bf16 paper step",
                                    "phase 14b icl_gmm_paper bf16 training")
    check_launches("14b", counts, {"stem_pool_fwd_bf16": 6, "stem_pool_bwd_bf16": 6,
                                   "lipvq_assign_bf16": 1}, TRAIN_STEPS)
    check(set(vals) == {"log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss"},
          f"metrics {sorted(vals)}")
    check(all(p.dtype == torch.float32 for p in algo.nets.parameters()),
          "a master parameter is not fp32")
    log(f"  bf16 {med:.3f} ms against phase 8's fp32 {fp32_step_ms:.3f} ms a step "
        f"({med / fp32_step_ms:.3f} x)")
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    res_k = one_step(algo, batches[0], deterministic=True)
    del algo
    free_card()
    plain = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                              use_kernels=False)
    plain.nets.load_state_dict(state)
    res_p = one_step(plain, batches[0], deterministic=True)
    compare_steps(res_k, res_p, ("action_loss", "vq_vae_loss", "policy_grad_norms"),
                  1e-3, 1e-2, 1e-4)
    del plain, state
    free_card()
    for modality in MODALITIES:
        algo = modality_algo(modality, dev, mixed_precision=True)
        m_counts, m_med, m_vals = timed_steps(CB, algo, batches[:3], f"bf16 {modality} step",
                                              f"phase 14b {modality} bf16 training")
        check_launches(f"14b {modality}", m_counts,
                       {"stem_pool_fwd_bf16": 6, "stem_pool_bwd_bf16": 6}, 2)
        check(set(m_vals) == {"log_probs", "action_loss", "policy_grad_norms"},
              f"{modality} metrics {sorted(m_vals)}")
        del algo
        free_card()
    return counts, med


def flagship_algo(dev, use_kernels=True, **train):
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = flagship_config(serving=False, **train)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory("icl", cfg, flagship_shapes(False), 12, device=dev,
                             use_kernels=use_kernels)


def phase_flagship_packed(CB, dev, bf16_step_ms):
    """14c: the flagship with train.packed_rgb_encoders. From one state (an
    fp32 warm-up step: the k-means init), one step each of the unpacked and
    the packed model in fp32 and in bf16, under cuDNN's deterministic
    algorithms. Packed against unpacked at phase 10a's and 10b's
    tolerances, but for the bf16 gradients: grouped and separate bf16
    convolutions round differently, so those two steps are not the same
    sums, as 10b's kernel and plain steps are; their gradients, as one
    vector, may differ no more than the unpacked bf16 step's differ from
    its fp32 step (``compare_steps``). Then the packed bf16 step's median
    beside phase 10b's. The packed trunks launch no stem-pool kernel."""
    import torch

    log(f"phase 14c: flagship with packed_rgb_encoders, B={TRAIN_B} T=16")
    gen = torch.Generator(dev).manual_seed(23)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    warm = flagship_algo(dev)
    warm.train_on_batch(batches[0], epoch=0)   # the k-means init
    state = {k: v.clone() for k, v in warm.nets.state_dict().items()}
    del warm
    free_card()
    res = {}
    for mixed_precision in (False, True):
        for packed in (False, True):
            algo = flagship_algo(dev, mixed_precision=mixed_precision,
                                 packed_rgb_encoders=packed)
            algo.nets.load_state_dict(state)
            CB.reset_launch_counts()
            res[mixed_precision, packed] = one_step(algo, batches[1], deterministic=True)
            if packed:
                check(algo.nets["policy"].net.encoder.nets["obs"].packed_keys == CAMS,
                      "the three cameras were not packed")
                check(sum(CB.LAUNCHES.values()) == 0,
                      f"packed step launched {dict(CB.LAUNCHES)}")
            if not (mixed_precision and packed):
                del algo
                free_card()
    keys = ("action_loss", "vqvae_loss", "policy_grad_norms", "vqvae_grad_norms")
    log("  packed against unpacked, fp32:")
    compare_steps(res[False, True], res[False, False], keys, 1e-5, 1e-4, 1e-5)
    own = grad_gap(res[True, False], res[False, False])
    log(f"  packed against unpacked, bf16 (the unpacked bf16 step's gradients "
        f"against its fp32 step's, as one vector: {own:.3g}):")
    compare_steps(res[True, True], res[True, False], keys, 1e-3, own, 1e-4,
                  grad_by_norm=True)
    del res, state
    counts, med, _ = timed_steps(CB, algo, batches, "bf16 packed flagship step",
                                 "phase 14c packed flagship bf16 training")
    check_launches("14c", counts, {}, TRAIN_STEPS)
    log(f"  packed bf16 {med:.3f} ms against phase 10b's {bf16_step_ms:.3f} ms "
        f"({med / bf16_step_ms:.3f} x)")
    del algo
    free_card()
    return med


def phase_flagship_modes(CB, dev, bf16_step_ms):
    """14d: flagship bf16 steps with train.frozen_batch_norm (the BatchNorm
    statistics left as their bf16 copies, which for a fresh model's 0 and 1
    is unchanged to the bit; the stem pool's 3 + 3 bf16 launches a step)
    and with train.pool_free_stem (no stem-pool launch); each median beside
    phase 10b's."""
    import torch

    log(f"phase 14d: flagship bf16 with frozen_batch_norm, and with pool_free_stem, "
        f"B={TRAIN_B} T=16")
    gen = torch.Generator(dev).manual_seed(23)
    batches = [make_train_batch(gen, dev) for _ in range(TRAIN_STEPS + 1)]
    out = {}
    for mode, per_step in (("frozen_batch_norm",
                            {"stem_pool_fwd_bf16": 3, "stem_pool_bwd_bf16": 3}),
                           ("pool_free_stem", {})):
        algo = flagship_algo(dev, mixed_precision=True, **{mode: True})
        stats = lambda: {k: v.clone() for k, v in algo.nets.state_dict().items()  # noqa: E731
                         if k.endswith(("running_mean", "running_var"))}
        before = stats()
        counts, med, _ = timed_steps(CB, algo, batches, f"bf16 {mode} step",
                                     f"phase 14d flagship bf16 {mode}")
        check_launches(f"14d {mode}", counts, per_step, TRAIN_STEPS)
        after = stats()
        moved = sum(not torch.equal(before[k], v) for k, v in after.items())
        if mode == "frozen_batch_norm":
            check(moved == 0 and all(torch.equal(v, v.bfloat16().float())
                                     for v in before.values()),
                  f"{moved} BatchNorm statistics moved while frozen")
        else:
            check(moved > len(after) // 2, f"only {moved} of {len(after)} statistics moved")
        log(f"  {mode}: {med:.3f} ms against phase 10b's {bf16_step_ms:.3f} ms "
            f"({med / bf16_step_ms:.3f} x); {moved} of {len(after)} BatchNorm "
            f"statistics moved")
        out[mode] = med
        del algo
        free_card()
    return out


# ---------------------------------------------------------------------------
# 15: the rest of the ICL family
# ---------------------------------------------------------------------------

FAMILY_B = 100         # exps/templates/icl.json's batch_size (fixed above: 16c's R3M shapes)
RNN_T = 10             # the RNN policies' window: rnn.horizon of icl.json
MAMBA_T = 10           # algo.mamba.context_length of icl_mamba.json
RNN_CALLS = 20         # stepwise get_action calls: two horizons
FAMILY_MODES = {"plain": "ICL", "gaussian": "ICLGaussian", "gmm": "ICLGMM",
                "rnn": "ICLRNN", "rnn_gmm": "ICLRNN_GMM"}


def _observations(cfg, section=None):
    """Phase 8's observations on @cfg's observation @section (by default
    ``cfg.observation``)."""
    obs = cfg.observation if section is None else section
    obs.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
    obs.modalities.obs.rgb = CAMS
    paper = paper_config().observation.encoder.rgb
    obs.encoder.rgb.core_class = paper.core_class
    obs.encoder.rgb.core_kwargs = dict(paper.core_kwargs)
    obs.encoder.rgb.obs_randomizer_class = paper.obs_randomizer_class
    obs.encoder.rgb.obs_randomizer_kwargs = dict(paper.obs_randomizer_kwargs)


def family_algo(mode, dev, pallas_pool=True, use_kernels=True, configure=None,
                shapes=None):
    """An ``icl`` policy of @mode at exps/templates/icl.json's widths
    (``actor_layer_dims`` [1024, 1024], a 5-mode GMM; the RNN policies a
    2-layer LSTM of 400 over windows of 10, with no MLP as
    tests/test_icl_variants_parity.py sets them) on phase 8's observations,
    or on those that @configure (a function of the config) makes of them,
    of @shapes (SHAPES)."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory("icl")
    with cfg.values_unlocked():
        _observations(cfg)
        cfg.train.pallas_pool = pallas_pool
        cfg.algo.gaussian.enabled = mode == "gaussian"
        cfg.algo.gmm.enabled = mode in ("gmm", "rnn_gmm")
        cfg.algo.rnn.enabled = mode.startswith("rnn")
        cfg.algo.rnn.horizon = RNN_T
        if mode.startswith("rnn"):
            cfg.algo.actor_layer_dims = []
            cfg.train.seq_length = RNN_T
        if configure is not None:
            configure(cfg)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl", cfg, SHAPES if shapes is None else shapes, 12,
                             device=dev, use_kernels=use_kernels)
    check(type(algo).__name__ == FAMILY_MODES[mode], f"{mode}: {type(algo).__name__}")
    return algo


def mamba_algo(dev, tokenizer="lipvq", gmm=True, use_kernels=True, pallas_pool=True,
               mixed_precision=False):
    """``icl_mamba`` at exps/templates/icl_mamba.json's widths (6 Mamba
    layers of 512, d_state 16, context 10) on phase 8's observations:
    ``ICLMamba_GMM`` with LipVQ (1024 codes) or the template's LN-act
    tokenizer, or (not @gmm) ``ICLMambaHVQVAE`` with the template's HVQVAE;
    every step supervised (the GMM path folds the window's actions);
    @mixed_precision its bf16 step."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory("icl_mamba")
    with cfg.values_unlocked():
        _observations(cfg)
        cfg.train.pallas_pool = pallas_pool
        cfg.train.mixed_precision = mixed_precision
        cfg.algo.gmm.enabled = gmm
        mc = cfg.algo.mamba
        mc.context_length = MAMBA_T
        mc.supervise_all_steps = True
        mc.vq_vae_enabled = tokenizer == "lipvq" or not gmm
        mc.ln_act_enabled = tokenizer == "ln_act" and gmm
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory("icl_mamba", cfg, SHAPES, 12, device=dev,
                             use_kernels=use_kernels)


def request_obs(rng, b, t=None):
    """Observations of one request: [B, ...] (@t None) or [B, t, ...]."""
    obs, _ = make_request(rng, b, 1 if t is None else t)
    return {k: v[:, 0] for k, v in obs.items()} if t is None else obs


def served(algo, obs, ctx=None):
    """(action, host ms) of one request."""
    import torch

    t0 = time.perf_counter()
    out = algo.get_action(obs) if ctx is None else algo.get_action(obs, ctx)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def family_requests(CB, algo, rng, per_request, path, ctx_t=None, obs_t=None,
                    n=REQUESTS, start=None, times=None, make_obs=None, ac_dim=12):
    """@n requests at B = 1 and @n at B = 16 (a warm one first each): the
    launch counts of each (``per_request(b, call)``, added to @path's) and
    the medians. @ctx_t: the context window of a prompt-conditioned policy;
    @obs_t: the observation window of a policy that takes no context.
    @start: called before the warm request and again before the timed ones
    (ACT's reset); @times: filled with each B's times, in call order;
    @make_obs(rng, b): observations other than phase 8's; @ac_dim: the
    action's width."""
    medians = {}
    for b in BATCHES:
        reqs = [(request_obs(rng, b, ctx_t or obs_t) if make_obs is None else make_obs(rng, b),
                 make_request(rng, b, ctx_t)[1] if ctx_t else None)
                for _ in range(n + 1)]
        if start is not None:
            start()
        served(algo, *reqs[0])
        if start is not None:
            start()
        b_times = []
        for call, (obs, ctx) in enumerate(reqs[1:]):
            CB.reset_launch_counts()
            action, ms = served(algo, obs, ctx)
            b_times.append(ms)
            check(action.shape == (b, ac_dim) and bool(action.isfinite().all()),
                  f"B={b} call {call}: action {tuple(action.shape)}")
            check_launches(f"request B={b} call {call}", dict(CB.LAUNCHES),
                           per_request(b, call), 1)
            record_path(path, dict(CB.LAUNCHES))
        if times is not None:
            times[b] = b_times
        medians[b] = statistics.median(b_times)
        log(f"  B={b}: get_action median {medians[b]:.3f} ms "
            f"(all: {', '.join(f'{v:.3f}' for v in b_times)})")
    return medians


def same_draws(dist_a, dist_b, gen):
    """Two GMMs sampled with one injected mode and standard-normal draw."""
    import torch

    probs = torch.softmax(dist_a.logits, -1).reshape(-1, dist_a.logits.shape[-1])
    mode = torch.multinomial(probs, 1, generator=gen).reshape(dist_a.logits.shape[:-1])
    eps = torch.randn(dist_a.means.shape[:-2] + dist_a.means.shape[-1:], generator=gen,
                      device=dist_a.means.device)
    return dist_a.sample(mode=mode, eps=eps), dist_b.sample(mode=mode, eps=eps)


def family_train(CB, algo, batches, per_step, tag, path, keys):
    """A warm-up and the timed steps, @per_step launches a step and the
    metrics @keys asserted. Returns the median ms."""
    counts, med, vals = timed_steps(CB, algo, batches, tag, path)
    check_launches(tag, counts, per_step, len(batches) - 1)
    check(set(keys) <= set(vals), f"{tag}: metrics {sorted(vals)}")
    return med


def kernel_against_plain(algo, make_plain, batch, keys, tols=()):
    """One step of @algo and one of the plain model (@make_plain: its
    use_kernels=False twin) from the same state, batch and draws, under
    cuDNN's deterministic algorithms, within phase 8's tolerances (or
    @tols: ``compare_steps``' metric, gradient and buffer tolerances)."""
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    res_k = one_step(algo, batch, deterministic=True)
    del algo
    free_card()
    plain = make_plain()
    plain.nets.load_state_dict(state)
    compare_steps(res_k, one_step(plain, batch, deterministic=True), keys, *tols)
    del plain, state
    free_card()


def phase_family_mlp(CB, dev, gen, mode, card):
    """15a: one MLP policy: train, kernel against plain, serve, and the B = 16
    action against the F.max_pool2d model's."""
    import torch

    algo = family_algo(mode, dev)
    log(f"phase 15a {FAMILY_MODES[mode]}: actor_layer_dims "
        f"{list(algo.algo_config.actor_layer_dims)}, "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={FAMILY_B}")
    batches = [make_train_batch(gen, dev, FAMILY_B, 1) for _ in range(TRAIN_STEPS + 1)]
    batches = [algo.process_batch_for_training(b) for b in batches]
    keys = (("l2_loss", "action_loss", "policy_grad_norms") if mode == "plain"
            else ("log_probs", "action_loss", "policy_grad_norms"))
    name = FAMILY_MODES[mode]
    step_ms = family_train(CB, algo, batches,
                                   {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                                   f"15a {mode} step ({card})", f"phase 15a {name} training",
                                   keys)
    rng = np.random.RandomState(15)
    req_ms = family_requests(CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3},
                             f"phase 15a {name} serving")
    obs = request_obs(rng, BATCHES[-1])
    twin = family_algo(mode, dev, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    if mode == "gmm":
        got, want = same_draws(algo.action_distribution(obs), twin.action_distribution(obs),
                               torch.Generator(dev).manual_seed(5))
    else:
        got, want = algo.get_action(obs), twin.get_action(obs)
    check(torch.equal(got, want), f"{mode}: B=16 action differs from max_pool2d's by "
          f"{float((got - want).abs().max())}")
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    del twin
    kernel_against_plain(algo, lambda: family_algo(mode, dev, use_kernels=False),
                         batches[0], keys[1:])
    return step_ms, req_ms


def phase_family_rnn(CB, dev, gen, mode, card):
    """15b: one RNN policy: train on windows of 10, kernel against plain,
    then 20 stepwise get_action calls at B = 16 (the state carried, and
    reset at call 10), each bit-equal to the F.max_pool2d model's."""
    import torch

    algo = family_algo(mode, dev)
    rnn = algo.algo_config.rnn
    log(f"phase 15b {FAMILY_MODES[mode]}: {rnn.num_layers}-layer {rnn.rnn_type} of "
        f"{rnn.hidden_dim}, horizon {rnn.horizon}, "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, "
        f"B={FAMILY_B} T={RNN_T}")
    batches = [make_train_batch(gen, dev, FAMILY_B, RNN_T) for _ in range(TRAIN_STEPS + 1)]
    keys = (("l2_loss", "action_loss", "policy_grad_norms") if mode == "rnn"
            else ("log_probs", "action_loss", "policy_grad_norms"))
    name = FAMILY_MODES[mode]
    step_ms = family_train(CB, algo, batches,
                                   {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                                   f"15b {mode} step ({card})", f"phase 15b {name} training",
                                   keys)
    twin = family_algo(mode, dev, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    rng = np.random.RandomState(16)
    draws = torch.Generator(dev).manual_seed(6)
    times = []
    for p in (algo, twin):
        p.reset()
    for call in range(RNN_CALLS):
        obs = request_obs(rng, BATCHES[-1])
        CB.reset_launch_counts()
        t0 = time.perf_counter()
        got = (algo.action_distribution(obs) if mode == "rnn_gmm" else algo.get_action(obs))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_launches(f"15b call {call}", dict(CB.LAUNCHES), {"stem_pool_fwd": 3}, 1)
        record_path(f"phase 15b {name} stepwise serving", dict(CB.LAUNCHES))
        want = (twin.action_distribution(obs) if mode == "rnn_gmm" else twin.get_action(obs))
        if mode == "rnn_gmm":
            got, want = same_draws(got, want, draws)
        check(got.shape == (BATCHES[-1], 12) and torch.equal(got, want),
              f"{mode} call {call}: differs from max_pool2d's")
        check(algo._rnn_counter == call + 1 and (algo._rnn_hidden_state is not None),
              f"{mode}: the state was not carried at call {call}")
    req_ms = statistics.median(times)
    log(f"  {RNN_CALLS} stepwise get_action calls at B={BATCHES[-1]} (state reset at call "
        f"{RNN_T}): median {req_ms:.3f} ms (all: {', '.join(f'{v:.3f}' for v in times)}); "
        f"each bit-equal to the F.max_pool2d model's")
    del twin
    kernel_against_plain(algo, lambda: family_algo(mode, dev, use_kernels=False),
                         batches[0], keys[1:])
    return step_ms, {BATCHES[-1]: req_ms}


def mamba_backbone_ms(algo, batch_b, dev):
    """The Mamba backbone's forward and backward alone (CUDA events) on the
    step's tokens: [B/2, 3T, width]."""
    import torch

    backbone = algo.nets["policy"].net.transformer
    width = algo.algo_config.mamba.embed_dim
    x = torch.randn(batch_b // 2, 3 * MAMBA_T, width, device=dev, requires_grad=True)

    def fwd_bwd():
        y = backbone(x)
        torch.autograd.grad(y.sum(), [x, *backbone.parameters()])

    return cuda_ms(fwd_bwd, iters=3, warmup=1, repeats=3)


def phase_mamba(CB, dev, gen, card, gpt_step_ms, profile):
    """15c: icl_mamba's ICLMamba_GMM with LipVQ at the template's widths,
    B = 64: steps, kernel against plain, requests and the B = 16 GMM against
    the F.max_pool2d model's; then the template's LN-act tokenizer, and
    ICLMambaHVQVAE. Returns ({tag: step ms}, {B: request ms})."""
    import torch

    algo = mamba_algo(dev)
    mc = algo.algo_config.mamba
    log(f"phase 15c ICLMamba_GMM: {mc.num_layers} Mamba layers of {mc.embed_dim} "
        f"(d_state 16), context {mc.context_length} ({3 * mc.context_length} tokens), "
        f"LipVQ {algo._lipvq().quantizer.codebook.shape[0]} codes; "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={TRAIN_B}")
    batches = [make_train_batch(gen, dev, TRAIN_B, MAMBA_T) for _ in range(TRAIN_STEPS + 1)]
    keys = ("log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss")
    step_ms = family_train(
        CB, algo, batches, {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1},
        f"15c LipVQ step ({card})", "phase 15c ICLMamba_GMM LipVQ training", keys)
    mamba_ms = mamba_backbone_ms(algo, TRAIN_B, dev)
    log(f"  the Mamba backbone's forward + backward alone on [{TRAIN_B // 2}, "
        f"{3 * MAMBA_T}, {mc.embed_dim}]: {fmt(mamba_ms)} device time, "
        f"{mamba_ms[0] / step_ms:.3f} of the step's host-clock median")
    if profile:
        busy = device_profile("icl_mamba LipVQ train step",
                              lambda: algo.train_on_batch(batches[0], epoch=0),
                              share=("pool_fwd_kernel", "pool_bwd_kernel", "assign_kernel"))
        log(f"  the Mamba backbone alone / the step's device busy time: "
            f"{mamba_ms[0] / busy:.3f}")
    rng = np.random.RandomState(17)
    req_ms = family_requests(CB, algo, rng,
                             lambda b, call: {"stem_pool_fwd": 6, "lipvq_assign": 1},
                             "phase 15c ICLMamba_GMM LipVQ serving", ctx_t=MAMBA_T)
    obs, ctx = make_request(rng, BATCHES[-1], MAMBA_T)
    twin = mamba_algo(dev, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    got, want = same_draws(algo.action_distribution(obs, ctx)[0],
                           twin.action_distribution(obs, ctx)[0],
                           torch.Generator(dev).manual_seed(7))
    check(torch.equal(got, want), "icl_mamba: B=16 action differs from max_pool2d's")
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    del twin
    kernel_against_plain(algo, lambda: mamba_algo(dev, use_kernels=False), batches[0],
                         ("action_loss", "vq_vae_loss", "policy_grad_norms"))
    steps = {"ICLMamba_GMM LipVQ": step_ms}
    for tag, make, per_step in (
            ("ICLMamba_GMM LN-act", lambda: mamba_algo(dev, tokenizer="ln_act"),
             {"stem_pool_fwd": 6, "stem_pool_bwd": 6}),
            ("ICLMambaHVQVAE", lambda: mamba_algo(dev, gmm=False),
             {"stem_pool_fwd": 3, "stem_pool_bwd": 3})):
        other = make()
        log(f"phase 15c {tag}: {type(other).__name__}, "
            f"{sum(p.numel() for p in other.nets.parameters())} parameters")
        o_counts, steps[tag], _ = timed_steps(CB, other, batches[:3], f"15c {tag} ({card})",
                                              f"phase 15c {tag} training")
        check_launches(f"15c {tag}", o_counts, per_step, 2)
        del other
        free_card()
    log(f"  step medians ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items())
        + f"; phase 8's GPT step {gpt_step_ms:.3f} ms")
    return steps, req_ms


def phase_family(CB, dev, card, gpt_step_ms, profile):
    """15: the rest of the ICL family at full width (see the module
    docstring). Returns 15c's step medians ({tag: ms})."""
    import torch

    log(f"phase 15: the rest of the ICL family, phase 8's observations, fp32, "
        f"train.pallas_pool on ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(25)
    rows = {FAMILY_MODES[mode]: phase_family_mlp(CB, dev, gen, mode, card)
            for mode in ("plain", "gaussian", "gmm")}
    rows.update({FAMILY_MODES[mode]: phase_family_rnn(CB, dev, gen, mode, card)
                 for mode in ("rnn", "rnn_gmm")})
    steps, req_ms = phase_mamba(CB, dev, gen, card, gpt_step_ms, profile)
    log(f"  phase 15 medians ({card}), ms: policy, train step, get_action B=1, B=16")
    for name, (step_ms, req) in rows.items():
        log(f"  {name:14s} {step_ms:10.3f} {req.get(1, float('nan')):10.3f} "
            f"{req[BATCHES[-1]]:10.3f}")
    log(f"  {'ICLMamba_GMM':14s} {steps['ICLMamba_GMM LipVQ']:10.3f} {req_ms[1]:10.3f} "
        f"{req_ms[BATCHES[-1]]:10.3f}")
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    return steps


# ---------------------------------------------------------------------------
# 16: the other vision cores and observation options
# ---------------------------------------------------------------------------

# 16b's batch: ResNet-50 FiLM keeps about 29.3 MiB of activations for the
# backward per 116 x 116 fp32 image (autograd's saved tensors, counted on the
# CPU), 90 GiB for B = 64's 3,072 images, over the card's 80 GB; B = 32
# keeps half of that. (ResNet-34 FiLM: 9.9 MiB, 30 GiB at B = 64.)
R50_TRAIN_B = 32
SCAN_KEY, SCAN_LEN = "robot0_lidar_scan", 360   # 16e's synthetic scan, one beam a degree
CORE_STEPS = 2   # 16b-16d: a warm-up and 2 timed steps


def trunk_of(algo):
    """The first camera's backbone in @algo's policy."""
    return next(m.backbone for m in algo.nets["policy"].modules()
                if hasattr(m, "backbone") and hasattr(m, "head"))


def phase_paper_core(CB, dev, card, backbone, b, steps, paper_step_ms, profile):
    """16a / 16b: icl_gmm_paper at phase 8's width and observations on
    @backbone FiLM trunks with the crop and ColorRandomizer's defaults, B =
    @b, T = 16, LipVQ, train.pallas_pool: a warm-up and @steps timed steps
    (6 + 6 stem-pool launches and one assign a step) with the peak device
    memory, 3 requests at B = 1 and 16 (6 stem-pool launches and one assign
    each), the B = 16 GMM bit-equal to the F.max_pool2d model's, and a
    kernel step against a plain step within phase 8's tolerances (cuDNN's
    deterministic algorithms). Returns (step median, peak GiB)."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    tag = "16a" if backbone == "ResNet34ConvFiLM" else "16b"
    path = f"phase {tag} icl_gmm_paper {backbone}"
    cfg = paper_config(pallas_pool=True, backbone=backbone, color=True)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)
    check(type(trunk_of(algo)).__name__ == backbone, f"{tag}: trunk {type(trunk_of(algo))}")
    log(f"phase {tag}: icl_gmm_paper on {backbone} trunks, crop + ColorRandomizer "
        f"(0.3 / 0.3 / 0.3 / 0.3), B={b} T=16, LipVQ, train.pallas_pool on; "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters")
    gen = torch.Generator(dev).manual_seed(21)
    batches = [make_train_batch(gen, dev, b) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    counts, med, _ = timed_steps(CB, algo, batches, f"{tag} step ({card})", f"{path} training")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches(tag, counts, {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1},
                   steps)
    log(f"  {tag}: median {med:.3f} ms a step at B={b} ({card}); phase 8's ResNet-18 step "
        f"{paper_step_ms:.3f} ms at B={TRAIN_B}; peak device memory {peak:.2f} GiB")
    if profile:
        device_profile(f"{tag} train step", lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel", "assign_kernel"))
    rng = np.random.RandomState(16)
    family_requests(CB, algo, rng, lambda b, call: {"stem_pool_fwd": 6, "lipvq_assign": 1},
                    f"{path} serving", ctx_t=16)
    twin = Algo.algo_factory("icl_gmm_paper", paper_config(backbone=backbone, color=True),
                             SHAPES, 12, device=dev)
    twin.nets.load_state_dict(algo.nets.state_dict())
    serve_with_pool_switch(CB, dev, twin, make_request(rng, BATCHES[-1], 16),
                           f"{path} serving, B=16 against F.max_pool2d", switch=algo)
    del twin
    free_card()
    kernel_against_plain(
        algo, lambda: Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                                        use_kernels=False),
        batches[0], ("action_loss", "vq_vae_loss", "policy_grad_norms"))
    return med, peak


def core_config(core_class, **core_kwargs):
    """A @configure for family_algo: the cameras' core and its kwargs."""
    def configure(cfg):
        cfg.observation.encoder.rgb.core_class = core_class
        cfg.observation.encoder.rgb.core_kwargs = core_kwargs
    return configure


def stem_inputs(algo):
    """Hooks recording the input shapes of the stem pools of @algo (an algo
    or a module); returns the list they fill and the hooks' handles."""
    from robot_manipulation_vq_vae_tpu_torch.models.base_nets import StemMaxPool

    shapes = []
    module = getattr(algo, "nets", algo)
    handles = [m.register_forward_pre_hook(lambda mod, args: shapes.append(
        tuple(args[0].shape))) for m in module.modules() if isinstance(m, StemMaxPool)]
    return shapes, handles


def frozen_state(algo):
    return {k: v.clone() for k, v in algo.nets.state_dict().items() if ".trunk." in k}


def phase_frozen_core(CB, dev, gen, card, name, configure, per_step, profile):
    """16c / 16d: phase 15a's ICL policy on a frozen pretrained core (random
    trunk weights from the seed): a warm-up and CORE_STEPS timed steps with
    @per_step launches, the trunk's parameters and BatchNorm statistics
    unchanged to the bit, 3 requests at B = 1 and 16, and the B = 16 action
    bit-equal to the F.max_pool2d model's. Returns (step median, the stem
    pools' input shapes over the steps and requests)."""
    import torch

    tag = "16c" if name == "R3MConv" else "16d"
    algo = family_algo("plain", dev, configure=configure)
    cores = [m for m in algo.nets.modules() if type(m).__name__ == name]
    check(len(cores) == len(CAMS) and all(c.freeze for c in cores), f"{tag}: {cores}")
    log(f"phase {tag}: ICL (MLP) on a frozen {name} "
        f"({getattr(cores[0], 'r3m_model_class', None) or cores[0].mvp_model_class}) per "
        f"camera, B={FAMILY_B}; {sum(p.numel() for p in algo.nets.parameters())} parameters")
    batches = [algo.process_batch_for_training(make_train_batch(gen, dev, FAMILY_B, 1))
               for _ in range(CORE_STEPS + 1)]
    before = frozen_state(algo)
    check(before, f"{tag}: no trunk state")
    shapes, handles = stem_inputs(algo)
    step_ms = family_train(CB, algo, batches, per_step, f"{tag} {name} step ({card})",
                           f"phase {tag} ICL {name} training",
                           ("l2_loss", "action_loss", "policy_grad_norms"))
    after = frozen_state(algo)
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    check(not moved, f"{tag}: {len(moved)} frozen trunk tensors moved, e.g. {moved[:3]}")
    log(f"  {tag}: {len(before)} trunk tensors (parameters and buffers) "
        f"unchanged to the bit by {CORE_STEPS + 1} steps")
    if profile:
        device_profile(f"{tag} train step", lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_band_kernel",))
    rng = np.random.RandomState(18)
    family_requests(CB, algo, rng, lambda b, call: per_step_serving(per_step),
                    f"phase {tag} ICL {name} serving")
    twin = family_algo("plain", dev, pallas_pool=False, configure=configure)
    twin.nets.load_state_dict(algo.nets.state_dict())
    obs = request_obs(rng, BATCHES[-1])
    got, want = algo.get_action(obs), twin.get_action(obs)
    check(torch.equal(got, want), f"{tag}: B=16 action differs from max_pool2d's by "
          f"{float((got - want).abs().max())}")
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    for h in handles:
        h.remove()
    del twin, algo
    free_card()
    return step_ms, sorted(set(shapes))


def per_step_serving(per_step):
    """A training step's forward launches are a request's."""
    return {k: v for k, v in per_step.items() if k == "stem_pool_fwd"}


def phase_r3m_pool(S, dev, gen):
    """Row 3g: kernel 3 alone at each of 16c's stem shapes (R3M_POOL_SHAPES:
    its requests' and its training step's), fp32, on ReLU'd inputs (ties):
    maxima, offsets and kernel 4's dx bit-equal to the plain versions, the
    launcher's path asserted (the band kernel), each timed beside its bound,
    the plain version and F.max_pool2d, back to back and by device time
    alone, and the wrapper's host us a call at [1]. Returns a row for each
    shape."""
    import torch.nn.functional as F

    rows = []
    for shape in R3M_POOL_SHAPES:
        x = relu_input(shape, gen, dev)
        tag = "x".join(map(str, shape))
        err = check_band_forward(S, x, f"kernel 3 at {tag}")
        n_in, n_out = x.numel(), shape[0] * shape[1] * int(np.prod(S.pooled_hw(*shape[2:])))
        timed = time_kernels({"stem_pool_fwd": (
            lambda: S.pool_fwd_cuda(x), lambda: S.pool_fwd_plain(x),
            lambda: F.max_pool2d(x, 3, 2, 1, return_indices=True),
            (4 * n_in + 5 * n_out, 8 * n_out), err)}, tag, graph=("stem_pool_fwd",))
        if shape[0] == 1:
            wrapper_host_us(S, x)
        rows.append(dict(timed["stem_pool_fwd"], shape=list(shape)))
        del x
    return rows


# MCR pretraining's stem (phase 19f: train_mcr_representation.py's default
# batch of 32 frame quintuples at 224 x 224)
MCR_POOL = (32 * 5, 64, 112, 112)
# a rank's half of it under phase 24's dp = 2
MCR_RANK_POOL = (16 * 5, 64, 112, 112)


def phase_mcr_pool(S, dev, shape=MCR_POOL):
    """Rows 3h / 4g: kernels 3 and 4 in fp32 at @shape (MCR_POOL, or a dp
    rank's MCR_RANK_POOL), on ReLU'd inputs (ties): maxima, offsets and dx
    bit-equal to the plain versions (kernel 3 through its band kernel,
    kernel 4 on whole planes of windows, both asserted from their plans),
    each timed beside its bound, the plain version and the library call
    (F.max_pool2d, its indices' backward), back to back and by device time
    alone. Returns {kernel: row}."""
    import torch
    import torch.nn.functional as F

    log(f"phase 6 (MCR stem): kernels 3 and 4 at {list(shape)} fp32")
    gen = torch.Generator(dev).manual_seed(31)
    x = relu_input(shape, gen, dev)
    tag = "x".join(map(str, shape))
    hw = shape[2:]
    fwd_err = check_band_forward(S, x, f"kernels 3 and 4 at {tag}")
    tile_h, tile_w, blocks, smem = S.pool_bwd_plan(shape, x.dtype)
    ho, wo = S.pooled_hw(*hw)
    check((tile_h, tile_w) == (ho, wo), f"kernel 4 took tiles of {tile_h} x {tile_w} "
          f"windows at {tag}, not whole planes of {ho} x {wo}")
    log(f"  stem_pool_bwd at {tag}: whole planes of {ho} x {wo} windows, {blocks} blocks of "
        f"{smem} B of shared memory")
    out, idx = S.pool_fwd_cuda(x)
    g = torch.randn(out.shape, generator=gen, device=dev)
    dx_k, dx_p = S.pool_bwd_cuda(idx, g, hw), S.pool_bwd_plain(idx, g, hw)
    bwd_err = float((dx_k - dx_p).abs().max())
    check(torch.equal(dx_k, dx_p), f"kernel 4 at {tag}: dx differs by {bwd_err}")
    del dx_k, dx_p
    _, lib_idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    n_in, n_out = x.numel(), out.numel()
    rows = time_kernels({
        "stem_pool_fwd": (lambda: S.pool_fwd_cuda(x), lambda: S.pool_fwd_plain(x),
                          lambda: F.max_pool2d(x, 3, 2, 1, return_indices=True),
                          (4 * n_in + 5 * n_out, 8 * n_out), fwd_err),
        "stem_pool_bwd": (lambda: S.pool_bwd_cuda(idx, g, hw),
                          lambda: S.pool_bwd_plain(idx, g, hw),
                          lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                              g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx),
                          (5 * n_out + 4 * n_in, n_out), bwd_err),
    }, tag, graph=("stem_pool_fwd", "stem_pool_bwd"))
    del x, out, idx, g, lib_idx
    free_card()
    return rows


def with_scan(obs, gen, dev):
    """@obs with SCAN_KEY added: [..., SCAN_LEN] ranges in [0, 10) m."""
    import torch

    b = obs[CAMS[0]].shape[:-3]
    obs = dict(obs)
    obs[SCAN_KEY] = 10 * torch.rand((*b, SCAN_LEN), generator=gen, device=dev)
    return obs


def core_variants():
    """16e's list (also 20e's): (name, configure, stem-pool launches a fp32
    step, takes a scan) for each of the other cores and observation
    options."""
    film = dict(paper_config().observation.encoder.rgb.core_kwargs)
    kp = {"num_kp": 32, "learnable_temperature": False, "temperature": 1.0, "noise_std": 0.0}

    def plain_core(backbone, **backbone_kwargs):
        return core_config("VisualCore", backbone_class=backbone,
                           backbone_kwargs=backbone_kwargs, pool_class="SpatialSoftmax",
                           pool_kwargs=kp, feature_dimension=64)

    def low_dim_noise(cfg):
        cfg.observation.encoder.low_dim.obs_randomizer_class = "GaussianNoiseRandomizer"
        cfg.observation.encoder.low_dim.obs_randomizer_kwargs = {"noise_std": 0.1}

    def scan(cfg):
        cfg.observation.modalities.obs.scan = [SCAN_KEY]
        cfg.observation.encoder.scan.core_kwargs = {"feature_dimension": 64}

    pooled = {"stem_pool_fwd": 3, "stem_pool_bwd": 3}
    variants = [
        ("ResNet18Conv, group norm, coord-conv, SpatialSoftmax with a learnable "
         "temperature and noise 0.1",
         core_config("VisualCore", backbone_class="ResNet18Conv",
                     backbone_kwargs={"norm": "group", "input_coord_conv": True},
                     pool_class="SpatialSoftmax",
                     pool_kwargs={**kp, "learnable_temperature": True, "noise_std": 0.1},
                     feature_dimension=64), pooled, False),
        ("ShallowConv + SpatialMeanPool",
         core_config("VisualCore", backbone_class="ShallowConv",
                     pool_class="SpatialMeanPool", feature_dimension=64), {}, False),
        ("ResNet18ConvFiLMCrossAttn",
         core_config("VisualCoreLanguageConditioned",
                     **{**film, "backbone_class": "ResNet18ConvFiLMCrossAttn"}), pooled, False),
        ("ResNet34Conv", plain_core("ResNet34Conv"), pooled, False),
        ("ResNet50Conv (mcr's core)", plain_core("ResNet50Conv"), pooled, False),
        ("GaussianNoiseRandomizer on the low-dim keys", low_dim_noise, pooled, False),
        (f"ScanCore on {SCAN_KEY} [{SCAN_LEN}]", scan, pooled, True),
    ]
    return variants


def phase_core_options(CB, dev, gen, card):
    """16e: one training step and one B = 16 request of phase 15a's ICL policy
    with each of the other cores and observation options; the stem-pool
    launches of each (3 + 3 a step and 3 a request where the cameras have a
    ResNet stem)."""
    import torch

    variants = core_variants()
    rng = np.random.RandomState(19)
    for name, configure, per_step, scanned in variants:
        shapes = {**SHAPES, SCAN_KEY: (SCAN_LEN,)} if scanned else None
        algo = family_algo("plain", dev, configure=configure, shapes=shapes)
        batch = make_train_batch(gen, dev, FAMILY_B, 1)
        if scanned:
            batch["obs"] = with_scan(batch["obs"], gen, dev)
        batch = algo.process_batch_for_training(batch)
        CB.reset_launch_counts()
        t0 = time.perf_counter()
        losses = algo.train_on_batch(batch, epoch=0)["losses"]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(CB.LAUNCHES)
        check(all(np.isfinite(float(v)) for v in losses.values()), f"16e {name}: {losses}")
        check_launches(f"16e {name} step", counts, per_step, 1)
        record_path(f"phase 16e {name} training", counts)
        obs = request_obs(rng, BATCHES[-1])
        if scanned:
            obs = with_scan(obs, gen, dev)
        CB.reset_launch_counts()
        action, req_ms = served(algo, obs)
        check(action.shape == (BATCHES[-1], 12) and bool(action.isfinite().all()),
              f"16e {name}: action {tuple(action.shape)}")
        check_launches(f"16e {name} request", dict(CB.LAUNCHES), per_step_serving(per_step), 1)
        record_path(f"phase 16e {name} serving", dict(CB.LAUNCHES))
        log(f"phase 16e {name}: {sum(p.numel() for p in algo.nets.parameters())} parameters; "
            f"one step {step_ms:.3f} ms (cold), one B={BATCHES[-1]} request {req_ms:.3f} ms "
            f"(cold), launches {({k: v for k, v in counts.items() if v})} a step ({card})")
        del algo
        free_card()


def phase_cores(CB, S, dev, card, paper_step_ms, profile):
    """16: the other vision cores and observation options (see the module
    docstring). Returns row 3g's rows, one a shape, and 16a's / 16b's
    (step median, B) by backbone."""
    import torch

    log(f"phase 16: the other vision cores and observation options, fp32, "
        f"train.pallas_pool on ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(26)
    a_ms, a_peak = phase_paper_core(CB, dev, card, "ResNet34ConvFiLM", TRAIN_B,
                                    TRAIN_STEPS, paper_step_ms, profile)
    free_card()
    b_ms, b_peak = phase_paper_core(CB, dev, card, "ResNet50ConvFiLM", R50_TRAIN_B,
                                    CORE_STEPS, paper_step_ms, profile)
    free_card()
    r3m = core_config("VisualCore", backbone_class="R3MConv",
                      backbone_kwargs={"r3m_model_class": "resnet50"}, pool_class=None,
                      feature_dimension=64)
    c_ms, c_shapes = phase_frozen_core(CB, dev, gen, card, "R3MConv", r3m,
                                       {"stem_pool_fwd": 3}, profile)
    check(c_shapes == sorted(R3M_POOL_SHAPES),
          f"16c: the stems pooled {c_shapes}, not {sorted(R3M_POOL_SHAPES)}")
    row_3g = phase_r3m_pool(S, dev, gen)
    mvp = core_config("VisualCore", backbone_class="MVPConv",
                      backbone_kwargs={"mvp_model_class": "vitb-mae-egosoup"},
                      pool_class=None, feature_dimension=64)
    d_ms, d_shapes = phase_frozen_core(CB, dev, gen, card, "MVPConv", mvp, {}, profile)
    check(d_shapes == [], f"16d: a stem pooled {d_shapes}")
    log("  16d: no kernel on this path: the cameras' cores are ViTs (no stem, no "
        "pool), whose attention is plain matrix products, as JAX's einsums are")
    phase_core_options(CB, dev, gen, card)
    log(f"  phase 16 medians ({card}), ms a step: 16a ResNet-34 FiLM {a_ms:.3f} at "
        f"B={TRAIN_B} (phase 8's ResNet-18 {paper_step_ms:.3f}), 16b ResNet-50 FiLM "
        f"{b_ms:.3f} at B={R50_TRAIN_B}, 16c R3M {c_ms:.3f} and 16d MVP {d_ms:.3f} at "
        f"B={FAMILY_B}; peak device memory 16a {a_peak:.2f} GiB, 16b {b_peak:.2f} GiB")
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    return row_3g, {"ResNet34ConvFiLM": (a_ms, TRAIN_B), "ResNet50ConvFiLM": (b_ms, R50_TRAIN_B)}


# ---------------------------------------------------------------------------
# 17: the imitation baselines
# ---------------------------------------------------------------------------

BASELINE_B = 100       # the batch_size of exps/templates/bc.json, act.json and
                       # diffusion_policy.json
BC_T = 10              # bc.json's transformer.context_length and rnn.horizon
DP_TO, DP_TP = 2, 16   # diffusion_policy.json's observation and prediction horizons
ACT_CHUNK = 10         # act.json's train.seq_length
DP_REQUESTS = 2        # timed requests a batch size: a DDPM request is 100 UNet calls
BASELINE_STEPS = 2     # timed training steps, after a warm-up


def baseline_algo(name, dev, configure=None, pallas_pool=True, use_kernels=True,
                  shapes=None):
    """The ``@name`` algo (bc, diffusion_policy or act) at its template's
    widths on phase 8's observations (the FiLM ResNet-18 trunks, which all
    three take; the diffusion policy's with GroupNorm), with @configure (a
    function of the config) applied, of @shapes (SHAPES)."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory(name)
    with cfg.values_unlocked():
        _observations(cfg)
        cfg.train.pallas_pool = pallas_pool
        if configure is not None:
            configure(cfg)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory(name, cfg, SHAPES if shapes is None else shapes, 12, device=dev,
                             use_kernels=use_kernels)


def bc_mode(mode):
    """A configure hook of ``bc``: the template's transformer-GMM, VAE or
    RNN-GMM policy."""
    def configure(cfg):
        cfg.algo.gmm.enabled = mode in ("transformer_gmm", "rnn_gmm")
        cfg.algo.transformer.enabled = mode == "transformer_gmm"
        cfg.algo.vae.enabled = mode == "vae"
        cfg.algo.rnn.enabled = mode == "rnn_gmm"
        if mode == "rnn_gmm":
            cfg.algo.actor_layer_dims = []
            cfg.train.seq_length = BC_T
    return configure


def check_stem_shapes(tag, shapes, frames, n):
    """The stem pools ran at N = @frames x each of @n (their input shapes,
    recorded by ``stem_inputs``), and phase 6 holds each of those shapes."""
    want = sorted({(frames * b, 64, 58, 58) for b in n})
    got = sorted(set(shapes))
    log(f"  {tag}: the stems pooled {got}")
    check(got == want, f"{tag}: the stems pooled {got}, not {want}")
    check(set(got) <= set(POOL_SHAPES), f"{tag}: phase 6 holds none of "
          f"{sorted(set(got) - set(POOL_SHAPES))}")


def baseline_cell(CB, dev, gen, tag, make, t, frames, keys, card, serve, twin_check):
    """One cell of phase 17: build with @make(pallas_pool, use_kernels), a
    warm-up and BASELINE_STEPS timed steps on batches of BASELINE_B windows
    of @t steps (3 + 3 stem-pool launches a step, the metrics @keys), the
    peak memory, the requests (``serve(algo, rng)``), the B = 16 action
    against the F.max_pool2d twin's (``twin_check(algo, twin, rng)``), then
    a kernel step against a plain step. The policy encodes @frames
    observations a window: its stem pools must run at N = BASELINE_B x
    @frames in the steps and B x @frames in the requests. Returns (step ms,
    what @serve returns)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    algo = make(True, True)
    log(f"phase {tag}: {type(algo).__name__}, "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, "
        f"B={BASELINE_B} x T={t}")
    batches = [algo.process_batch_for_training(make_train_batch(gen, dev, BASELINE_B, t))
               for _ in range(BASELINE_STEPS + 1)]
    shapes, handles = stem_inputs(algo)
    step_ms = family_train(CB, algo, batches, {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                           f"{tag} step ({card})", f"phase {tag} training", keys)
    log(f"  peak device memory of the steps {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        "GiB")
    check_stem_shapes(f"{tag} steps", shapes, frames, (BASELINE_B,))
    shapes.clear()
    rng = np.random.RandomState(17)
    req_ms = serve(algo, rng)
    check_stem_shapes(f"{tag} requests", shapes, frames, BATCHES)
    for h in handles:
        h.remove()
    twin = make(False, True)
    twin.nets.load_state_dict(algo.nets.state_dict())
    twin_check(algo, twin, rng)
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    del twin
    kernel_against_plain(algo, lambda: make(True, False), batches[0], keys)
    return step_ms, req_ms


def equal_actions(tag, got, want):
    import torch

    check(torch.equal(got, want), f"{tag}: B={BATCHES[-1]} action differs from the "
          f"F.max_pool2d model's by {float((got - want).abs().max())}")


def seeded(algo, seed, fn, *args):
    """@fn(*args) with @algo's generator seeded: a twin seeded alike draws
    the same noise."""
    algo.generator.manual_seed(seed)
    return fn(*args)


def phase_bc(CB, dev, gen, card):
    """17a BC_Transformer_GMM and 17b BC_VAE, then BC_RNN_GMM's step."""
    import torch

    def make_mode(mode):
        return lambda pool, kernels: baseline_algo("bc", dev, bc_mode(mode), pool, kernels)

    def tx_twin(algo, twin, rng):
        obs = request_obs(rng, BATCHES[-1], BC_T)
        got, want = same_draws(algo.action_distribution(obs), twin.action_distribution(obs),
                               torch.Generator(dev).manual_seed(8))
        equal_actions("BC_Transformer_GMM", algo._select_output(got),
                      twin._select_output(want))

    nll = ("log_probs", "action_loss", "policy_grad_norms")
    rows = {"BC_Transformer_GMM": baseline_cell(
        CB, dev, gen, "17a BC_Transformer_GMM", make_mode("transformer_gmm"), BC_T, BC_T, nll, card,
        serve=lambda algo, rng: family_requests(
            CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3},
            "phase 17a BC_Transformer_GMM serving", obs_t=BC_T),
        twin_check=tx_twin)}
    free_card()

    def vae_twin(algo, twin, rng):
        obs = request_obs(rng, BATCHES[-1])
        equal_actions("BC_VAE", seeded(algo, 9, algo.get_action, obs),
                      seeded(twin, 9, twin.get_action, obs))

    rows["BC_VAE"] = baseline_cell(
        CB, dev, gen, "17b BC_VAE", make_mode("vae"), 1, 1,
        ("recons_loss", "kl_loss", "action_loss", "policy_grad_norms"), card,
        serve=lambda algo, rng: family_requests(
            CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3}, "phase 17b BC_VAE serving"),
        twin_check=vae_twin)
    free_card()
    rnn = make_mode("rnn_gmm")(True, True)
    log(f"phase 17b BC_RNN_GMM (ICLRNN_GMM's step): 2-layer LSTM of "
        f"{rnn.algo_config.rnn.hidden_dim}, {sum(p.numel() for p in rnn.nets.parameters())} "
        f"parameters, B={BASELINE_B} x T={BC_T}")
    batches = [make_train_batch(gen, dev, BASELINE_B, BC_T) for _ in range(2)]
    counts, rnn_ms, _ = timed_steps(CB, rnn, batches, f"17b BC_RNN_GMM step ({card})",
                                    "phase 17b BC_RNN_GMM training")
    check_launches("17b BC_RNN_GMM", counts, {"stem_pool_fwd": 3, "stem_pool_bwd": 3}, 1)
    del rnn
    free_card()
    return rows, rnn_ms


def ddim_config(cfg):
    """The diffusion policy served by its template's DDIM sampler."""
    cfg.algo.ddpm.enabled, cfg.algo.ddim.enabled = False, True


def phase_diffusion(CB, dev, gen, card, profile):
    """17c DiffusionPolicyUNet: steps on GroupNorm trunks, DDPM requests
    (100 UNet calls each; with @profile one B = 1 request's device time),
    DDIM requests, the B = 16 DDPM action against the F.max_pool2d twin's."""
    def make(pool, kernels):
        algo = baseline_algo("diffusion_policy", dev, None, pool, kernels)
        check(algo.ema_enabled and not algo.use_ddim and algo.num_inference_steps == 100,
              "diffusion_policy.json's DDPM sampler with EMA")
        norms = {type(m).__name__ for m in algo.nets["obs_encoder"].modules()
                 if "Norm" in type(m).__name__}
        check(norms == {"GroupNorm"}, f"the diffusion trunks' norms: {norms}")
        return algo

    def serve(algo, rng):
        req = family_requests(CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3},
                              "phase 17c DiffusionPolicyUNet DDPM serving", obs_t=DP_TO,
                              n=DP_REQUESTS)
        ddpm = {"ms": req}
        if profile:
            obs = request_obs(rng, 1, DP_TO)
            device_profile("diffusion DDPM get_action B=1", lambda: algo.get_action(obs))
        ddim = baseline_algo("diffusion_policy", dev, ddim_config)
        ddim.nets.load_state_dict(algo.nets.state_dict())
        log(f"  DDIM ({ddim.num_inference_steps} steps, diffusion_policy.json's algo.ddim):")
        shapes, handles = stem_inputs(ddim)
        ddpm["ddim"] = family_requests(CB, ddim, rng, lambda b, call: {"stem_pool_fwd": 3},
                                       "phase 17c DiffusionPolicyUNet DDIM serving",
                                       obs_t=DP_TO, n=DP_REQUESTS)
        check_stem_shapes("17c DDIM requests", shapes, DP_TO, BATCHES)
        for h in handles:
            h.remove()
        del ddim
        return ddpm

    def twin_check(algo, twin, rng):
        obs = request_obs(rng, BATCHES[-1], DP_TO)
        equal_actions("DiffusionPolicyUNet", seeded(algo, 10, algo.get_action, obs),
                      seeded(twin, 10, twin.get_action, obs))

    step_ms, req = baseline_cell(CB, dev, gen, "17c DiffusionPolicyUNet", make, DP_TP,
                                 DP_TO, ("l2_loss",), card, serve=serve, twin_check=twin_check)
    free_card()
    return step_ms, req["ms"], req["ddim"]


def phase_act(CB, dev, gen, card):
    """17d ACT: steps on t = 0 observations; then at B = 1 and 16, after a
    reset, ACT_CHUNK + 1 calls: the first and the last find the queue empty
    and predict a chunk (3 stem-pool launches), the others pop (none)."""
    def make(pool, kernels):
        return baseline_algo("act", dev, None, pool, kernels)

    def predicts(call):
        return call % ACT_CHUNK == 0

    def serve(algo, rng):
        times = {}
        medians = family_requests(
            CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3} if predicts(call) else {},
            "phase 17d ACT serving", n=ACT_CHUNK + 1, start=algo.reset, times=times)
        for b in BATCHES:
            kinds = {k: [ms for call, ms in enumerate(times[b]) if predicts(call) == k]
                     for k in (True, False)}
            medians[f"predict{b}"] = statistics.median(kinds[True])
            log(f"  B={b}: {len(kinds[True])} calls predicted a chunk (median "
                f"{medians[f'predict{b}']:.3f} ms), {len(kinds[False])} popped it (median "
                f"{statistics.median(kinds[False]):.3f} ms)")
        return medians

    def twin_check(algo, twin, rng):
        obs = request_obs(rng, BATCHES[-1])
        for p in (algo, twin):
            p.reset()
        equal_actions("ACT", algo.get_action(obs), twin.get_action(obs))
        check(len(algo._ac_queue) == ACT_CHUNK - 1, "ACT: the chunk was not queued")

    out = baseline_cell(CB, dev, gen, "17d ACT", make, ACT_CHUNK, 1,
                        ("l1_loss", "kl_loss", "action_loss", "policy_grad_norms"), card,
                        serve=serve, twin_check=twin_check)
    free_card()
    return out


def phase_baselines(CB, dev, card, profile=False):
    """17: the imitation baselines at full width (see the module
    docstring). Returns {policy: (step median, {B: request median})}."""
    import torch

    log(f"phase 17: the imitation baselines (bc, diffusion_policy, act), phase 8's "
        f"observations, fp32, train.pallas_pool on ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(27)
    rows, rnn_ms = phase_bc(CB, dev, gen, card)
    dp_ms, dp_req, ddim_req = phase_diffusion(CB, dev, gen, card, profile)
    act_ms, act_req = phase_act(CB, dev, gen, card)
    rows["DiffusionPolicyUNet (DDPM)"] = (dp_ms, dp_req)
    rows["DiffusionPolicyUNet (DDIM)"] = (dp_ms, ddim_req)
    rows["ACT (all calls)"] = (act_ms, act_req)
    log(f"  phase 17 medians ({card}), ms: policy, train step, get_action B=1, B=16")
    for name, (step_ms, req) in rows.items():
        log(f"  {name:28s} {step_ms:10.3f} {req[1]:10.3f} {req[BATCHES[-1]]:10.3f}")
    log(f"  {'ACT (a call that predicts)':28s} {'':10s} {act_req['predict1']:10.3f} "
        f"{act_req[f'predict{BATCHES[-1]}']:10.3f}")
    log(f"  BC_RNN_GMM step {rnn_ms:.3f} ms")
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# 18: the offline-RL family
# ---------------------------------------------------------------------------

RL_B = 100             # the batch_size of exps/templates/{iql,td3_bc,cql,bcq}.json
RL_STEPS = 3           # timed steps of a low-dim cell, after a warm-up
# the templates' observations: robomimic Lift's low-dim keys (iql, cql, bcq;
# A = 7) and D4RL HalfCheetah's flat state (td3_bc; A = 6)
LIFT = {"robot0_eef_pos": (3,), "robot0_eef_quat": (4,), "robot0_gripper_qpos": (2,),
        "object": (10,)}
HALFCHEETAH = {"flat": (17,)}
# BCQ_Distributional's atoms span these (the bcq template sets no bounds):
# discounted returns of rewards in [0, 1] at gamma 0.99 lie in [0, 100]
RL_VALUE_BOUNDS = [-100.0, 100.0]
# tag -> (algo name, class, the metrics a step must give)
RL_CELLS = {
    "18a": ("iql", "IQL", ("critic/critic1_loss", "vf_loss", "actor/loss")),
    "18b": ("td3_bc", "TD3_BC", ("critic/critic1_loss", "actor/loss")),
    "18c": ("cql", "CQL", ("actor/loss", "critic/critic1_loss", "critic/cql_weight")),
    "18d": ("bcq", "BCQ", ("action_sampler/loss", "critic/critic1_loss")),
}
# 18e's stem-pool launches (3 cameras a trunk): a step, and a request. IQL:
# V at s', 2 target critics, 2 critics, V and the actor forward; the
# critics, V and the actor backward. TD3-BC (a step that moves the actor):
# the target actor, 2 target critics, 2 critics, the actor and the stepped
# first critic forward; the critics and the actor backward. CQL: the actor
# at s, s' and s and s' tiled 10 times ([1000]), 2 critics, 2 target
# critics forward; the actor and the critics backward. BCQ: the VAE at s
# and at s', 2 target critics, 2 critics forward; the VAE and the critics
# backward. A request: the actor; BCQ's the VAE and the first critic, each
# row encoded once for its 100 candidates.
RL_IMAGE_LAUNCHES = {
    "IQL": ({"stem_pool_fwd": 21, "stem_pool_bwd": 12}, {"stem_pool_fwd": 3}),
    "TD3_BC": ({"stem_pool_fwd": 21, "stem_pool_bwd": 9}, {"stem_pool_fwd": 3}),
    "CQL": ({"stem_pool_fwd": 24, "stem_pool_bwd": 9}, {"stem_pool_fwd": 3}),
    "BCQ": ({"stem_pool_fwd": 18, "stem_pool_bwd": 9}, {"stem_pool_fwd": 6}),
}
RL_PEAK_GIB = 60.0     # 18e's steps must fit in this at B = 100


def rl_algo(name, dev, images=False, pallas_pool=True, use_kernels=True, configure=None):
    """The ``@name`` algo at its template's widths, on the template's low-dim
    observations (``LIFT``, or ``HALFCHEETAH`` for td3_bc) or, with @images,
    on phase 8's (A = 12), with @configure (a function of the config)
    applied."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory(name)
    with cfg.values_unlocked():
        if images:
            _observations(cfg)
            cfg.train.pallas_pool = pallas_pool
        elif name != "td3_bc":
            cfg.observation.modalities.obs.low_dim = list(LIFT)
        if configure is not None:
            configure(cfg)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    shapes, ac_dim = rl_shapes(name, images)
    return Algo.algo_factory(name, cfg, shapes, ac_dim, device=dev, use_kernels=use_kernels)


def rl_shapes(name, images):
    if images:
        return SHAPES, 12
    return (HALFCHEETAH, 6) if name == "td3_bc" else (LIFT, 7)


def rl_batch(gen, dev, algo, b, images):
    """A processed batch of @b transitions (s, a, r, s', done) on the card:
    phase 8's observations with @images, else the template's low-dim ones;
    rewards in [0, 1], 5 % of the rows done."""
    import torch

    shapes, ac_dim = rl_shapes(algo.global_config.algo_name, images)
    if images:
        batch = make_train_batch(gen, dev, b, 1)
        batch["next_obs"] = make_train_batch(gen, dev, b, 1)["obs"]
    else:
        def obs():
            return {k: torch.randn((b, 1, *s), generator=gen, device=dev)
                    for k, s in shapes.items()}
        batch = {"obs": obs(), "next_obs": obs(),
                 "actions": torch.rand((b, 1, ac_dim), generator=gen, device=dev) * 2 - 1}
    batch["rewards"] = torch.rand((b, 1), generator=gen, device=dev)
    batch["dones"] = (torch.rand((b, 1), generator=gen, device=dev) < 0.05).float()
    return algo.process_batch_for_training(batch)


def rl_lowdim_obs(name):
    shapes, _ = rl_shapes(name, False)
    return lambda rng, b: {k: rng.randn(b, *s).astype(np.float32) for k, s in shapes.items()}


def phase_rl_lowdim(CB, dev, gen, card, tag, name, cls, keys, configure=None,
                    steps=RL_STEPS, requests=REQUESTS):
    """One low-dim cell of 18a-18d at the template's widths, B = RL_B: a
    warm-up and @steps timed steps, @requests requests at B = 1 and 16; no
    kernel runs. Returns (step median, {B: request median})."""
    algo = rl_algo(name, dev, configure=configure)
    check(type(algo).__name__ == cls, f"{tag}: {type(algo).__name__}")
    log(f"phase {tag} {cls}: {sum(p.numel() for p in algo.nets.parameters())} parameters, "
        f"B={RL_B}, observations {sorted(rl_shapes(name, False)[0])}")
    batches = [rl_batch(gen, dev, algo, RL_B, False) for _ in range(steps + 1)]
    step_ms = family_train(CB, algo, batches, {}, f"{tag} {cls} step ({card})",
                           f"phase {tag} {cls} training", keys)
    req = family_requests(CB, algo, np.random.RandomState(18), lambda b, call: {},
                          f"phase {tag} {cls} serving", n=requests,
                          make_obs=rl_lowdim_obs(name), ac_dim=rl_shapes(name, False)[1])
    del algo
    free_card()
    return step_ms, req


def phase_rl_image(CB, dev, gen, card, tag, name, cls, keys, profile):
    """One algo of 18e on phase 8's observations with train.pallas_pool at
    its template's widths, B = RL_B: a warm-up and one timed step (its
    stem-pool launches and input shapes, its peak device memory under
    RL_PEAK_GIB), 3 requests at B = 1 and 16, the B = 16 action bit-equal to
    the F.max_pool2d twin's with the same draws, and a kernel step against
    a plain step. Returns (step ms, {B: request median}, peak GiB)."""
    import torch

    per_step, per_request = RL_IMAGE_LAUNCHES[cls]
    path = f"phase 18e {cls}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    algo = rl_algo(name, dev, images=True)
    log(f"phase 18e {cls}: phase 8's observations, train.pallas_pool on, "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={RL_B}")
    batches = [rl_batch(gen, dev, algo, RL_B, True) for _ in range(2)]
    shapes, handles = stem_inputs(algo)
    counts, step_ms, vals = timed_steps(CB, algo, batches, f"18e {cls} step ({card})",
                                        f"{path} training")
    check_launches(f"18e {cls}", counts, per_step, 1)
    check(set(keys) <= set(vals), f"18e {cls}: metrics {sorted(vals)}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"  peak device memory of the steps {peak:.2f} GiB ({card})")
    check(peak < RL_PEAK_GIB, f"18e {cls}: peak {peak:.2f} GiB")
    n_rand = int(algo.algo_config.critic.num_random_actions) if cls == "CQL" else 1
    check_stem_shapes(f"18e {cls} steps", shapes, 1, (RL_B, RL_B * n_rand))
    if profile:
        device_profile(f"18e {cls} train step",
                       lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))
    shapes.clear()
    rng = np.random.RandomState(19)
    req = family_requests(CB, algo, rng, lambda b, call: per_request, f"{path} serving")
    check_stem_shapes(f"18e {cls} requests", shapes, 1, BATCHES)
    for h in handles:
        h.remove()
    twin = rl_algo(name, dev, images=True, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    obs = request_obs(rng, BATCHES[-1])
    equal_actions(cls, seeded(algo, 9, algo.get_action, obs),
                  seeded(twin, 9, twin.get_action, obs))
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    del twin

    # the plain model takes the optimizers' state too: a network's loss may
    # read another as its step left it (TD3-BC's actor the first critic,
    # CQL's critics the actor, BCQ's the sampler)
    def plain():
        p = rl_algo(name, dev, images=True, use_kernels=False)
        if cls == "TD3_BC":
            p.critic_steps = 1
        return p

    if cls == "TD3_BC":   # both compared steps move the actor (update_freq 2)
        algo.critic_steps = 1
    against_plain_from_state(algo, plain, batches[0], keys)
    return step_ms, req, peak


def phase_offline_rl(CB, dev, card, profile=False):
    """18: the offline-RL family (see the module docstring)."""
    import torch

    log(f"phase 18: the offline-RL family (iql, td3_bc, cql, bcq), fp32 ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(28)
    rows = {}
    for tag, (name, cls, keys) in RL_CELLS.items():
        rows[f"{tag} {cls}"] = phase_rl_lowdim(CB, dev, gen, card, tag, name, cls, keys)

    def gmm(cfg):
        cfg.algo.action_sampler.gmm.enabled = True

    def distributional(cfg):
        cfg.algo.critic.distributional.enabled = True
        cfg.algo.critic.value_bounds = RL_VALUE_BOUNDS

    for cls, configure in (("BCQ_GMM", gmm), ("BCQ_Distributional", distributional)):
        rows[f"18d {cls}"] = phase_rl_lowdim(CB, dev, gen, card, "18d", "bcq", cls,
                                             ("action_sampler/loss", "critic/critic1_loss"),
                                             configure=configure, steps=1, requests=1)
    image_rows = {}
    for tag, (name, cls, keys) in RL_CELLS.items():
        image_rows[cls] = phase_rl_image(CB, dev, gen, card, tag, name, cls, keys, profile)
        free_card()
    log(f"  phase 18 medians ({card}), ms: cell, train step, get_action B=1, B=16")
    for cell, (step_ms, req) in rows.items():
        log(f"  {cell:24s} {step_ms:10.3f} {req[1]:10.3f} {req[BATCHES[-1]]:10.3f}")
    for cls, (step_ms, req, peak) in image_rows.items():
        log(f"  {'18e ' + cls:24s} {step_ms:10.3f} {req[1]:10.3f} {req[BATCHES[-1]]:10.3f}"
            f"   peak {peak:.2f} GiB")
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the hierarchical family, MCR and its representation pretraining
# ---------------------------------------------------------------------------

HIER_B = 100           # the batch_size of exps/templates/{gl,hbc,iris,mcr}.json
HIER_T = 10            # windows: the subgoal horizon and the actor's rnn.horizon
HIER_STEPS = 2         # timed steps of a path, after a warm-up
HIER_CALLS = 20        # stepwise get_action calls: two subgoal intervals
# 19d's cells (algo, mode) and their stem-pool launches a step: the
# planner's three trunks forward at [100] and backward, the actor's at
# [1000]; cascade also predicts the batch's subgoals ([100], no backward).
# A request: the actor's three trunks, and the planner's at a refresh
HIER_IMAGE_CELLS = {
    ("hbc", "separate"): {"stem_pool_fwd": 6, "stem_pool_bwd": 6},
    ("hbc", "cascade"): {"stem_pool_fwd": 9, "stem_pool_bwd": 6},
    ("iris", "separate"): {"stem_pool_fwd": 6, "stem_pool_bwd": 6},
}
# the MCR pretraining script's defaults, with the ResNet-50 trunk that 19e
# grafts
MCR_ARGS = ("--size", "50", "--dataset", "synthetic")


def hier_config(name, images=False, pallas_pool=True, mode="separate", vae=True):
    """``@name`` (gl, hbc, iris) at its template's widths, windows of HIER_T:
    every section on robomimic Lift's low-dim keys (LIFT), or with @images
    the planner's and the actor's on phase 8's observations and the
    subgoals and IRIS's value network on phase 8's low-dim keys."""
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory

    cfg = config_factory(name)
    keys = list(LOW_DIM) if images else list(LIFT)
    with cfg.values_unlocked():
        cfg.train.seq_length = HIER_T
        cfg.train.pallas_pool = pallas_pool
        obs = cfg.observation
        if name == "gl":
            planner, sections = obs, [obs]
            cfg.algo.vae.enabled = vae
        else:
            cfg.algo.mode = mode
            planner = obs.planner if name == "hbc" else obs.value_planner.planner
            sections = [planner, obs.actor]
            if name == "iris":
                obs.value_planner.value.modalities.obs.low_dim = keys
        for section in sections:
            if images:
                _observations(cfg, section)
            else:
                section.modalities.obs.low_dim = keys
        planner.modalities.subgoal.low_dim = keys
    return cfg


def hier_algo(name, dev, images=False, pallas_pool=True, use_kernels=True, **kw):
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = hier_config(name, images, pallas_pool, **kw)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    shapes, ac_dim = (SHAPES, 12) if images else (LIFT, 7)
    return Algo.algo_factory(name, cfg, shapes, ac_dim, device=dev, use_kernels=use_kernels)


def hier_batch(gen, dev, algo, images, b=HIER_B):
    """A processed batch of @b windows of HIER_T steps on the card: phase
    8's observations (and the next observations' low-dim keys, which the
    subgoals and the value network read) with @images, else Lift's low-dim
    keys; rewards in [0, 1], 5 % of the steps done."""
    import torch

    def randn(shapes):
        return {k: torch.randn((b, HIER_T, *s), generator=gen, device=dev)
                for k, s in shapes.items()}

    if images:
        batch = make_train_batch(gen, dev, b, HIER_T)
        batch["next_obs"] = randn(LOW_DIM)
    else:
        batch = {"obs": randn(LIFT), "next_obs": randn(LIFT),
                 "actions": torch.rand((b, HIER_T, 7), generator=gen, device=dev) * 2 - 1}
    batch["rewards"] = torch.rand((b, HIER_T), generator=gen, device=dev)
    batch["dones"] = (torch.rand((b, HIER_T), generator=gen, device=dev) < 0.05).float()
    return algo.process_batch_for_training(batch)


def hier_keys(algo):
    """The metrics a hierarchical step must give (and a kernel step is
    held to)."""
    if type(algo).__name__ == "IRIS":
        return ("Planner/Planner/goal_loss", "Planner/ValueNetwork/critic/critic1_loss",
                "Actor/action_loss")
    return ("Planner/goal_loss", "Actor/action_loss", "Actor/policy_grad_norms")


def subgoal_requests(CB, algo, rng, path):
    """REQUESTS subgoal predictions of a planner at B = 1 and 16 (a warm one
    first each), each key [B, ...] and finite; no kernel. Returns the
    medians."""
    import torch

    make_obs = rl_lowdim_obs("bcq")
    medians = {}
    for b in BATCHES:
        times = []
        for call in range(REQUESTS + 1):
            obs = make_obs(rng, b)
            CB.reset_launch_counts()
            t0 = time.perf_counter()
            sub = algo.get_subgoal_predictions(obs)
            torch.cuda.synchronize()
            if call:
                times.append((time.perf_counter() - t0) * 1e3)
            check(all(tuple(v.shape) == (b, *LIFT[k]) and bool(v.isfinite().all())
                      for k, v in sub.items()), f"B={b}: subgoals {sub.keys()}")
            check_launches(f"{path} B={b}", dict(CB.LAUNCHES), {}, 1)
            record_path(path, dict(CB.LAUNCHES))
        medians[b] = statistics.median(times)
        log(f"  B={b}: get_subgoal_predictions median {medians[b]:.3f} ms "
            f"(all: {', '.join(f'{v:.3f}' for v in times)})")
    return medians


def stepwise_requests(CB, algo, rng, b, path, per_refresh, per_call, make_obs, ac_dim,
                      twin=None):
    """HIER_CALLS stepwise get_action calls at B = @b after a reset: the
    planner called at calls 0 and ``subgoal_update_interval`` alone,
    @per_refresh launches at those calls and @per_call at the others; with
    @twin (the F.max_pool2d model), each action bit-equal to its, both
    drawing from generators seeded alike. Returns the median ms."""
    import torch

    refreshed, times = [], []
    predict = algo.get_subgoal_predictions

    def spy(*args, **kwargs):
        refreshed.append(call)
        return predict(*args, **kwargs)

    for model in [algo] + ([twin] if twin is not None else []):
        model.reset()
        for a in algos_of(model):
            a.generator.manual_seed(9)
    interval = algo._subgoal_update_interval
    algo.get_subgoal_predictions = spy
    try:
        for call in range(HIER_CALLS):
            obs = make_obs(rng, b)
            CB.reset_launch_counts()
            t0 = time.perf_counter()
            action = algo.get_action(obs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(action.shape == (b, ac_dim) and bool(action.isfinite().all()),
                  f"{path} call {call}: action {tuple(action.shape)}")
            check_launches(f"{path} B={b} call {call}", dict(CB.LAUNCHES),
                           per_refresh if call % interval == 0 else per_call, 1)
            record_path(path, dict(CB.LAUNCHES))
            if twin is not None:
                equal_actions(f"{path} call {call}", action, twin.get_action(obs))
    finally:
        del algo.get_subgoal_predictions
    check(refreshed == [0, interval], f"{path}: the subgoal was refreshed at calls "
          f"{refreshed}, not 0 and {interval}")
    med = statistics.median(times)
    log(f"  B={b}: {HIER_CALLS} stepwise get_action calls, median {med:.3f} ms, the "
        f"refreshes {times[0]:.3f} / {times[interval]:.3f} ms (all: "
        f"{', '.join(f'{v:.3f}' for v in times)}); subgoal refreshed at calls {refreshed}"
        + ("; each action bit-equal to the F.max_pool2d model's" if twin is not None else ""))
    return med


def against_plain_from_state(algo, make_plain, batch, keys):
    """``kernel_against_plain`` with the plain model given the optimizers'
    and schedules' state too (a network's loss may read another as its step
    left it: the cascade actor's goals, BCQ's critic target)."""
    algos = algos_of(algo)
    opt = [({n: copy.deepcopy(o.state_dict()) for n, o in a.optimizers.items()},
            {n: copy.deepcopy(s.state_dict()) for n, s in a.lr_schedulers.items()})
           for a in algos]

    def plain():
        p = make_plain()
        for a, (optimizers, schedulers) in zip(algos_of(p), opt):
            for n, sd in optimizers.items():
                a.optimizers[n].load_state_dict(sd)
            for n, sd in schedulers.items():
                a.lr_schedulers[n].load_state_dict(sd)
        return p

    del algos
    kernel_against_plain(algo, plain, batch, keys)


def phase_gl(CB, dev, gen, card):
    """19a: GL and GL_VAE at gl.json's widths on Lift's low-dim keys, B =
    HIER_B: a warm-up and HIER_STEPS timed steps, REQUESTS subgoal
    predictions at B = 1 and 16; no kernel. Returns {class: (step ms, {B:
    request ms})}."""
    rows = {}
    for vae in (False, True):
        algo = hier_algo("gl", dev, vae=vae)
        cls = type(algo).__name__
        check(cls == ("GL_VAE" if vae else "GL"), f"19a: {cls}")
        log(f"phase 19a {cls}: {sum(p.numel() for p in algo.nets.parameters())} parameters, "
            f"B={HIER_B}, subgoals {HIER_T - 1} steps on of {sorted(algo.subgoal_shapes)}")
        batches = [hier_batch(gen, dev, algo, False) for _ in range(HIER_STEPS + 1)]
        step_ms = family_train(CB, algo, batches, {}, f"19a {cls} step ({card})",
                               f"phase 19a {cls} training", ("goal_loss",))
        rows[f"19a {cls}"] = (step_ms, subgoal_requests(
            CB, algo, np.random.RandomState(19), f"phase 19a {cls} serving"))
        del algo
        free_card()
    return rows


def phase_hier_lowdim(CB, dev, gen, card, tag, name, mode):
    """19b / 19c: @name (hbc, iris) in @mode at its template's widths on
    Lift's low-dim keys, B = HIER_B windows of HIER_T: a warm-up and
    HIER_STEPS timed steps, then HIER_CALLS stepwise get_action calls at B =
    1 and 16; no kernel. Returns (step ms, {B: request ms})."""
    algo = hier_algo(name, dev, mode=mode)
    cls = type(algo).__name__
    rnn = algo.algo_config.actor.rnn
    log(f"phase {tag} {cls} ({mode}): planner {type(algo.planner).__name__}, actor "
        f"{type(algo.actor).__name__} ({rnn.num_layers}-layer {rnn.rnn_type} of "
        f"{rnn.hidden_dim}, MLP {list(algo.algo_config.actor.actor_layer_dims)}), "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={HIER_B} "
        f"T={HIER_T}")
    batches = [hier_batch(gen, dev, algo, False) for _ in range(HIER_STEPS + 1)]
    path = f"phase {tag} {cls} {mode}"
    step_ms = family_train(CB, algo, batches, {}, f"{tag} {cls} {mode} step ({card})",
                           f"{path} training", hier_keys(algo))
    rng = np.random.RandomState(20)
    req = {b: stepwise_requests(CB, algo, rng, b, f"{path} serving", {}, {},
                                rl_lowdim_obs("bcq"), 7) for b in BATCHES}
    del algo
    free_card()
    return step_ms, req


def phase_hier_image(CB, dev, gen, card, name, mode, profile):
    """19d: @name (hbc, iris) in @mode on phase 8's observations with
    train.pallas_pool, B = HIER_B windows of HIER_T: a warm-up and
    HIER_STEPS timed steps (HIER_IMAGE_CELLS' launches, the stems at [100]
    and [1000]), the peak device memory, HIER_CALLS stepwise calls at B = 1
    and 16 (6 launches at a refresh, 3 at the other calls; every B = 16
    action bit-equal to the F.max_pool2d twin's with the same draws), and a
    kernel step against a plain step from the same weights and optimizer
    state. Returns (step ms, {B: request ms}, peak GiB)."""
    import torch

    per_step = HIER_IMAGE_CELLS[name, mode]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    algo = hier_algo(name, dev, images=True, mode=mode)
    cls = type(algo).__name__
    path = f"phase 19d {cls} {mode}"
    log(f"{path}: phase 8's observations, train.pallas_pool on, "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={HIER_B} "
        f"T={HIER_T}")
    batches = [hier_batch(gen, dev, algo, True) for _ in range(HIER_STEPS + 1)]
    shapes, handles = stem_inputs(algo)
    keys = hier_keys(algo)
    step_ms = family_train(CB, algo, batches, per_step, f"19d {cls} {mode} step ({card})",
                           f"{path} training", keys)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"  peak device memory of the steps {peak:.2f} GiB ({card})")
    check_stem_shapes(f"19d {cls} {mode} steps", shapes, 1, (HIER_B, HIER_B * HIER_T))
    if profile:
        device_profile(f"19d {cls} {mode} train step",
                       lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))
    shapes.clear()
    twin = hier_algo(name, dev, images=True, mode=mode, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    rng = np.random.RandomState(21)
    req = {b: stepwise_requests(CB, algo, rng, b, f"{path} serving", {"stem_pool_fwd": 6},
                                {"stem_pool_fwd": 3}, request_obs, 12,
                                twin=twin if b == BATCHES[-1] else None)
           for b in BATCHES}
    check_stem_shapes(f"19d {cls} {mode} requests", shapes, 1, BATCHES)
    for h in handles:
        h.remove()
    del twin
    free_card()
    against_plain_from_state(
        algo, lambda: hier_algo(name, dev, images=True, mode=mode, use_kernels=False),
        batches[0], keys)
    return step_ms, req, peak


def phase_mcr_pretrain(CB, dev, card, work, profile):
    """19f: MCR pretraining through scripts/train_mcr_representation.py at
    its defaults (32 quintuples of 224 x 224 frames, TCN weight 1) with
    ``--size 50``: the script's first step with an evaluation
    step and its snapshots, then HIER_STEPS timed steps (one stem-pool launch
    each way at MCR_POOL), a kernel step against a plain step from the same
    state and negatives, and the trunk exported to @work. Returns (trunk
    path, step ms, peak GiB)."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import synthetic_batches
    from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
    from robot_manipulation_vq_vae_tpu_torch.scripts import train_mcr_representation as Script

    args = Script.build_parser().parse_args(
        [*MCR_ARGS, "--work_dir", work, "--train_steps", "1", "--eval_freq", "1",
         "--device", str(dev)])
    path = "phase 19f MCR pretraining"
    log(f"phase 19f: MCR pretraining, ResNet-{args.size}, B={args.batch_size} x 5 frames "
        f"at {args.image_size}x{args.image_size}, TCN weight {args.tcnweight} ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    CB.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Script.run(args)
    torch.cuda.synchronize()
    log(f"  the script: one step, an evaluation step and two snapshots in "
        f"{time.perf_counter() - t0:.1f} s")
    check_launches("19f script", dict(CB.LAUNCHES), {"stem_pool_fwd": 2, "stem_pool_bwd": 1}, 1)
    record_path(path, dict(CB.LAUNCHES))
    shapes, handles = stem_inputs(trainer.model)
    batches = synthetic_batches(args.batch_size, args.image_size, args.action_dim,
                                state_dim=42, seed=args.seed + 2)
    times = []
    for _ in range(HIER_STEPS):
        batch = next(batches)
        CB.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.update(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v) for v in metrics.values()), f"19f: metrics {metrics}")
        check_launches("19f step", dict(CB.LAUNCHES), {"stem_pool_fwd": 1, "stem_pool_bwd": 1}, 1)
        record_path(path, dict(CB.LAUNCHES))
    for h in handles:
        h.remove()
    check(set(shapes) == {MCR_POOL}, f"19f: the stem pooled {sorted(set(shapes))}")
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    frames = args.batch_size * 5
    log(f"  19f step ({card}): median {step_ms:.3f} ms ({frames / step_ms * 1e3:.1f} frames/s; "
        f"all: {', '.join(f'{v:.3f}' for v in times)}); last {metrics}; the stem pooled "
        f"{list(MCR_POOL)}; peak device memory {peak:.2f} GiB")
    if profile:
        device_profile("19f MCR pretraining step", lambda: trainer.update(next(batches)),
                       share=("pool_fwd_kernel", "pool_bwd_kernel"))

    # a kernel step and a plain step from one state, batch and negatives
    model, batch = trainer.model, next(batches)
    state = copy.deepcopy(model.state_dict())
    opt = copy.deepcopy(trainer.optimizer.state_dict())
    perm_gen = torch.Generator(dev).manual_seed(3)
    perms = torch.stack([torch.randperm(args.batch_size, generator=perm_gen, device=dev)
                         for _ in range(model.num_negatives)])
    results = []
    for use_kernel in (True, False):
        model.load_state_dict(state)
        trainer.optimizer.load_state_dict(opt)
        BaseNets.set_stem_pool(model, True, use_kernel)
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            metrics = trainer.update(batch, neg_perms=perms)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = before
        results.append((metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.named_buffers()
                         if v.is_floating_point()}))
    BaseNets.set_stem_pool(model, True)
    compare_steps(*results, keys=("full_loss", "tcnloss"))
    del results, state, opt
    trunk = os.path.join(work, "mcr_trunk.pkl")
    trainer.export_trunk(trunk)
    del trainer
    free_card()
    return trunk, step_ms, peak


def mcr_algo(dev, pallas_pool=True, use_kernels=True, configure=None):
    """``mcr`` (MCR_GMM: 5 modes; its ResNet50Conv / SpatialSoftmax core,
    64-d features) on phase 8's cameras and low-dim keys, phase 8's crop;
    @configure (a function of the config) applied."""
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory("mcr")
    paper = paper_config().observation.encoder.rgb
    with cfg.values_unlocked():
        cfg.train.pallas_pool = pallas_pool
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM)
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.obs_randomizer_class = paper.obs_randomizer_class
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = dict(paper.obs_randomizer_kwargs)
        if configure is not None:
            configure(cfg)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory("mcr", cfg, SHAPES, 12, device=dev, use_kernels=use_kernels)


def phase_mcr_policy(CB, dev, gen, card, trunk):
    """19e: the MCR policy warm-started from 19f's @trunk through
    RMVQ_MCR_CKPT (every camera's backbone equal to the export to the bit),
    B = HIER_B: a warm-up and HIER_STEPS timed steps (3 + 3 stem-pool
    launches at [100]), 3 requests at B = 1 and 16, the B = 16 action
    bit-equal to the F.max_pool2d twin's with the same draws, and a kernel
    step against a plain step. Returns (step ms, {B: request ms}, peak
    GiB)."""
    import pickle

    import torch

    from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import jax_flat, jax_variables

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    os.environ["RMVQ_MCR_CKPT"] = trunk
    try:
        algo = mcr_algo(dev)
        twin = mcr_algo(dev, pallas_pool=False)
    finally:
        del os.environ["RMVQ_MCR_CKPT"]
    cls = type(algo).__name__
    check(cls == "MCR_GMM", f"19e: {cls}")
    with open(trunk, "rb") as f:
        want = jax_flat(pickle.load(f))
    backbones = [m.backbone for m in algo.nets.modules()
                 if hasattr(m, "backbone") and hasattr(m, "head")]
    check(len(backbones) == len(CAMS), f"19e: {len(backbones)} backbones")
    for bb in backbones:
        got = jax_variables(bb)
        check(all(np.array_equal(got[k], v) for k, v in want.items()),
              "19e: a grafted backbone differs from the exported trunk")
    log(f"phase 19e {cls}: warm-started from 19f's trunk ({len(want)} tensors, each of the "
        f"{len(backbones)} backbones equal to the export to the bit), "
        f"{sum(p.numel() for p in algo.nets.parameters())} parameters, B={HIER_B}")
    batches = [algo.process_batch_for_training(make_train_batch(gen, dev, HIER_B, 1))
               for _ in range(HIER_STEPS + 1)]
    shapes, handles = stem_inputs(algo)
    keys = ("log_probs", "action_loss", "policy_grad_norms")
    step_ms = family_train(CB, algo, batches, {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                           f"19e {cls} step ({card})", f"phase 19e {cls} training", keys)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"  peak device memory of the steps {peak:.2f} GiB ({card})")
    check_stem_shapes(f"19e {cls} steps", shapes, 1, (HIER_B,))
    shapes.clear()
    rng = np.random.RandomState(22)
    req = family_requests(CB, algo, rng, lambda b, call: {"stem_pool_fwd": 3},
                          f"phase 19e {cls} serving")
    check_stem_shapes(f"19e {cls} requests", shapes, 1, BATCHES)
    for h in handles:
        h.remove()
    twin.nets.load_state_dict(algo.nets.state_dict())
    obs = request_obs(rng, BATCHES[-1])
    equal_actions(cls, seeded(algo, 9, algo.get_action, obs),
                  seeded(twin, 9, twin.get_action, obs))
    log(f"  B={BATCHES[-1]} action bit-equal to the F.max_pool2d model's")
    del twin
    free_card()
    kernel_against_plain(algo, lambda: mcr_algo(dev, use_kernels=False), batches[0], keys)
    return step_ms, req, peak


def phase_hierarchical(CB, dev, card, profile=False):
    """19: the hierarchical family and MCR (see the module docstring)."""
    import shutil

    import torch

    log(f"phase 19: the hierarchical family (gl, hbc, iris) and mcr with its "
        f"pretraining, fp32 ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(29)
    rows = phase_gl(CB, dev, gen, card)
    for tag, name, mode in (("19b", "hbc", "separate"), ("19b", "hbc", "cascade"),
                            ("19c", "iris", "separate")):
        rows[f"{tag} {name} {mode}"] = phase_hier_lowdim(CB, dev, gen, card, tag, name, mode)
    image_rows = {}
    for name, mode in HIER_IMAGE_CELLS:
        image_rows[f"19d {name} {mode}"] = phase_hier_image(CB, dev, gen, card, name, mode,
                                                           profile)
        free_card()
    work = tempfile.mkdtemp(prefix="chip_smoke_mcr_")
    try:
        trunk, pretrain_ms, pretrain_peak = phase_mcr_pretrain(CB, dev, card, work, profile)
        image_rows["19e mcr"] = phase_mcr_policy(CB, dev, gen, card, trunk)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_card()
    log(f"  phase 19 medians ({card}), ms: cell, train step, request B=1, B=16 (the "
        "stepwise cells: the median of 20 calls)")
    for cell, (step_ms, req) in rows.items():
        log(f"  {cell:24s} {step_ms:10.3f} {req[1]:10.3f} {req[BATCHES[-1]]:10.3f}")
    for cell, (step_ms, req, peak) in image_rows.items():
        log(f"  {cell:24s} {step_ms:10.3f} {req[1]:10.3f} {req[BATCHES[-1]]:10.3f}"
            f"   peak {peak:.2f} GiB")
    log(f"  19f MCR pretraining       {pretrain_ms:10.3f}   peak {pretrain_peak:.2f} GiB")
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 20: the bf16 training steps of the JAX package's three bf16 steps
# ---------------------------------------------------------------------------

# phase 10b's bf16 tolerances: metrics (relative), gradients (of each
# tensor's largest), buffers (absolute)
BF16_TOLS = (1e-3, 1e-2, 1e-4)
BF16_STEPS = 2           # timed bf16 steps of 20a-20d, after a warm-up
# 20e's batch: 10 windows of BC_T = 100 frames a camera (16c / 16d's B = 100
# frames; BC_Transformer's own template batch of 100 windows is 20b's)
BF16_CORE_B = 10
BF16_POOL = {"stem_pool_fwd_bf16": 3, "stem_pool_bwd_bf16": 3}


def bf16_launches(per_step):
    """A fp32 step's stem-pool launches, as the bf16 instances'."""
    return {f"{k}_bf16": v for k, v in per_step.items()}


def masters_move(tag, algo, start):
    """The fp32 masters stay fp32, and the steps moved them."""
    import torch

    params = dict(algo.nets.named_parameters())
    check(all(p.dtype == torch.float32 for p in params.values()),
          f"{tag}: a master parameter is not fp32")
    moved = [n for n, p in params.items() if not torch.equal(p, start[n])]
    log(f"  {tag}: masters fp32; the steps moved {len(moved)} of {len(params)} parameter "
        "tensors")
    check(moved, f"{tag}: the steps moved no parameter")


def bf16_serving_equal(tag, algo, twin, serve):
    """A B = 1 and a B = 16 request of the bf16-mode @algo and of its
    fp32-mode @twin from the same weights: equal to the bit
    (``serve(algo, b)``: the request's outputs, a tuple of tensors)."""
    import torch

    twin.nets.load_state_dict(algo.nets.state_dict())
    for b in BATCHES:
        got, want = serve(algo, b), serve(twin, b)
        check(all(g.dtype == torch.float32 and torch.equal(g, w) for g, w in zip(got, want)),
              f"{tag}: the B={b} request differs between the bf16 and the fp32 mode")
    log(f"  {tag}: requests at B={' and '.join(map(str, BATCHES))} equal to the bit to the "
        "fp32-mode algo's from the same weights")


def bf16_cell(CB, dev, tag, make, batches, per_step, keys, card, serve, twin_check=True,
              process=False, profile=False):
    """One cell of phase 20: @make(mixed_precision, use_kernels) builds it;
    @batches go through its ``process_batch_for_training`` where @process;
    a warm-up and len(@batches) - 1 timed bf16 steps with @per_step launches
    a step and the peak memory (with @profile, one more step's device time
    by kernel); the masters fp32 and moving; the requests of
    @serve equal to the fp32-mode algo's; with @twin_check a kernel step
    against a plain (use_kernels=False) bf16 step from the same state
    within phase 10b's bf16 tolerances. Returns (step median, peak GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    algo = make(True, True)
    check(algo.mixed_precision, f"{tag}: mixed_precision not taken")
    if process:
        batches = [algo.process_batch_for_training(b) for b in batches]
    start = {n: p.detach().clone() for n, p in algo.nets.named_parameters()}
    log(f"phase {tag}: {type(algo).__name__} bf16, "
        f"{sum(p.numel() for p in start.values())} parameters, "
        f"B={len(batches[0]['actions'])}")
    counts, med, vals = timed_steps(CB, algo, batches, f"{tag} bf16 step ({card})",
                                    f"phase {tag} bf16 training")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches(tag, counts, per_step, len(batches) - 1)
    check(set(keys) <= set(vals), f"{tag}: metrics {sorted(vals)}")
    log(f"  {tag}: peak device memory {peak:.2f} GiB ({card})")
    if profile:
        device_profile(f"{tag} bf16 train step", lambda: algo.train_on_batch(batches[0], epoch=0),
                       share=("pool_fwd_kernel", "pool_bwd_kernel", "assign_kernel"))
    masters_move(tag, algo, start)
    del start
    twin = make(False, True)
    bf16_serving_equal(tag, algo, twin, serve)
    del twin
    free_card()
    if twin_check:
        kernel_against_plain(algo, lambda: make(True, False), batches[0], keys, BF16_TOLS)
    del algo
    free_card()
    return med, peak


def gmm_request(t):
    """``serve`` of a prompt-conditioned GMM policy: its GMM's parameters for
    a request of [b, @t] observations and context."""
    def serve(algo, b):
        obs, ctx = make_request(np.random.RandomState(b), b, t)
        dist, _ = algo.action_distribution(obs, ctx)
        return dist.means, dist.scales, dist.logits
    return serve


def action_request(t, seed=None):
    """``serve`` of a policy that takes observations alone ([b, @t] windows,
    or [b] with @t None): its action, with the algo's generator seeded by
    @seed where it samples."""
    def serve(algo, b):
        obs = request_obs(np.random.RandomState(b), b, t)
        if seed is not None:
            algo.generator.manual_seed(seed)
        return (algo.get_action(obs),)
    return serve


def bf16_transformer():
    """A configure hook of ``bc`` / ``mcr``: the template's (non-GMM)
    transformer policy."""
    def configure(cfg):
        cfg.algo.gmm.enabled = False
        cfg.algo.transformer.enabled = True
        cfg.algo.vae.enabled = False
        cfg.algo.rnn.enabled = False
    return configure


def mixed(*configures):
    """One configure hook: @configures, then ``train.mixed_precision`` on."""
    def configure(cfg, on=True):
        for c in configures:
            if c is not None:
                c(cfg)
        cfg.train.mixed_precision = on
    return configure


def phase_bf16_mamba(CB, dev, gen, card, fp32_ms, profile):
    """20a: ICLMamba_GMM with LipVQ at 15c's configuration, bf16."""
    batches = [make_train_batch(gen, dev, TRAIN_B, MAMBA_T) for _ in range(BF16_STEPS + 1)]
    med, peak = bf16_cell(
        CB, dev, "20a ICLMamba_GMM", lambda mp, k: mamba_algo(
            dev, use_kernels=k, mixed_precision=mp), batches,
        {"stem_pool_fwd_bf16": 6, "stem_pool_bwd_bf16": 6, "lipvq_assign_bf16": 1},
        ("action_loss", "vq_vae_loss", "policy_grad_norms"), card,
        gmm_request(MAMBA_T), profile=profile)
    log(f"  20a: bf16 {med:.3f} ms a step against 15c's fp32 {fp32_ms:.3f} ms "
        f"({med / fp32_ms:.3f} x; {card})")
    return med, peak


def phase_bf16_bc(CB, dev, gen, card):
    """20b: BC_Transformer at 17a's widths and batch (GPT 6 x 512, context
    BC_T, B = 100), bf16, beside its fp32 step timed here."""
    def make(mp, k):
        return baseline_algo("bc", dev, lambda cfg: mixed(bf16_transformer())(cfg, mp),
                             use_kernels=k)

    batches = [make_train_batch(gen, dev, BASELINE_B, BC_T) for _ in range(BF16_STEPS + 1)]
    keys = ("l2_loss", "action_loss", "policy_grad_norms")
    med, peak = bf16_cell(CB, dev, "20b BC_Transformer", make, batches, BF16_POOL, keys,
                          card, action_request(BC_T), process=True)
    fp32 = make(False, True)
    batches = [fp32.process_batch_for_training(b) for b in batches]
    check(not fp32.mixed_precision and type(fp32).__name__ == "BC_Transformer", "20b fp32")
    counts, fp32_ms, _ = timed_steps(CB, fp32, batches, f"20b BC_Transformer fp32 step ({card})",
                                     "phase 20b BC_Transformer fp32 training")
    check_launches("20b fp32", counts, {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                   BF16_STEPS)
    del fp32
    free_card()
    log(f"  20b: bf16 {med:.3f} ms a step against fp32 {fp32_ms:.3f} ms ({med / fp32_ms:.3f} "
        f"x; {card})")
    return med, peak, fp32_ms


def phase_bf16_diffusion(CB, dev, gen, card, fp32_ms, profile):
    """20c: DiffusionPolicyUNet at 17c's configuration (GroupNorm trunks, EMA,
    B = 100 x To 2, Tp 16), bf16; its requests (DDPM) fp32, seeded alike."""
    def make(mp, k):
        return baseline_algo("diffusion_policy", dev, lambda cfg: mixed()(cfg, mp),
                             use_kernels=k)

    def window(batch):   # process_batch_for_training's: To frames, Tp actions
        return {"obs": {k: v[:, :DP_TO] for k, v in batch["obs"].items()},
                "actions": batch["actions"][:, :DP_TP]}

    batches = [window(make_train_batch(gen, dev, BASELINE_B, DP_TP))
               for _ in range(BF16_STEPS + 1)]
    med, peak = bf16_cell(CB, dev, "20c DiffusionPolicyUNet", make, batches, BF16_POOL,
                          ("l2_loss",), card, action_request(DP_TO, seed=10), profile=profile)
    log(f"  20c: bf16 {med:.3f} ms a step against 17c's fp32 {fp32_ms:.3f} ms "
        f"({med / fp32_ms:.3f} x; {card})")
    return med, peak


def phase_bf16_film(CB, dev, gen, card, fp32_rows, profile):
    """20d: icl_gmm_paper on ResNet-34 FiLM and ResNet-50 FiLM with the crop
    and ColorRandomizer's defaults, bf16, at B = TRAIN_B: the batch 16b
    could not fit in fp32. The jitter's fp32 draws lift the image, and so
    the trunks and their stem pools, to fp32, as in JAX's bf16 step; the
    FiLM projections, the LipVQ encoder and the low-dim features stay bf16.
    Where B = TRAIN_B does not fit, the cell runs at 16b's B and says so.
    Returns {backbone: (median, peak GiB, B)}."""
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    def make_for(backbone):
        def make(mp, k):
            cfg = paper_config(pallas_pool=True, mixed_precision=mp, backbone=backbone,
                               color=True)
            ObsUtils.initialize_obs_utils_with_config(cfg)
            return Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev,
                                     use_kernels=k)
        return make

    rows = {}
    keys = ("action_loss", "vq_vae_loss", "policy_grad_norms")
    per_step = {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign_bf16": 1}
    for backbone in ("ResNet34ConvFiLM", "ResNet50ConvFiLM"):
        tag = f"20d {backbone}"
        fp32_ms, fp32_b = fp32_rows[backbone]
        b, med = TRAIN_B, None
        batches = [make_train_batch(gen, dev, b) for _ in range(BF16_STEPS + 1)]
        try:
            med, peak = bf16_cell(CB, dev, tag, make_for(backbone), batches, per_step, keys,
                                  card, gmm_request(16),
                                  profile=profile and backbone == "ResNet34ConvFiLM")
        except torch.cuda.OutOfMemoryError as err:
            log(f"  {tag}: B={b} does not fit on the card in bf16 mode ({card}; "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated at the "
                f"failure: {str(err).splitlines()[0]})")
        if med is None:   # out of the handler: its traceback held the step's tensors
            del batches
            free_card()
            b = fp32_b
            log(f"  {tag}: cut to 16b's B={b}")
            batches = [make_train_batch(gen, dev, b) for _ in range(BF16_STEPS + 1)]
            med, peak = bf16_cell(CB, dev, tag, make_for(backbone), batches, per_step, keys,
                                  card, gmm_request(16))
        rows[backbone] = (med, peak, b)
        log(f"  {tag}: bf16 {med:.3f} ms a step at B={b}, peak {peak:.2f} GiB; fp32 (16"
            f"{'a' if backbone.startswith('ResNet34') else 'b'}) {fp32_ms:.3f} ms at "
            f"B={fp32_b} ({card})")
        del batches
        free_card()
    return rows


def phase_bf16_cores(CB, dev, gen, card):
    """20e: one bf16 step of BC_Transformer (20b's widths, B = BF16_CORE_B
    windows) on each of 16e's cores and options and on frozen R3M (ResNet-50)
    and MVP (ViT-B) cores, then one MCR_Transformer step on mcr's ResNet-50
    core at that batch: launches, masters, the requests against the
    fp32-mode algo's, and for MCR_Transformer a kernel step against a plain
    step."""
    import torch

    frozen = [
        ("frozen R3MConv (ResNet-50)", core_config(
            "VisualCore", backbone_class="R3MConv",
            backbone_kwargs={"r3m_model_class": "resnet50"}, pool_class=None,
            feature_dimension=64), {"stem_pool_fwd": 3}, False),
        ("frozen MVPConv (ViT-B)", core_config(
            "VisualCore", backbone_class="MVPConv",
            backbone_kwargs={"mvp_model_class": "vitb-mae-egosoup"}, pool_class=None,
            feature_dimension=64), {}, False),
    ]
    steps = {}
    for name, configure, per_step, scanned in core_variants() + frozen:
        shapes = {**SHAPES, SCAN_KEY: (SCAN_LEN,)} if scanned else None

        def make(mp, k, configure=configure, shapes=shapes):
            return baseline_algo("bc", dev, lambda cfg: mixed(
                bf16_transformer(), configure)(cfg, mp), use_kernels=k, shapes=shapes)

        batch = make_train_batch(gen, dev, BF16_CORE_B, BC_T)
        if scanned:
            batch["obs"] = with_scan(batch["obs"], gen, dev)

        def serve(algo, b, scanned=scanned):
            obs = request_obs(np.random.RandomState(b), b, BC_T)
            if scanned:
                obs = with_scan(obs, torch.Generator(dev).manual_seed(b), dev)
            return (algo.get_action(obs),)

        steps[name] = bf16_cell(CB, dev, f"20e {name}", make, [batch, batch],
                                bf16_launches(per_step), ("action_loss", "policy_grad_norms"),
                                card, serve, twin_check=False, process=True)[0]

    def make_mcr(mp, k):
        return mcr_algo(dev, use_kernels=k, configure=lambda cfg: mixed(
            bf16_transformer())(cfg, mp))

    batches = [make_train_batch(gen, dev, BF16_CORE_B, BC_T) for _ in range(2)]
    steps["MCR_Transformer (ResNet50Conv)"] = bf16_cell(
        CB, dev, "20e MCR_Transformer", make_mcr, batches, BF16_POOL,
        ("action_loss", "policy_grad_norms"), card, action_request(BC_T), process=True)[0]
    log(f"  20e: one bf16 step each after a warm-up, B={BF16_CORE_B} x T={BC_T} ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in steps.items()))


def phase_bf16(CB, dev, card, fp32, profile=False):
    """20: the bf16 training steps (see the module docstring); @fp32 holds
    the fp32 cells' medians (15c, 16a / 16b, 17c)."""
    import torch

    log(f"phase 20: the bf16 training steps the port took from JAX's three bf16 steps, "
        f"train.pallas_pool on ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(28)
    a = phase_bf16_mamba(CB, dev, gen, card, fp32["15c"], profile)
    free_card()
    b = phase_bf16_bc(CB, dev, gen, card)
    free_card()
    c = phase_bf16_diffusion(CB, dev, gen, card, fp32["17c"], profile)
    free_card()
    d = phase_bf16_film(CB, dev, gen, card, fp32["16"], profile)
    free_card()
    phase_bf16_cores(CB, dev, gen, card)
    log(f"  phase 20 medians ({card}), ms a step: bf16, fp32, bf16 / fp32, peak GiB")
    log(f"  20a ICLMamba_GMM            {a[0]:10.3f} {fp32['15c']:10.3f} "
        f"{a[0] / fp32['15c']:8.3f} {a[1]:8.2f}")
    log(f"  20b BC_Transformer          {b[0]:10.3f} {b[2]:10.3f} {b[0] / b[2]:8.3f} "
        f"{b[1]:8.2f}")
    log(f"  20c DiffusionPolicyUNet     {c[0]:10.3f} {fp32['17c']:10.3f} "
        f"{c[0] / fp32['17c']:8.3f} {c[1]:8.2f}")
    for backbone, (med, peak, bb) in d.items():
        ref, ref_b = fp32["16"][backbone]
        log(f"  20d {backbone:24s}{med:10.3f} {ref:10.3f} {med / ref:8.3f} {peak:8.2f}"
            f"   (bf16 at B={bb}, fp32 at B={ref_b})")
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 21: the tokenizer zoo on kernel 1, and the dp / mp mesh
# ---------------------------------------------------------------------------

# the tokenizer bench's widths (bench_tokenizer.py: feature 12, latent 210);
# each class keeps its own code counts
ZOO_N, ZOO_FWD_N, ZOO_STEPS, ZOO_LSTM_T = 4096, 65536, 3, 16
ZOO_KERNEL = ("VQVAE", "LFQQuantizerEMA", "LFQQuantizerEMA_KMeans",
              "HierarchicalLFQHVQVAE")
ZOO_LAUNCHES = {"VQVAE": 1, "LFQQuantizerEMA": 1, "LFQQuantizerEMA_KMeans": 1,
                "HierarchicalLFQHVQVAE": 2, "LFQVAE": 0, "LSTMVQVAE": 0}
DP_B, DP_STEPS = 32, 3        # 21b / 21c: the global batch and the steps (the
                              # first one warms up; times are of the others)


def host_state(algo):
    """A host copy of @algo's networks' state dict, whole (under mp the
    GPT's shards gathered: every rank calls it)."""
    return {k: algo._full(v).detach().cpu().clone()
            for k, v in algo.nets.state_dict().items()}


def zoo_model(name, dev, use_kernel=True):
    """@name of the zoo at the bench's widths, its weights drawn from a seed
    (the same for the kernel and the plain twin)."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.models import tokenizers as Zoo

    makers = {
        "VQVAE": lambda: Zoo.VQVAE(12, 210, 128, use_kernel=use_kernel),
        "LFQVAE": lambda: Zoo.LFQVAE(12, 210),
        "LSTMVQVAE": lambda: Zoo.LSTMVQVAE(12, 210),
        "LFQQuantizerEMA": lambda: Zoo.LFQQuantizerEMA(1024, 210, use_kernel=use_kernel),
        "LFQQuantizerEMA_KMeans": lambda: Zoo.LFQQuantizerEMA_KMeans(
            1024, 210, use_kernel=use_kernel),
        "HierarchicalLFQHVQVAE": lambda: Zoo.HierarchicalLFQHVQVAE(
            12, 210, 64, 1024, 512, 128, use_kernel=use_kernel),
    }
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(31)
        return makers[name]().to(dev)


def zoo_input(name, gen, dev, n):
    """A batch for @name: actions [n, 12] ([n / 16, 16, 12] windows for the
    LSTM), or sigmoid latents [n, 210] for the standalone quantizers."""
    import torch

    if name.startswith("LFQQuantizer"):
        return torch.sigmoid(torch.randn(n, 210, generator=gen, device=dev))
    if name == "LSTMVQVAE":   # [4096, 16, 12] windows, whatever @n
        return torch.randn(ZOO_N, ZOO_LSTM_T, 12, generator=gen, device=dev)
    return torch.randn(n, 12, generator=gen, device=dev)


@contextlib.contextmanager
def recorded_searches(K, log_to):
    """Record every nearest-code search (z, codebook, idx) that the zoo
    runs, through the kernel or its plain version."""
    cuda, plain = K.l2_nearest_cuda, K.l2_nearest_plain

    def wrap(fn):
        def run(z, codebook):
            idx, z_q = fn(z, codebook)
            log_to.append((z.detach(), codebook.detach().clone(), idx))
            return idx, z_q
        return run

    K.l2_nearest_cuda, K.l2_nearest_plain = wrap(cuda), wrap(plain)
    try:
        yield log_to
    finally:
        K.l2_nearest_cuda, K.l2_nearest_plain = cuda, plain


def zoo_train(model, batches, seed):
    """ZOO_STEPS training forwards of @model (Adam steps where it has
    parameters), the draws from a generator seeded @seed: (losses, the
    step times in ms by CUDA events)."""
    import torch

    gen = torch.Generator(batches[0].device).manual_seed(seed)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=1e-3) if params else None
    model.train()
    losses, times = [], []
    with deterministic_steps():
        for x in batches:
            step_once(model, x, gen, opt, losses, times)
    model.eval()
    return [float(v) for v in losses], times


@contextlib.contextmanager
def deterministic_steps():
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (index_add_ among them) inside the block."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
        torch.use_deterministic_algorithms(False)


def step_once(model, x, gen, opt, losses, times):
    """One training forward of a zoo class (an Adam step with @opt), timed
    by CUDA events into @times, its loss into @losses."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if hasattr(model, "z_quantizer") or hasattr(model, "dead_threshold"):
        out = model(x, generator=gen)
    else:
        out = model(x)
    if opt is not None:
        opt.zero_grad()
        out[1].backward()
        opt.step()
        losses.append(out[1].detach())
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))


def zoo_state_gap(a, b):
    """max over @a's floating tensors of max|a - b| / max(1, max|b|)."""
    gap = 0.0
    sb = b.state_dict()
    for k, v in a.state_dict().items():
        if v.is_floating_point():
            ref = sb[k]
            gap = max(gap, float((v - ref).abs().max()) / max(1.0, float(ref.abs().max())))
        else:
            check(bool((v == sb[k]).all()), f"{k} differs")
    return gap


def phase_zoo(CB, K, dev, card):
    """21a: the zoo at the bench's widths: ZOO_STEPS training steps at N =
    ZOO_N of each class against its use_kernel=False twin from the same
    state and draws, one N = ZOO_FWD_N forward of each kernel-1 class
    (timed), kernel 1 timed at the zoo's shapes; launches counted."""
    import torch

    log(f"phase 21a: the tokenizer zoo at the bench's widths (feature 12, latent 210), "
        f"{ZOO_STEPS} training steps at N={ZOO_N} against the plain twins, one forward "
        f"of each kernel-1 class at N={ZOO_FWD_N} ({card})")
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(41)
    shapes = {}
    for name in ZOO_LAUNCHES:
        batches = [zoo_input(name, gen, dev, ZOO_N) for _ in range(ZOO_STEPS)]
        runs = {}
        for use_kernel in (True, False):
            model = zoo_model(name, dev, use_kernel)
            searches = []
            CB.reset_launch_counts()
            with recorded_searches(K, searches):
                losses, times = zoo_train(model, batches, seed=43)
            runs[use_kernel] = (model, losses, times, searches, dict(CB.LAUNCHES))
        (mk, lk, tk, sk, ck), (mp_, lp, tp, sp, cp) = runs[True], runs[False]
        want = ZOO_LAUNCHES[name] * ZOO_STEPS
        check(ck.get("lipvq_assign", 0) == want, f"{name}: {ck} launches, expected {want}")
        check(sum(cp.values()) == 0, f"{name}'s plain twin launched {cp}")
        record_path(f"phase 21a {name} training", ck)
        check(len(sk) == len(sp), f"{name}: {len(sk)} searches against {len(sp)}")
        flips = 0
        for i, ((z, cb, idx_k), (_, _, idx_p)) in enumerate(zip(sk, sp)):
            agree = check_assignments(f"{name} search {i} N={z.shape[0]} D={z.shape[1]} "
                                      f"K={cb.shape[0]}", idx_k, idx_p, near_ties(z, cb))
            flips += int((~agree).sum())
            shapes[(z.shape[0], z.shape[1], cb.shape[0])] = (z, cb)
        rel = max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp)), default=0.0)
        gap = zoo_state_gap(mk, mp_)
        log(f"  {name}: losses kernel {lk} plain {lp} (max rel {rel:.3g}); parameters "
            f"and buffers max|kernel - plain| / max(1, |plain|) {gap:.3g}; {flips} flipped "
            f"rows; steps {', '.join(f'{t:.3f}' for t in tk)} ms (plain "
            f"{', '.join(f'{t:.3f}' for t in tp)}; CUDA events)")
        if flips == 0:
            check(rel <= 1e-5 and gap <= 1e-5, f"{name}: kernel and plain steps differ")
        if name == "HierarchicalLFQHVQVAE":
            usage = mk.codebook_usage()
            log(f"  codebook usage after {ZOO_STEPS} steps: {usage}")
        # the eval forward at the tokenizer bench's N
        x = zoo_input(name, gen, dev, ZOO_FWD_N)
        CB.reset_launch_counts()
        searches = []
        with torch.no_grad(), recorded_searches(K, searches):
            out = mk(x)
            torch.cuda.synchronize()
        counts = dict(CB.LAUNCHES)
        check(counts.get("lipvq_assign", 0) == ZOO_LAUNCHES[name],
              f"{name} forward: {counts}")
        record_path(f"phase 21a {name} forward N={ZOO_FWD_N}", counts)
        first = out[0]
        check(bool(torch.isfinite(first).all()), f"{name}: forward output not finite")
        for z, cb, _ in searches:
            shapes[(z.shape[0], z.shape[1], cb.shape[0])] = (z, cb)
        with torch.no_grad():
            fwd = cuda_ms(lambda: mk(x), iters=3, warmup=1, repeats=3)
            fwd_p = cuda_ms(lambda: mp_(x), iters=3, warmup=1, repeats=3)
        log(f"  {name} eval forward N={ZOO_FWD_N}: {fmt(fwd)} (plain twin {fmt(fwd_p)}); "
            f"launches {counts}")
        del mk, mp_, runs
        free_card()
    # kernel 1 alone at the zoo's (N, D, K), on the inputs the zoo searched
    counts = dict(CB.LAUNCHES)
    kernel_rows = {}
    for (n, d, k), (z, cb) in sorted(shapes.items()):
        idx_k, zq_k = K.l2_nearest_cuda(z, cb)
        idx_p, zq_p = K.l2_nearest_plain(z, cb)
        agree = check_assignments(f"kernel 1 N={n} D={d} K={k}", idx_k, idx_p,
                                  near_ties(z, cb))
        err = float((zq_k[agree] - zq_p[agree]).abs().max())
        ms = cuda_ms(lambda: K.l2_nearest_cuda(z, cb))
        plain = cuda_ms(lambda: K.l2_nearest_plain(z, cb))
        flops = 2 * n * k * d
        b, by = bound_ms((2 * n * d + k * d + k + n) * 4, flops)
        log(f"  kernel 1 N={n} D={d} K={k}: {fmt(ms)}, plain {fmt(plain)}, bound "
            f"{b:.4f} ms ({by}), max|err| {err}; {tflops(flops, ms[0])}")
        kernel_rows[f"N={n} D={d} K={k}"] = dict(ms=ms[0], plain_ms=plain[0], bound_ms=b,
                                                 bound_by=by, max_abs_err=err,
                                                 library_ms=None)
    CB.LAUNCHES.update(counts)
    # PRISE is a host-side component over the `tokenizers` package
    import importlib.util

    if importlib.util.find_spec("tokenizers") is None:
        log("  PRISE (PriseActionTokenizer) is not driven here: this host has no "
            "`tokenizers` package, which it needs (it runs on the host, no kernel)")
    else:
        from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import PriseActionTokenizer

        rng = np.random.RandomState(5)
        corpus = [[int(c) for c in rng.randint(0, 40, 12)] for _ in range(50)]
        tok = PriseActionTokenizer("bpe", vocab_size=100)
        tok.train(corpus)
        check(all(tok.decode(tok.encode(s)) == s for s in corpus[:10]),
              "PRISE round trip failed")
        log(f"  PRISE bpe: vocab {tok.vocab_size}, round trips of 10 sequences equal")
    log(f"  21a took {time.perf_counter() - t0:.1f} s")
    return kernel_rows


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_flagship_config(plain_draws):
    """The flagship training configuration; with @plain_draws dropout 0 and
    no crop randomizer (21c's draw-free steps)."""
    cfg = flagship_config(serving=False)
    if plain_draws:
        with cfg.values_unlocked():
            cfg.observation.encoder.rgb.obs_randomizer_class = None
            tc = cfg.algo.transformer
            tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
            tc.vqvae.dropout = 0.0
    return cfg


def dp_paper_config(plain_draws):
    cfg = paper_config(pallas_pool=True)
    if plain_draws:
        with cfg.values_unlocked():
            cfg.observation.encoder.rgb.obs_randomizer_class = None
            tc = cfg.algo.transformer
            tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
    return cfg


DP_LEGS = {"flagship": ("icl", dp_flagship_config, False),
           "paper": ("icl_gmm_paper", dp_paper_config, True)}


def dp_algo(tag, dev, plain_draws):
    import torch

    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    name, make_cfg, _ = DP_LEGS[tag]
    cfg = make_cfg(plain_draws)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    shapes = flagship_shapes(False) if tag == "flagship" else SHAPES
    with torch.random.fork_rng(devices=[]):
        return Algo.algo_factory(name, cfg, shapes, 12, device=dev)


def dp_batches(tag, dev, b=DP_B, seed=51):
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    return [make_train_batch(gen, dev, b=b) for _ in range(DP_STEPS)]


def dp_steps(algo, batches, mesh=None, first=None):
    """DP_STEPS train_on_batch calls (the shards of @mesh when given), the
    draws seeded, cuDNN's deterministic algorithms on: ([metrics], [ms a
    step by CUDA events]). The networks' state after the first step goes
    into the dict @first, where given."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    algo.generator.manual_seed(7)
    torch.manual_seed(7)
    metrics, times = [], []
    with deterministic_steps():
        for step, batch in enumerate(batches):
            if step == 1 and first is not None:
                first.update(host_state(algo))
            if mesh is not None:
                batch = shard_batch(mesh, batch, halves=algo.DP_LAYOUT == "halves")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            info = algo.train_on_batch(batch, epoch=0)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in info["losses"].items()})
    return metrics, times


def phase_mesh_dp1(CB, dev, card):
    """21b: make_mesh under nccl at dp = 1 in this process; DP_STEPS
    flagship and paper steps under shard_state against as many unsharded
    steps from the same state and draws, equal to the bit; kernels 1, 3
    and 4 counted."""
    import torch
    import torch.distributed as dist

    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state

    log(f"phase 21b: the mesh at dp = 1 under nccl, {DP_STEPS} steps of the flagship and "
        f"of icl_gmm_paper at B={DP_B} under shard_state against unsharded steps ({card})")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh()
        log(f"  mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}")
        for tag in DP_LEGS:
            batches = dp_batches(tag, dev)
            ref = dp_algo(tag, dev, plain_draws=False)
            state = {k: v.clone() for k, v in ref.nets.state_dict().items()}
            want, ref_ms = dp_steps(ref, batches)
            want_state = {k: v.clone() for k, v in ref.nets.state_dict().items()}
            del ref
            free_card()
            algo = dp_algo(tag, dev, plain_draws=False)
            algo.nets.load_state_dict(state)
            shard_state(mesh, algo)
            CB.reset_launch_counts()
            got, ms = dp_steps(algo, batches, mesh)
            counts = dict(CB.LAUNCHES)
            record_path(f"phase 21b {tag} dp=1", counts)
            per_step = {"stem_pool_fwd": 3, "stem_pool_bwd": 3} if tag == "flagship" else {
                "stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1}
            check_launches(f"21b {tag}", counts, per_step, DP_STEPS)
            check(got == want, f"21b {tag}: metrics differ: {got} vs {want}")
            diff = [k for k, v in algo.nets.state_dict().items()
                    if not torch.equal(v, want_state[k])]
            check(not diff, f"21b {tag}: {len(diff)} tensors differ, e.g. {diff[:3]}")
            log(f"  {tag}: {DP_STEPS} steps equal to the bit (metrics, {len(want_state)} "
                f"tensors); launches {counts}; ms a step under the mesh "
                f"{', '.join(f'{t:.3f}' for t in ms)}, unsharded "
                f"{', '.join(f'{t:.3f}' for t in ref_ms)} (CUDA events, deterministic cuDNN)")
            out[tag] = statistics.median(ms[1:])
            del algo, want_state
            free_card()
    finally:
        dist.destroy_process_group()
    log(f"  21b took {time.perf_counter() - t0:.1f} s")
    return out


# the flagship's HVQVAE metrics: its cosine codebooks flip near-tied
# assignments under fp32 reduction-order noise, as tests/test_parallel.py
# allows for (:278-305)
DP_VQ_METRICS = ("vqvae_loss", "L_rec", "L_commit_z", "L_commit_q", "vqvae_grad_norms")


def check_dp_metrics(tag, got, want, phase="21c"):
    """@phase's metrics against the unsharded steps, test_parallel.py's way:
    every metric within rtol 1e-4 / atol 1e-5 at the first step, and the
    policy's at every step; the HVQVAE's after the first within its vq
    bounds (rtol 3e-2 / atol 6e-2). Logs each metric's largest relative
    gap."""
    worst = {}
    for step, (g, w) in enumerate(zip(got, want)):
        for k, ref in w.items():
            diff = abs(g[k] - ref)
            worst[k] = max(worst.get(k, 0.0), diff / max(abs(ref), 1e-30))
            rtol, atol = ((3e-2, 6e-2) if step > 0 and k in DP_VQ_METRICS
                          else (1e-4, 1e-5))
            check(diff <= atol + rtol * abs(ref),
                  f"{phase} {tag} step {step} {k}: {g[k]} vs {ref}")
    log(f"  {phase} {tag}: metrics' largest relative gap over {len(want)} steps: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def vq_rows_off(got, want):
    """{buffer: (rows beyond test_parallel.py's 6e-2 + 3e-2 |want|, rows
    beyond 1e-6)} over the HVQVAE's codebooks and EMA sums."""
    out = {}
    for k, w in want.items():
        leaf = k.rsplit(".", 1)[-1]
        if k.startswith("vqvae.") and leaf.startswith(("codebook_", "embed_avg_")):
            d = (got[k] - w).abs()
            out[leaf] = (int((d > 6e-2 + 3e-2 * w.abs()).any(-1).sum()),
                         int((d > 1e-6).any(-1).sum()))
    return out


def check_dp_state(tag, got, want, when, vq_weights=False, phase="21c", exempt=()):
    """@phase's weights and buffers against the unsharded steps @when, at
    test_parallel.py's bounds: the policy's tensors atol 5e-4 / rtol 1e-2
    (the HVQVAE's too with @vq_weights; not the names in @exempt, which the
    caller holds), the HVQVAE's EMA mass within 2e-3
    of its total. Its codebook and EMA-sum rows are reported, not held: at
    the flagship's width (1,024 codes over 512 action steps) each step
    replaces the codes no row chose by batch rows, so a last-bit difference
    in one embedding (the encoder rounds differently over B / 2 rows than
    over B on the card) moves which codes are replaced and what they
    become; ``codebook_noise_floor`` measures that drift without dp, and
    tests/test_torch_mesh.py holds the rows where the rounding is equal.
    Returns a summary."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{phase} {tag}: {k} differs {when}")
            continue
        leaf = k.rsplit(".", 1)[-1]
        vq = k.startswith("vqvae.")
        if vq and leaf.startswith("cluster_size_"):
            check(abs(float(g.sum() - w.sum())) <= 2e-3 * abs(float(w.sum())),
                  f"{phase} {tag}: {k}'s total mass moved {when}")
        elif not (vq and leaf.startswith(("codebook_", "embed_avg_"))) and k not in exempt:
            ok = bool(((g - w).abs() <= 5e-4 + 1e-2 * w.abs()).all())
            check(ok or (vq and not vq_weights),
                  f"{phase} {tag}: {k} beyond tolerance {when}")
            if ok:
                worst = max(worst, float((g - w).abs().max()))
    text = "; ".join(f"{k} {o} rows beyond the bound, {n} beyond 1e-6"
                     for k, (o, n) in vq_rows_off(got, want).items())
    return f"weights max|diff| {worst:.3g} {when}" + (f"; {text}" if text else "")


def codebook_noise_floor(algo, start, batches):
    """The unsharded flagship's own drift: the same steps from @start with
    the HVQVAE encoder's weights scaled by 1 + 1e-6 (a last-bit change),
    against the steps just taken; the HVQVAE's rows that moved."""
    import torch

    want = host_state(algo)
    algo.nets.load_state_dict(start)
    for opt in algo.optimizers.values():
        opt.state.clear()
    with torch.no_grad():
        for p in algo.nets["vqvae"].encoder.parameters():
            p.mul_(1 + 1e-6)
    dp_steps(algo, batches)
    got = host_state(algo)
    return "; ".join(f"{k} {o} rows beyond the bound, {n} beyond 1e-6"
                     for k, (o, n) in vq_rows_off(got, want).items())


def seed_codebooks(algo, batch):
    """The flagship HVQVAE's k-means init and first EMA update from one
    training forward over @batch's actions (no optimizer step), so that
    21c's two sides start from one initialized state. The init is a
    sequential D^2 sampling (1,023 picks of 1,024 codes over 512 action
    steps) that a last-bit change of one embedding redirects, and the
    encoder's convolutions round differently over B / 2 rows than over B
    on the card (logged); tests/test_torch_mesh.py holds the init under dp
    on the CPU, where they do not. Logs that rounding."""
    import torch

    vqvae = algo.nets["vqvae"]
    actions = torch.as_tensor(batch["actions"])
    with deterministic_steps(), torch.no_grad():
        whole = vqvae.encoder(actions)
        halves = torch.cat([vqvae.encoder(part) for part in actions.chunk(2)])
        vqvae.train()
        vqvae(actions, torch.Generator(actions.device).manual_seed(5))
        vqvae.eval()
    log(f"  the HVQVAE encoder over B={actions.shape[0]} rows and over two halves: "
        f"max|diff| {float((whole - halves).abs().max()):.3g}")


def mesh21_run(CB, tag, dev, algo, mesh=None):
    """21c's run of @algo (under the dp @mesh when given): DP_STEPS
    draw-free steps at global B = DP_B, the state after the first and the
    last."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    if mesh is not None:
        shard_state(mesh, algo)
    CB.reset_launch_counts()
    first = {}
    metrics, ms = dp_steps(algo, dp_batches(tag, dev), mesh, first)
    return dict(metrics=metrics, ms=ms, launches=dict(CB.LAUNCHES), first=first,
                state=host_state(algo))


def mesh21_cell(CB, tag, dev, mesh, rank, card, dp1_ms):
    """One cell of 21c on this rank: the DP_LEGS leg @tag at dp = 2 (dropout
    0, no crops; the flagship's codebooks seeded first, ``seed_codebooks``),
    then, on rank 0, the unsharded steps from a deep copy taken before the
    mesh and the HVQVAE's own drift (``codebook_noise_floor``), against
    which rank 0 holds the ranks within the CPU test's tolerances
    (tests/test_parallel.py's, ``check_dp_metrics`` / ``check_dp_state``),
    beside 21b's dp = 1 step (@dp1_ms). Returns, on rank 0, each rank's
    launches."""
    algo = dp_algo(tag, dev, plain_draws=True)
    if "vqvae" in algo.nets:
        seed_codebooks(algo, dp_batches(tag, dev)[0])
    twin = unsharded_copy(algo) if rank == 0 else None
    res = mesh21_run(CB, tag, dev, algo, mesh)
    del algo
    free_card()
    res["digest"] = state_digest(res["state"])
    ranks = gather_ranks(res, ("launches", "metrics", "digest"))
    if rank:
        return None
    start = host_state(twin)
    ref = mesh21_run(CB, tag, dev, twin)
    if "vqvae" in twin.nets:
        ref["floor"] = codebook_noise_floor(twin, start, dp_batches(tag, dev))
    del twin
    free_card()
    per_step = {"stem_pool_fwd": 3, "stem_pool_bwd": 3} if tag == "flagship" else {
        "stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1}
    for r, got in enumerate(ranks):
        check_launches(f"21c {tag} rank {r}", got["launches"], per_step, DP_STEPS)
        check(got["metrics"] == ranks[0]["metrics"] and got["digest"] == ranks[0]["digest"],
              f"21c {tag}: the ranks differ")
    got = ranks[0]
    check_dp_metrics(tag, got["metrics"], ref["metrics"])
    gap = check_dp_state(tag, got["first"], ref["first"], "after step 0", vq_weights=True)
    gap += "; " + check_dp_state(tag, got["state"], ref["state"], "after the last step")
    if "floor" in ref:
        gap += (f"; the unsharded steps' own drift with the HVQVAE encoder's weights moved "
                f"by 1e-6 relative: {ref['floor']}")
    ms, dp1 = statistics.median(got["ms"][1:]), dp1_ms[tag]
    log(f"  21c {tag}: {gap}; rank launches {[r['launches'] for r in ranks]}; ms a step (CUDA "
        f"events): dp=2 rank 0 {', '.join(f'{t:.3f}' for t in got['ms'])}, unsharded "
        f"{', '.join(f'{t:.3f}' for t in ref['ms'])}, 21b dp=1 {dp1:.3f}; dp=2 / dp=1 "
        f"{ms / dp1:.3f} ({card})")
    return {"launches": [r["launches"] for r in ranks]}


def phase_zoo_and_mesh(CB, K, dev, card):
    """21: the zoo (21a) and the mesh at dp = 1 (21b); 21c (dp = 2) runs in
    the pairs of ``phase_mesh_cells``. Returns (kernel 1's zoo rows, 21b's
    median ms a step by leg)."""
    log(f"phase 21: the tokenizer zoo on kernel 1 and the dp / mp mesh ({card})")
    t0 = time.perf_counter()
    kernel_rows = phase_zoo(CB, K, dev, card)
    free_card()
    dp1_ms = phase_mesh_dp1(CB, dev, card)
    log(f"  phase 21 took {time.perf_counter() - t0:.1f} s")
    return kernel_rows, dp1_ms


MESH22_B, MESH22_REQ_B = 64, 16   # phase 22: the global training batch (phase
                                  # 10a's) and the requests' batch
MESH22_PER_STEP = {"flagship": {"stem_pool_fwd": 3, "stem_pool_bwd": 3},
                   "paper": {"stem_pool_fwd": 6, "stem_pool_bwd": 6, "lipvq_assign": 1}}


def mesh22_batches(dev, b=MESH22_B):
    return dp_batches(None, dev, b=b, seed=52)


def mesh22_request():
    """A B = 16 request of 16 steps (observations, context), from a seed."""
    return make_request(np.random.RandomState(53), MESH22_REQ_B, 16)


SERVE22_REQUESTS = 4   # serve22's requests with @times: one checked, three timed


def serve22(algo, request, mesh=None, times=None):
    """get_action on @request (this rank's shards under a dp @mesh) with
    the generator seeded, cuDNN deterministic: the global batch's actions
    on the host. With @times, 3 more requests' host ms go there."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    obs, ctx = request
    if mesh is not None:
        obs, ctx = shard_batch(mesh, obs), shard_batch(mesh, ctx)
    with deterministic_steps():
        algo.generator.manual_seed(9)
        out = algo.get_action(obs, ctx).cpu()
        for _ in range(SERVE22_REQUESTS - 1 if times is not None else 0):
            t0 = time.perf_counter()
            algo.get_action(obs, ctx).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    return out


def check_request_launches(tag, counts, leg, requests=SERVE22_REQUESTS):
    """@requests requests of @leg launched kernel 3 (the rgb trunks' stems,
    as many a request), for the paper kernel 1 once a request, and nothing
    else."""
    fwd = counts.get("stem_pool_fwd", 0)
    check(fwd > 0 and fwd % requests == 0,
          f"{tag}: {requests} requests launched kernel 3 {fwd} times")
    want = {"stem_pool_fwd": fwd // requests}
    if leg == "paper":
        want["lipvq_assign"] = 1
    check_launches(tag, counts, want, requests)


def host_moments(algo, name):
    """Optimizer @name's Adam moments on the host, whole, by parameter
    index (every mp rank calls it)."""
    return {i: {k: algo._full(v).detach().cpu().clone() for k, v in st.items()
                if k in ("exp_avg", "exp_avg_sq")}
            for i, st in enumerate(algo.optimizers[name].state.values())}


def moments_beyond(got, want):
    """Whether an element of the Adam moments @got lies beyond
    test_parallel.py's bound (atol 5e-4, rtol 1e-2) of @want's."""
    return any(bool(((got[i][k] - w).abs() > 5e-4 + 1e-2 * w.abs()).any())
               for i, st in want.items() for k, w in st.items())


# fp32 Adam moments that lie near a cancellation under mp's split products
# (phase 25), by cell: {parameter name's end: elements}. The paper with FAST:
# the GPT's input embedding bias's first moment, a sum over the batch's
# tokens that nearly cancels (one element past test_parallel.py's bound in
# runs DJ, DL and DM on an NVIDIA H100 80GB HBM3 at 700 W).
MESH25_CANCELLING = {"paper fast mp=2": {"embed_encoder.bias": 1}}


def check_moments(tag, got, want, phase, witness=None, exempt=None, names=None):
    """The policy's Adam moments at test_parallel.py's bounds (atol 5e-4,
    rtol 1e-2); returns the largest |diff|. With @witness (the unsharded
    run's moments under ``split_features``: its own rounding of the mp
    ranks' split products), an element beyond the bound passes where its
    gap is within twice the witness's gap at that element, a value that is
    rounding alone, and only in the cell's ``MESH25_CANCELLING`` parameters
    (@names: the parameters' names by index), as many elements as it
    names; counted in @exempt ({name.moment: (elements, largest gap, the
    witness's largest there)})."""
    allowed = MESH25_CANCELLING.get(tag, {})
    worst = 0.0
    for i, st in want.items():
        for k, w in st.items():
            d = (got[i][k] - w).abs()
            beyond = d > 5e-4 + 1e-2 * w.abs()
            if bool(beyond.any()) and witness is not None:
                own = (witness[i][k] - w).abs()
                rounding = beyond & (d <= 2 * own)
                n = int(rounding.sum())
                cap = next((c for end, c in allowed.items() if names[i].endswith(end)), 0)
                if n:
                    exempt[f"{names[i]}.{k}"] = (n, float(d[rounding].max()),
                                                 float(own[rounding].max()))
                if 0 < n <= cap:
                    beyond &= ~rounding
            check(not bool(beyond.any()), f"{phase} {tag}: policy moment {i}.{k} beyond "
                  f"tolerance ({int(beyond.sum())} elements, largest gap {float(d.max()):.3g}; "
                  f"within twice the witness's gap: {exempt})")
            worst = max(worst, float(d.max()))
    return worst


# phase 22's cells: tag -> (DP_LEGS leg, mp). 22a / 22b at dp = 2 at global
# B = 64 (phase 10a's); 22c at (dp, mp) = (1, 2), where every rank takes the
# whole global batch, at B = 32 (a 22a rank's; cut from 64): a rank at B = 64
# would hold what 22a's unsharded rank 0 holds (23.2 GiB reserved, run DM on
# an NVIDIA H100 80GB HBM3), and two such ranks beside the other pair's
# largest cell (23's packed flagship, 26.1 + 13.9 GiB) pass the card's 80 GB
MESH22_CELLS = {"flagship dp=2": ("flagship", 1), "paper dp=2": ("paper", 1),
                "flagship mp=2": ("flagship", 2)}
MESH22_MP_B = 32


def mesh22_run(CB, tag, dev, algo, mesh=None):
    """One phase-22 cell's run of @algo (under @mesh when given): a B = 16
    request (this rank's shards under dp), the steps, the state after the
    first and the last and the policy's Adam moments; under mp a request
    after the steps and the whole-tensor ``serialize`` (every mp rank calls
    it). Returns what phase 22 holds."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    leg, mp = MESH22_CELLS[tag]
    dp_mesh = mesh if mp == 1 else None
    if mesh is not None:
        shard_state(mesh, algo)
    request = mesh22_request()
    res = {"serve_ms": []}
    CB.reset_launch_counts()
    res["serve"] = serve22(algo, request, dp_mesh, res["serve_ms"])
    res["serve_launches"] = dict(CB.LAUNCHES)
    CB.reset_launch_counts()
    first = {}
    batches = mesh22_batches(dev, MESH22_MP_B if mp > 1 else MESH22_B)
    res["metrics"], res["ms"] = dp_steps(algo, batches, dp_mesh, first)
    res["launches"] = dict(CB.LAUNCHES)   # every kernel, 0 where not launched
    res.update(first=first, state=host_state(algo), moments=host_moments(algo, "policy"))
    if mp > 1 and mesh is not None:
        CB.reset_launch_counts()
        res["serve_after"] = serve22(algo, request)
        res["after_launches"] = dict(CB.LAUNCHES)
        res["model"] = algo.serialize()
    return res


def mesh22_cell(CB, tag, dev, meshes, rank, card, work):
    """One cell of phase 22 on this rank: the run of the algo it built
    (the flagship's codebooks seeded first; shard_state hands every rank
    rank 0's state) under @meshes[mp], then, on rank 0, the unsharded run
    from a deep copy of that algo taken before the mesh, against which rank
    0 holds the ranks (``check_mesh22_cell``) with the other rank's small
    results gathered; for 22c rank 0 writes the mp run's .pth under @work
    and serves it from the unsharded algo. Returns, on rank 0, each rank's
    launches."""
    from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils

    leg, mp = MESH22_CELLS[tag]
    algo = dp_algo(leg, dev, plain_draws=False)
    if "vqvae" in algo.nets:
        seed_codebooks(algo, mesh22_batches(dev)[0])
    twin = unsharded_copy(algo) if rank == 0 else None
    res = mesh22_run(CB, tag, dev, algo, meshes[mp])
    del algo
    free_card()
    model = res.pop("model", None)
    res["digest"] = state_digest(res["state"])
    ranks = gather_ranks(res, ("launches", "serve_launches", "after_launches", "metrics",
                               "digest", "serve", "serve_after"))
    if rank:
        return None
    ref = mesh22_run(CB, tag, dev, twin)
    reloaded = None
    if model is not None:
        path = os.path.join(work, "mp2.pth")
        FileUtils.save_checkpoint({"model": model}, path)
        twin.deserialize(FileUtils.maybe_dict_from_checkpoint(ckpt_path=path)["model"])
        reloaded = serve22(twin, mesh22_request())
    del twin
    free_card()
    check_mesh22_cell(tag, ref, ranks, card, reloaded)
    return {k: [r.get(k, {}) for r in ranks]
            for k in ("launches", "serve_launches", "after_launches")} | {
        "unsharded_serve_launches": ref["serve_launches"]}


def check_mesh22_cell(tag, ref, ranks, card, reloaded):
    """A phase 22 cell on rank 0, against the unsharded run: each rank's
    launches (MESH22_PER_STEP a step; its requests those of the unsharded
    requests), the ranks' metrics equal, the metrics, the states after the
    first and the last step and the policy's Adam moments within
    tests/test_parallel.py's bounds, the requests within 1e-3; under mp the
    request after the steps and the mp run's .pth served by an unsharded
    algo within 1e-5."""
    leg, mp = MESH22_CELLS[tag]
    phase, mesh_name = ("22a", "dp=2") if mp == 1 else ("22c", "mp=2")
    serving = "22b" if mp == 1 else "22c"
    check_request_launches(f"22b {leg} unsharded", ref["serve_launches"], leg)
    got = ranks[0]
    for r, res in enumerate(ranks):
        check_launches(f"{phase} {leg} rank {r}", res["launches"], MESH22_PER_STEP[leg],
                       DP_STEPS)
        check(res["metrics"] == got["metrics"] and res["digest"] == got["digest"],
              f"{phase} {leg}: the ranks differ")
        check(res["serve_launches"] == ref["serve_launches"],
              f"{serving} {leg} {mesh_name} rank {r}: requests launched "
              f"{res['serve_launches']}, unsharded {ref['serve_launches']}")
        if "after_launches" in res:
            check_request_launches(f"{serving} {leg} rank {r} after the steps",
                                   res["after_launches"], leg, requests=1)
        serve_gap = float((res["serve"] - ref["serve"]).abs().max())
        check(serve_gap <= 1e-3, f"{serving} {leg} {mesh_name} rank {r}: get_action "
                                 f"max|diff| {serve_gap} from unsharded serving")
    check_dp_metrics(leg, got["metrics"], ref["metrics"], phase)
    gap = check_dp_state(leg, got["first"], ref["first"], "after step 0", vq_weights=True,
                         phase=phase)
    gap += "; " + check_dp_state(leg, got["state"], ref["state"], "after the last step",
                                 phase=phase)
    moments = check_moments(leg, got["moments"], ref["moments"], phase)
    ms, ref_ms = statistics.median(got["ms"][1:]), statistics.median(ref["ms"][1:])
    log(f"  {phase} {leg} {mesh_name}: {gap}; the policy's Adam moments max|diff| "
        f"{moments:.3g}; rank launches {[res['launches'] for res in ranks]}; ms a step (CUDA "
        f"events): {mesh_name} rank 0 {', '.join(f'{t:.3f}' for t in got['ms'])}, unsharded "
        f"{', '.join(f'{t:.3f}' for t in ref['ms'])}; {mesh_name} / unsharded "
        f"{ms / ref_ms:.3f} ({card})")
    gaps = [float((res["serve"] - ref["serve"]).abs().max()) for res in ranks]
    log(f"  {serving} {leg} {mesh_name}: get_action at B={MESH22_REQ_B} on each rank's "
        f"{'shards' if mp == 1 else 'whole request'}: max|diff| from unsharded serving "
        f"{', '.join(f'{g:.3g}' for g in gaps)} (ranks 0, 1; bound 1e-3); request ms (host "
        f"clock) {mesh_name} {', '.join(f'{t:.3f}' for t in got['serve_ms'])}, unsharded "
        f"{', '.join(f'{t:.3f}' for t in ref['serve_ms'])} ({card})")
    if reloaded is not None:
        gap = float((reloaded - got["serve_after"]).abs().max())
        check(gap <= 1e-5, f"22c: the mp run's .pth serves {gap} from the mp run's actions")
        log(f"  22c: the mp run's .pth in an unsharded algo serves the mp run's B="
            f"{MESH22_REQ_B} actions within {gap:.3g} (bound 1e-5)")


# ---------------------------------------------------------------------------
# phase 23: the policy families under dp = 2
# ---------------------------------------------------------------------------

MESH23_STEPS = 2        # steps a cell (the second timed for the ratio)
MESH23_B, MESH23_REQ_B = 64, 16   # the ICL cells' global batch; the requests'
PAPER_POOL = {"stem_pool_fwd": 6, "stem_pool_bwd": 6}
BF16_PAPER_POOL = {"stem_pool_fwd_bf16": 6, "stem_pool_bwd_bf16": 6}
BASE_POOL = {"stem_pool_fwd": 3, "stem_pool_bwd": 3}


def _mesh23_flagship(dev, packed):
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = flagship_config(serving=False, mixed_precision=True,
                          **({"packed_rgb_encoders": True} if packed else {}))
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory("icl", cfg, flagship_shapes(False), 12, device=dev)


def _mesh23_paper_bf16(dev):
    import robot_manipulation_vq_vae_tpu_torch.algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = paper_config(pallas_pool=True, mixed_precision=True)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory("icl_gmm_paper", cfg, SHAPES, 12, device=dev)


def _mesh23_baseline(name, configure=None, half=False):
    def configure_all(cfg):
        if configure is not None:
            configure(cfg)
        cfg.train.mixed_precision = half
    return lambda dev: baseline_algo(name, dev, configure_all)


# tag: (phase, make(dev), global B, window T, the step takes
# process_batch_for_training's batch, request (kind, T), launches a step,
# bf16). Every draw of the shipped configurations is on: the crops, the
# dropouts (the paper's 0.1, the default encoder's), the VAE / diffusion /
# ACT noise and the GMM samples, each at the global batch's shape.
MESH23_CELLS = {
    "flagship bf16": ("23a", lambda dev: _mesh23_flagship(dev, False), MESH23_B, 16, False,
                      ("context", 16), {"stem_pool_fwd_bf16": 3, "stem_pool_bwd_bf16": 3},
                      True),
    "flagship packed bf16": ("23a", lambda dev: _mesh23_flagship(dev, True), MESH23_B, 16,
                             False, ("context", 16), {}, True),
    **{f"paper {m}": ("23b", lambda dev, m=m: modality_algo(m, dev), MESH23_B, 16, False,
                      ("context", 16), PAPER_POOL, False)
       for m in ("bin", "ln_act", "default", "fast")},
    "paper LipVQ bf16": ("23b", _mesh23_paper_bf16, MESH23_B, 16, False, ("context", 16),
                         {**BF16_PAPER_POOL, "lipvq_assign_bf16": 1}, True),
    "ICLMamba_GMM LipVQ bf16": ("23c", lambda dev: mamba_algo(dev, mixed_precision=True),
                                MESH23_B, MAMBA_T, False, ("context", MAMBA_T),
                                {**BF16_PAPER_POOL, "lipvq_assign_bf16": 1}, True),
    "ICLMambaHVQVAE": ("23c", lambda dev: mamba_algo(dev, gmm=False), MESH23_B, MAMBA_T,
                       False, ("context", MAMBA_T), BASE_POOL, False),
    "BC_RNN_GMM": ("23d", _mesh23_baseline("bc", bc_mode("rnn_gmm")), BASELINE_B, BC_T, True,
                   ("rnn", 3), BASE_POOL, False),
    "BC_VAE": ("23d", _mesh23_baseline("bc", bc_mode("vae")), BASELINE_B, 1, True,
               ("obs", None), BASE_POOL, False),
    "BC_Transformer_GMM": ("23d", _mesh23_baseline("bc", bc_mode("transformer_gmm")),
                           BASELINE_B, BC_T, True, ("obs", BC_T), BASE_POOL, False),
    "DiffusionPolicyUNet DDIM": ("23d", _mesh23_baseline("diffusion_policy", ddim_config),
                                 BASELINE_B, DP_TP, True, ("obs", DP_TO), BASE_POOL, False),
    "DiffusionPolicyUNet DDIM bf16": ("23d", _mesh23_baseline(
        "diffusion_policy", ddim_config, half=True), BASELINE_B, DP_TP, True, ("obs", DP_TO),
        {"stem_pool_fwd_bf16": 3, "stem_pool_bwd_bf16": 3}, True),
    "ACT": ("23d", _mesh23_baseline("act"), BASELINE_B, ACT_CHUNK, True,
            ("act", ACT_CHUNK + 1), BASE_POOL, False),
}


# phase 25: the policy cells at (dp, mp) = (1, 2), in MESH23_CELLS' format.
# Every rank takes the whole global batch, so a cell's global batch is a
# phase-23 rank's: B = 32 for the flagship and the paper, half of 23d's
# B = 100 for the baselines; MCR_Transformer on mcr's ResNet-50 core at
# 20e's 10 x 10 (a cut: 50 x 10 windows of three ResNet-50 trunks would not
# leave room for the other pair). Each GPT is split as JAX's _param_spec
# splits it (ACT's style blocks too); ICLMamba_GMM is replicated.
MESH25_B, MESH25_BASE_B, MESH25_MCR_B = MESH23_B // 2, BASELINE_B // 2, 10


def _mesh25_mcr_transformer(dev):
    return mcr_algo(dev, configure=bf16_transformer())


MESH25_CELLS = {
    "flagship bf16 mp=2": ("25", lambda dev: _mesh23_flagship(dev, False), MESH25_B, 16,
                           False, ("context", 16),
                           {"stem_pool_fwd_bf16": 3, "stem_pool_bwd_bf16": 3}, True),
    "flagship packed bf16 mp=2": ("25", lambda dev: _mesh23_flagship(dev, True), MESH25_B,
                                  16, False, ("context", 16), {}, True),
    "paper LipVQ bf16 mp=2": ("25", _mesh23_paper_bf16, MESH25_B, 16, False,
                              ("context", 16), {**BF16_PAPER_POOL, "lipvq_assign_bf16": 1},
                              True),
    # the bin and LN-act tokenizers under mp: the CPU tests alone (the
    # script's clock; tests/test_torch_mesh_mp_families.py)
    **{f"paper {m} mp=2": ("25", lambda dev, m=m: modality_algo(m, dev), MESH25_B, 16, False,
                           ("context", 16), PAPER_POOL, False)
       for m in ("default", "fast")},
    "BC_Transformer_GMM mp=2": ("25", _mesh23_baseline("bc", bc_mode("transformer_gmm")),
                                MESH25_BASE_B, BC_T, True, ("obs", BC_T), BASE_POOL, False),
    "MCR_Transformer mp=2": ("25", _mesh25_mcr_transformer, MESH25_MCR_B, BC_T, True,
                             ("obs", BC_T), BASE_POOL, False),
    "ACT mp=2": ("25", _mesh23_baseline("act"), MESH25_BASE_B, ACT_CHUNK, True,
                 ("act", ACT_CHUNK + 1), BASE_POOL, False),
    "ICLMamba_GMM LipVQ bf16 mp=2": ("25", lambda dev: mamba_algo(dev, mixed_precision=True),
                                     MESH25_B, MAMBA_T, False, ("context", MAMBA_T),
                                     {**BF16_PAPER_POOL, "lipvq_assign_bf16": 1}, True),
}
# the policy cells of phases 23 and 25, by tag
POLICY_CELLS = {**MESH23_CELLS, **MESH25_CELLS}


def mesh23_batches(tag, algo, dev):
    """The cell's MESH23_STEPS training batches from a seed (the same on every
    process), processed where its step takes them so."""
    import torch

    _, _, b, t, process, *_ = POLICY_CELLS[tag]
    gen = torch.Generator(dev).manual_seed(53)
    batches = [make_train_batch(gen, dev, b, t) for _ in range(MESH23_STEPS)]
    return [algo.process_batch_for_training(x) for x in batches] if process else batches


def mesh23_serve(algo, tag, mesh=None):
    """The cell's B = 16 request (``MESH23_CELLS``' kind: a context batch,
    observations [B, T, ...] or [B, ...], or a few stepwise calls after a
    reset) on this rank's shards under a dp @mesh, the generator seeded and
    cuDNN deterministic: the global batch's actions of every call,
    [calls, 16, 12], on the host, and the launches of each call's kernels."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    kind, t = POLICY_CELLS[tag][5]
    rng = np.random.RandomState(54)
    cut = (lambda d: d) if mesh is None else (lambda d: shard_batch(mesh, d))
    if kind == "context":
        obs, ctx = make_request(rng, MESH23_REQ_B, t)
        calls = [lambda: algo.get_action(cut(obs), cut(ctx))]
    elif kind == "obs":
        obs = request_obs(rng, MESH23_REQ_B, t)
        calls = [lambda: algo.get_action(cut(obs))]
    else:
        obs = [request_obs(rng, MESH23_REQ_B) for _ in range(t)]
        calls = [lambda o=o: algo.get_action(cut(o)) for o in obs]
        algo.reset()
    with deterministic_steps():
        algo.generator.manual_seed(9)
        return torch.stack([call().float().cpu() for call in calls])


def launched(CB):
    """The kernels launched since the counts were reset, and how often."""
    return {k: v for k, v in CB.LAUNCHES.items() if v}


def mesh23_grads(algo):
    """Every parameter's last gradient (the averaged, clipped one its
    optimizer stepped) on the host, whole (under mp a split weight's shards
    gathered: every rank calls it)."""
    return {n: algo._full(p.grad).detach().cpu().clone()
            for n, p in algo.nets.named_parameters() if p.grad is not None}


def all_moments(algo):
    """Every optimizer's Adam moments on the host ({optimizer: host_moments})."""
    return {name: host_moments(algo, name) for name in algo.optimizers}


def capture_first_gradients(algo, store):
    """Record the first step's gradients, every list that the step hands
    ``_sync_grads``, flattened in call order on the host: this rank's own under
    store["local"], the data-parallel mean under store["mean"] (the same
    without dp), both before the clipping."""
    import torch

    inner = algo._sync_grads

    def wrapped(grads):
        if algo.global_step == 0:
            store.setdefault("local", []).append(
                torch.cat([g.detach().float().flatten() for g in grads]).cpu())
        out = inner(grads)
        if algo.global_step == 0:
            store.setdefault("mean", []).append(
                torch.cat([g.detach().float().flatten() for g in out]).cpu())
        return out

    algo._sync_grads = wrapped


@contextlib.contextmanager
def split_rows(parts=2):
    """Every convolution and linear layer (``F.conv2d``, ``F.linear``) run as
    @parts calls on equal parts of its input's rows, concatenated: the
    ranks' shapes, and so their kernels' choices and sums, under the
    unsharded step's semantics (BatchNorm's statistics, the draws and the
    loss stay the whole batch's)."""
    import torch
    import torch.nn.functional as F

    saved = {"conv2d": F.conv2d, "linear": F.linear}

    def split(fn, min_dim):
        def run(x, *args, **kwargs):
            if x.dim() < min_dim or x.shape[0] < parts or x.shape[0] % parts:
                return fn(x, *args, **kwargs)
            return torch.cat([fn(c, *args, **kwargs) for c in x.chunk(parts)])
        return run

    F.conv2d, F.linear = split(saved["conv2d"], 4), split(saved["linear"], 2)
    try:
        yield
    finally:
        F.conv2d, F.linear = saved["conv2d"], saved["linear"]


@contextlib.contextmanager
def split_features(parts=2):
    """Every linear layer (``F.linear``) computed as the mp ranks compute a
    split one: its output features in @parts blocks (column-parallel), each
    a sum of @parts products over blocks of its input features
    (row-parallel): the unsharded step with the rounding of mp's split
    products, phase 25's witness."""
    import torch
    import torch.nn.functional as F

    saved = F.linear

    def run(x, w, b=None):
        if w.dim() != 2 or w.shape[0] % parts or w.shape[1] % parts:
            return saved(x, w, b)
        y = torch.cat([sum(saved(xi, wi) for xi, wi in zip(x.chunk(parts, -1),
                                                             wo.chunk(parts, 1)))
                       for wo in w.chunk(parts, 0)], -1)
        return y if b is None else y + b

    F.linear = run
    try:
        yield
    finally:
        F.linear = saved


class OneRank:
    """A data-parallel axis of one rank: ``parallel.AxisComm``'s calls, each
    the identity. Modules given it run the data-parallel step's arithmetic
    on the whole batch (BatchNorm through ``global_batch_norm``'s formula
    rather than the native kernel's)."""

    size, rank = 1, 0

    def all_reduce_(self, t, op="sum"):
        return t

    def all_gather(self, t, dim=0):
        return t

    def broadcast_(self, t, src=0):
        return t

    def sum(self, t):
        return t

    def gather(self, t):
        return t

    def chunk(self, t, dim=0):
        return t

    def mean_(self, tensors):
        return tensors


def _vec_gap(a, b):
    """||a - b|| / ||b|| of two flat gradient vectors."""
    return float((a - b).norm() / b.norm())


def mesh23_run(CB, tag, dev, mesh=None, work=None, algo=None):
    """One cell from its start state (the seed's weights, @algo when given;
    in phase 23 a HVQVAE's seeded codebooks, which the unsharded run writes
    to @work and the ranks read; phase 25's cells come seeded): the
    request, then the steps (on @mesh's shards), the stem pools' (shape,
    dtype) recorded. A phase-23 bf16 cell also records its first step's
    gradients before the clipping (``capture_first_gradients``): a rank its
    own and the averaged one as vectors; the unsharded run takes that step
    twice more from the start state, the witnesses: under ``split_rows``
    (the ranks' shapes for every convolution and linear layer), and so with
    its modules on a ``OneRank`` axis as well (the dp step's arithmetic in
    one process), and keeps the three vectors. Returns what phase 23 or 25
    holds."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    phase, make, half = POLICY_CELLS[tag][0], POLICY_CELLS[tag][1], POLICY_CELLS[tag][7]
    algo = make(dev) if algo is None else algo
    if "vqvae" in algo.nets and work is not None:
        path = os.path.join(work, f"{tag}_start.pt")
        if mesh is None:
            seed_codebooks(algo, mesh23_batches(tag, algo, dev)[0])
            torch.save(host_state(algo), path)
        else:
            algo.nets.load_state_dict(torch.load(path))
    start = host_state(algo) if mesh is None and half else None
    if mesh is not None:
        shard_state(mesh, algo)
    # the planted faults and witnesses of a dp step's gradient (phase 23)
    faults = half and phase != "25"
    first = {}
    if faults:
        capture_first_gradients(algo, first)
    pools = set()
    handles = [m.register_forward_pre_hook(lambda mod, args: pools.add(
        (tuple(args[0].shape), str(args[0].dtype).split(".")[-1])))
        for m in algo.nets.modules() if type(m).__name__ == "StemMaxPool"]
    CB.reset_launch_counts()
    res = {"serve": mesh23_serve(algo, tag, mesh), "serve_launches": launched(CB)}
    CB.reset_launch_counts()
    after_first = {}
    res["metrics"], res["ms"] = dp_steps(algo, mesh23_batches(tag, algo, dev), mesh,
                                         after_first if half else None)
    res["launches"] = launched(CB)
    for h in handles:
        h.remove()
    res.update(pools=pools, state=host_state(algo))
    if half:   # the named parameters' first step (MESH23_SIGN_NOISE)
        res["sign_first"] = {n: v for n, v in after_first.items()
                             if n.endswith(MESH23_SIGN_NOISE)}
        if start is not None:
            res["sign_start"] = {n: start[n] for n in res["sign_first"]}
        del after_first
    # a bf16 cell is held by its gradients and every optimizer's moments too,
    # an fp32 one by the policy's moments and its weights
    if half:
        name_of = {id(p): n for n, p in algo.nets.named_parameters()}
        res.update(grads=mesh23_grads(algo), moments=all_moments(algo),
                   moment_names={name: [name_of[id(p)] for g in opt.param_groups
                                        for p in g["params"]]
                                 for name, opt in algo.optimizers.items()})
    else:
        res["moments"] = host_moments(algo, "policy")
        name_of = {id(p): n for n, p in algo.nets.named_parameters()}
        res["moment_names"] = [name_of.get(id(p), str(i)) for i, p in
                               enumerate(algo.optimizers["policy"].state)]
    if faults and mesh is None:
        vecs = {"ref": torch.cat(first["mean"])}
        for witness, axis in (("halves", None), ("dp_arithmetic", OneRank())):
            algo.nets.load_state_dict(start)
            algo.global_step = 0
            for m in algo.nets.modules():
                if hasattr(type(m), "dp"):
                    m.dp = axis
            first.clear()
            with split_rows():
                dp_steps(algo, mesh23_batches(tag, algo, dev)[:1])
            vecs[witness] = torch.cat(first["mean"])
        res["vecs"] = vecs
        res["witness"] = {k: _vec_gap(v, vecs["ref"]) for k, v in vecs.items() if k != "ref"}
    elif faults:
        res["own"], res["mean"] = torch.cat(first["local"]), torch.cat(first["mean"])
    del algo
    free_card()
    return res


def mesh23_first(res, vecs, rank):
    """A bf16 cell's first-step gradient gaps on this rank: the averaged
    vector against the unsharded step's (rank 0 also against the two
    witnesses), and the planted faults (this rank's own gradient, not
    averaged, and half of it) against the unsharded step's. @vecs: the
    unsharded run's vectors on rank 0; its reference vector is broadcast."""
    import torch
    import torch.distributed as dist

    own, mean = res.pop("own"), res.pop("mean")
    want = vecs["ref"] if rank == 0 else torch.empty_like(mean)
    dist.broadcast(want, 0)
    res["first"] = {"dp": _vec_gap(mean, want), "not_averaged": _vec_gap(own, want),
                    "half_left_out": _vec_gap(own / 2, want)}
    if rank == 0:
        res["first"].update(dp_vs_halves=_vec_gap(mean, vecs["halves"]),
                            dp_vs_dp_arithmetic=_vec_gap(mean, vecs["dp_arithmetic"]))


def unsharded_copy(algo):
    """A deep copy of @algo as built (no step taken, no mesh): the same
    seed's weights, buffers, optimizers and generator state without a
    second build, its cuDNN RNNs' weights compacted again (a copy's are
    not one chunk)."""
    import torch

    twin = copy.deepcopy(algo)
    for a in algos_of(twin):
        for m in (getattr(a, "model", None) or a.nets).modules():
            if isinstance(m, torch.nn.RNNBase):
                m.flatten_parameters()
    return twin


def state_digest(state):
    """{name: sha1 of the tensor's float32 bytes} of a state dict: two
    ranks' states equal to the bit have equal digests."""
    return {k: hashlib.sha1(v.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in state.items()}


def gather_ranks(res, keep):
    """Every rank's @res with only the @keep keys (small: metrics, launches,
    digests, requests), gathered over the default group in rank order;
    rank 0 gets its own @res whole."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, {k: res[k] for k in keep if k in res})
    out[dist.get_rank()] = res
    return out


def mesh23_cell(CB, tag, dev, mesh, work, rank, card):
    """One cell of phase 23 on this rank: rank 0 first takes the unsharded
    run from a deep copy of the algo it built (the same seed's weights,
    with no second build), then both ranks the dp = 2 run, whose states
    rank 0 holds against the unsharded run's (``check_mesh23_cell``) with
    the other rank's small results gathered. Returns, on rank 0, what the
    parent records: each rank's launches and the stem shapes pooled."""
    import torch.distributed as dist

    algo = POLICY_CELLS[tag][1](dev)
    ref = vecs = None
    if rank == 0:
        ref = mesh23_run(CB, tag, dev, work=work, algo=unsharded_copy(algo))
        vecs = ref.pop("vecs", None)
    dist.barrier()   # the cell's start state is on disk
    res = mesh23_run(CB, tag, dev, mesh, work, algo=algo)
    del algo
    if "own" in res:
        mesh23_first(res, vecs, rank)
    res["digest"] = state_digest(res["state"])
    ranks = gather_ranks(res, ("launches", "serve_launches", "metrics", "digest", "serve",
                               "pools", "first"))
    if rank:
        return None
    check_mesh23_cell(tag, ref, ranks, card)
    return {"launches": [r["launches"] for r in ranks],
            "serve_launches": [r["serve_launches"] for r in ranks],
            "pools": set().union(*(r["pools"] for r in ranks))}


def mesh25_cell(CB, tag, dev, mesh, rank, card):
    """One policy cell of phase 25 on this rank: the algo it built (a
    HVQVAE's codebooks seeded on every rank; shard_state hands every rank
    rank 0's state) under @mesh, (dp, mp) = (1, 2), then, on rank 0, the
    unsharded run from a deep copy of that algo taken before the mesh,
    against which rank 0 holds the ranks (``check_mesh23_cell``) with the
    other rank's small results gathered: no state leaves its process.
    Returns, on rank 0, what the parent records: each rank's launches and
    the stem shapes pooled."""
    algo = POLICY_CELLS[tag][1](dev)
    if "vqvae" in algo.nets:
        seed_codebooks(algo, mesh23_batches(tag, algo, dev)[0])
    half = POLICY_CELLS[tag][7]
    twin = unsharded_copy(algo) if rank == 0 else None
    witness = unsharded_copy(algo) if rank == 0 and not half else None
    res = mesh23_run(CB, tag, dev, mesh, algo=algo)
    del algo
    free_card()
    res["digest"] = state_digest(res["state"])
    ranks = gather_ranks(res, ("launches", "serve_launches", "metrics", "digest", "serve",
                               "pools"))
    if rank:
        return None
    ref = mesh23_run(CB, tag, dev, algo=twin)
    del twin
    free_card()
    if witness is not None and moments_beyond(ranks[0]["moments"], ref["moments"]):
        # the unsharded run with mp's rounding, taken where an fp32 cell's
        # moment lies beyond the elementwise bound
        with split_features():
            ref["witness_moments"] = mesh23_run(CB, tag, dev, algo=witness)["moments"]
    del witness
    free_card()
    check_mesh23_cell(tag, ref, ranks, card)
    return {"launches": [r["launches"] for r in ranks],
            "serve_launches": [r["serve_launches"] for r in ranks],
            "pools": set().union(*(r["pools"] for r in ranks))}


def _grad_gap(a, b):
    """||a - b|| / ||b|| over two runs' gradients, as one vector."""
    import torch

    want = torch.cat([g.flatten() for g in b.values()])
    return float((torch.cat([a[n].flatten() for n in b]) - want).norm() / want.norm())


def _stat_flips(got, want):
    """How many BatchNorm statistic elements lie beyond 1e-4 of @want's,
    and of how many."""
    flips = n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")) and not k.startswith("vqvae."):
            flips += int(((got[k] - v).abs() > 1e-4).sum())
            n += v.numel()
    return flips, n


# phase 23's bf16 bounds, fixed: metrics relative; the gradients as one
# vector relative to their norm (the first step's before the clipping and
# the last step's after it), between the sound runs' largest reading (3.4 %
# on the card, CP) and the planted faults' smallest (53 %): each rank's
# planted faults (its gradient not averaged, half of the batch left out)
# must read above it; each gradient tensor and each Adam moment relative to
# its own norm; BatchNorm's statistics beyond 1e-4 as a share of them.
MESH23_BF16 = {"metric": 1e-3, "vector": 0.1, "tensor": 0.5, "rounding_only": 1e-5,
               "flips": 0.01}
# tensors whose true gradient is 0, so that their bf16 gradient is rounding
# alone: SpatialSoftmax's keypoint convolution bias (the softmax over each
# plane is blind to a shift of its channel; on the card their gradients'
# norms are 1e-7 to 9e-7 of the network's, CP). Held, and their moments,
# within MESH23_BF16["rounding_only"] of the network's norm.
MESH23_ROUNDING_ONLY = (".pool.nets.bias",)
# parameters where an element may lie beyond test_parallel.py's bound by
# Adam's first step, lr times its gradient's sign (0 for a zero gradient),
# when that sign rounds apart: LipVQ's output layer (AdamW at lr 1e-3; CR:
# one bias element stepped 0 at dp = 2 and 9.9e-4 unsharded). Such an
# element must show it: its first step went different ways in the two runs.
MESH23_SIGN_NOISE = ("action_network.decoder.2.weight", "action_network.decoder.2.bias")


def _tensor_gaps(got, want, scale_of):
    """[(||got - want|| / scale_of(name, want), name)] over @want's tensors,
    largest first."""
    return sorted(((float((got[n] - w).norm()) / max(scale_of(n, w), 1e-30), n)
                   for n, w in want.items()), reverse=True)


def check_bf16_dp(tag, got, ref, ranks, phase):
    """A bf16 cell at MESH23_BF16's fixed bounds: metrics; the gradients as
    one vector, at the first step (before the clipping, every list the step
    averages) and the last (after it); each last gradient tensor and each
    Adam moment of every optimizer against its own norm (MESH23_ROUNDING_ONLY
    against the network's); BatchNorm's statistics; the weights and buffers
    at test_parallel.py's bounds (``check_dp_state``; MESH23_SIGN_NOISE as
    it says). Each rank's planted faults read above the vector bound. The
    witnesses (the unsharded step on the ranks' shapes, and with the dp
    step's arithmetic too) are reported beside the dp step's gap. Returns a
    summary."""
    import torch

    tol = MESH23_BF16
    worst_metric = 0.0
    for step, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k, v in w.items():
            gap = abs(g[k] - v) / max(abs(v), 1e-30)
            worst_metric = max(worst_metric, gap)
            check(gap <= tol["metric"], f"{phase} {tag} step {step} {k}: {g[k]} vs {v}")
    vec = _grad_gap(got["grads"], ref["grads"])
    check(vec <= tol["vector"], f"{phase} {tag}: the last gradients differ by {vec} of their norm")
    # a dp cell's first step, planted faults and witnesses (phase 23)
    first = [res["first"] for res in ranks] if "first" in ranks[0] else None
    if first:
        check(first[0]["dp"] <= tol["vector"], f"{phase} {tag}: the first step's gradients "
              f"differ by {first[0]['dp']} of their norm")
        for r, f in enumerate(first):
            check(min(f["not_averaged"], f["half_left_out"]) > tol["vector"],
                  f"{phase} {tag} rank {r}: a planted fault reads {f} within the bound")
    net_norm = float(torch.cat([g.flatten() for g in ref["grads"].values()]).norm())

    def bounded(gaps, what):
        """@gaps [(gap / own norm, name)] within MESH23_BF16["tensor"], but
        MESH23_ROUNDING_ONLY's (held against the network's norm apart)."""
        for t, n in gaps:
            if n.endswith(MESH23_ROUNDING_ONLY):
                continue
            check(t <= tol["tensor"], f"{phase} {tag}: {what} {n} {t} of its norm apart")

    def own(name, w):
        return float(w.norm())

    tensors = _tensor_gaps(got["grads"], ref["grads"], own)
    bounded(tensors, "gradient")
    tensors = [(t, n) for t, n in tensors if not n.endswith(MESH23_ROUNDING_ONLY)]
    for n, g in ref["grads"].items():
        if n.endswith(MESH23_ROUNDING_ONLY):
            gap = float((got["grads"][n] - g).norm())
            check(gap <= tol["rounding_only"] * net_norm,
                  f"{phase} {tag}: rounding-only gradient {n} {gap / net_norm} of the network's")
    rounding = {n: (round(float(g.norm()) / net_norm, 9),
                    round(float((got["grads"][n] - g).norm()) / max(float(g.norm()), 1e-30), 3))
                for n, g in ref["grads"].items() if n.endswith(MESH23_ROUNDING_ONLY)}
    moments = []
    for name, want in ref["moments"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            whole = float(torch.cat([st[k].flatten() for st in want.values()]).norm())
            named = {ref["moment_names"][name][i]: st[k] for i, st in want.items()}
            mine = {ref["moment_names"][name][i]: st[k]
                    for i, st in got["moments"][name].items()}
            gaps = _tensor_gaps(mine, named, own)
            bounded(gaps, f"{name} {k}")
            moments += [(t, f"{name} {k} {n}") for t, n in gaps
                        if not n.endswith(MESH23_ROUNDING_ONLY)]
            for n, m in named.items():
                if n.endswith(MESH23_ROUNDING_ONLY):
                    gap = float((mine[n] - m).norm())
                    check(gap <= tol["rounding_only"] * whole,
                          f"{phase} {tag}: rounding-only {name} {k} {n} {gap / whole} of all")
    moments.sort(reverse=True)
    flips, n_stats = _stat_flips(got["state"], ref["state"])
    check(flips <= tol["flips"] * n_stats, f"{phase} {tag}: {flips} of {n_stats} BatchNorm "
          "statistics beyond 1e-4")
    sign_noise = {}
    for n, w0 in ref["sign_start"].items():
        beyond = (got["state"][n] - ref["state"][n]).abs() > 5e-4 + 1e-2 * ref["state"][n].abs()
        if bool(beyond.any()):
            mine, theirs = got["sign_first"][n] - w0, ref["sign_first"][n] - w0
            check(bool((torch.sign(mine) != torch.sign(theirs))[beyond].all()),
                  f"{phase} {tag}: {n} moved beyond the bound without its first step "
                  "going different ways")
            sign_noise[n] = (int(beyond.sum()), float(mine[beyond].abs().max()),
                             float(theirs[beyond].abs().max()))
    dp_part = ""
    if first:
        faults = {k: ", ".join(f"{f[k]:.3g}" for f in first)
                  for k in ("not_averaged", "half_left_out")}
        wit = ref["witness"]
        dp_part = (
            f"first step's gradients {first[0]['dp']:.3g} of their norm from unsharded; "
            f"witnesses: the ranks' shapes {wit['halves']:.3g} from unsharded and "
            f"{first[0]['dp_vs_halves']:.3g} from dp, with the dp step's arithmetic "
            f"{wit['dp_arithmetic']:.3g} from unsharded and "
            f"{first[0]['dp_vs_dp_arithmetic']:.3g} from dp; planted faults (ranks 0, 1): a "
            f"rank's gradient not averaged {faults['not_averaged']}, half of the batch left "
            f"out {faults['half_left_out']}; ")
    return (f"metrics' largest relative gap {worst_metric:.3g}; {dp_part}"
            f"last gradients {vec:.3g} of their norm, the "
            f"largest tensor gaps {', '.join(f'{n} {t:.3g}' for t, n in tensors[:3])} of "
            f"their norm; rounding-only tensors (norm / the network's, gap / own norm) "
            f"{rounding}; Adam moments' largest gaps "
            f"{', '.join(f'{n} {t:.3g}' for t, n in moments[:3])} of their norm; {flips} of "
            f"{n_stats} BatchNorm statistics beyond 1e-4; Adam's first step different ways "
            f"(elements, |step| dp, unsharded) {sign_noise}; "
            + check_dp_state(tag, got["state"], ref["state"], "after the last step",
                             vq_weights=True, phase=phase, exempt=tuple(sign_noise)))


def check_mesh23_cell(tag, ref, ranks, card):
    """A phase 23 cell on rank 0: each rank's launches those of the
    unsharded run's requests and steps (the same launches on half the rows),
    the request within 1e-3, the steps within tests/test_parallel.py's
    bounds (fp32) or ``check_bf16_dp``'s fixed ones (bf16), the ranks equal
    to the bit, the dp = 2 / unsharded ratio of the second step. @ranks:
    rank 0's results whole, the other's small ones (``gather_ranks``)."""
    phase, *_, per_step, half = POLICY_CELLS[tag]
    mesh_name = "mp=2" if phase == "25" else "dp=2"
    got = ranks[0]
    check(ref["launches"] == {k: v * MESH23_STEPS for k, v in per_step.items()},
          f"{phase} {tag}: unsharded steps launched {ref['launches']}")
    for r, res in enumerate(ranks):
        check(res["launches"] == ref["launches"],
              f"{phase} {tag} rank {r}: steps launched {res['launches']}, unsharded "
              f"{ref['launches']}")
        check(res["serve_launches"] == ref["serve_launches"],
              f"{phase} {tag} rank {r}: the request launched {res['serve_launches']}, "
              f"unsharded {ref['serve_launches']}")
        check(res["metrics"] == got["metrics"] and res["digest"] == got["digest"],
              f"{phase} {tag}: the ranks differ")
        gap = float((res["serve"] - ref["serve"]).abs().max())
        check(gap <= 1e-3, f"{phase} {tag} rank {r}: the request is {gap} from "
                           "unsharded serving")
    if half:
        summary = check_bf16_dp(tag, got, ref, ranks, phase)
    else:
        check_dp_metrics(tag, got["metrics"], ref["metrics"], phase)
        summary = check_dp_state(tag, got["state"], ref["state"], "after the last step",
                                 vq_weights=True, phase=phase)
        exempt = {}
        worst = check_moments(tag, got["moments"], ref["moments"], phase,
                              ref.get("witness_moments"), exempt, ref["moment_names"])
        summary += f"; Adam moments max|diff| {worst:.3g}"
        if "witness_moments" in ref:
            summary += (f" (beyond test_parallel.py's bound within twice the split-rounding "
                        f"witness's gap at the element, {sum(v[0] for v in exempt.values())} "
                        f"elements, allowed {MESH25_CANCELLING.get(tag, {})}; parameter.moment: "
                        f"(elements, gap, witness's): {exempt})")
    gaps = [float((res["serve"] - ref["serve"]).abs().max()) for res in ranks]
    log(f"  {phase} {tag}: {summary}; request max|diff| "
        f"{', '.join(f'{g:.3g}' for g in gaps)} (ranks 0, 1; bound 1e-3); launches a rank "
        f"{got['launches']} over {MESH23_STEPS} steps (unsharded {ref['launches']}), "
        f"{got['serve_launches']} a request; ms a step (CUDA events) {mesh_name} rank 0 "
        f"{', '.join(f'{t:.3f}' for t in got['ms'])}, unsharded "
        f"{', '.join(f'{t:.3f}' for t in ref['ms'])}; {mesh_name} / unsharded "
        f"{got['ms'][-1] / ref['ms'][-1]:.3f} ({card})")


# 21c and phases 22-25 run on MESH_PAIRS pairs of gloo ranks at once, each
# pair on its own cells; a cell's seconds with both pairs running (run DL,
# on an NVIDIA H100 80GB HBM3 at 700 W; 21c's estimated from its serial
# time) spread the cells over the pairs, longest first. Two pairs: a
# rank 0's unsharded run at the global batch peaks near 27 GiB reserved
# (23's flagship packed bf16 at B = 64), a dp rank near two thirds of
# that and an mp rank near a dp rank (its global batch is a dp rank's), so
# that two pairs stay inside the card's 80 GB and three might not
MESH_PAIRS = 2
MESH_CELL_S = {
    ("21c", "flagship"): 25.0, ("21c", "paper"): 15.0, ("22", "flagship dp=2"): 27.5,
    ("22", "paper dp=2"): 16.3, ("22", "flagship mp=2"): 16.4,
    ("23", "flagship bf16"): 20.0, ("23", "flagship packed bf16"): 27.9,
    ("23", "paper bin"): 19.6, ("23", "paper ln_act"): 16.1, ("23", "paper default"): 26.4,
    ("23", "paper fast"): 11.5, ("23", "paper LipVQ bf16"): 27.0,
    ("23", "ICLMamba_GMM LipVQ bf16"): 24.4, ("23", "ICLMambaHVQVAE"): 19.7,
    ("23", "BC_RNN_GMM"): 8.5, ("23", "BC_VAE"): 6.0, ("23", "BC_Transformer_GMM"): 9.8,
    ("23", "DiffusionPolicyUNet DDIM"): 18.1, ("23", "DiffusionPolicyUNet DDIM bf16"): 39.8,
    ("23", "ACT"): 9.4, ("24", "IQL"): 25.8, ("24", "TD3_BC"): 18.7, ("24", "CQL"): 20.1,
    ("24", "BCQ"): 22.4, ("24", "HBC"): 17.3, ("24", "IRIS"): 19.7, ("24", "MCR_GMM"): 12.1,
    ("24", "MCR pretraining"): 13.6, ("25", "flagship bf16 mp=2"): 12.8,
    ("25", "flagship packed bf16 mp=2"): 17.3, ("25", "paper LipVQ bf16 mp=2"): 18.3,
    ("25", "paper default mp=2"): 27.1, ("25", "paper fast mp=2"): 21.8,
    ("25", "BC_Transformer_GMM mp=2"): 20.1, ("25", "MCR_Transformer mp=2"): 25.1,
    ("25", "ACT mp=2"): 19.3, ("25", "ICLMamba_GMM LipVQ bf16 mp=2"): 16.1,
    ("25", "HBC mp=2"): 12.4,
}


def mesh_plan(pairs=MESH_PAIRS):
    """The cells [(phase, tag)] of 21c and phases 22 to 25 for each of
    @pairs pairs of ranks: longest first, each to the pair with the least
    work so far."""
    cells = ([("21c", t) for t in DP_LEGS] + [("22", t) for t in MESH22_CELLS]
             + [("23", t) for t in MESH23_CELLS]
             + [("24", t) for t in MESH24_CELLS]
             + [("25", t) for t in (*MESH25_CELLS, *MESH25_NESTED)])
    plan, load = [[] for _ in range(pairs)], [0.0] * pairs
    for cell in sorted(cells, key=lambda c: -MESH_CELL_S.get(c, 10.0)):
        i = load.index(min(load))
        plan[i].append(cell)
        load[i] += MESH_CELL_S.get(cell, 10.0)
    return plan


def mesh_cells_rank(index, ports, work, card, plan, dp1_ms):
    """Process @index of phases 22 to 25: rank index % 2 of pair index // 2,
    a gloo group of two over tcp at its port of @ports, on the one card;
    every cell of the pair's part of @plan, at dp = 2 (``mesh21_cell``,
    ``mesh23_cell``, ``mesh24_cell``), at (dp, mp) = (1, 2) (``mesh25_cell``,
    ``mesh24_cell``), or phase 22's (``mesh22_cell``). Rank 0 holds each
    against the unsharded run it takes itself; it writes, to
    @work/pair<i>_rank0.pt, each cell's log lines and what the parent
    records (each rank's launches, the stem shapes pooled), and each rank
    its cells' seconds and peak reserved device memory; a failed check's
    lines are printed before it raises. @card: the card's name and power
    limit, for the log."""
    global LOG_SINK
    import torch
    import torch.distributed as dist

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB
    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh

    pair, rank = divmod(index, 2)
    torch.set_num_threads(2)   # the pairs share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    torch.cuda.set_device(dev)
    CB.build_kernels()   # loads the libraries the parent built
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[pair]}",
                            world_size=2, rank=rank)
    out = {}
    try:
        meshes = {1: make_mesh(device=dev), 2: make_mesh(mp=2, device=dev)}
        for phase, tag in plan[pair]:
            LOG_SINK = []   # rank 0's lines go to the parent
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            try:
                if phase == "21c":
                    res = mesh21_cell(CB, tag, dev, meshes[1], rank, card, dp1_ms)
                elif phase == "22":
                    res = mesh22_cell(CB, tag, dev, meshes, rank, card, work)
                elif phase == "23":
                    res = mesh23_cell(CB, tag, dev, meshes[1], work, rank, card)
                elif phase == "24" or tag in MESH25_NESTED:
                    res = mesh24_cell(CB, tag, dev, meshes[1 if phase == "24" else 2], rank,
                                      card)
                else:
                    res = mesh25_cell(CB, tag, dev, meshes[2], rank, card)
            except BaseException:
                for line in LOG_SINK or ():
                    print(line, flush=True)
                raise
            out[(phase, tag)] = dict(res or {}, lines=LOG_SINK if rank == 0 else None,
                                     seconds=time.perf_counter() - t,
                                     peak_gib=torch.cuda.max_memory_reserved(dev) / 2**30)
    finally:
        LOG_SINK = None
        dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"pair{pair}_rank{rank}.pt"))


def check_rank_pools(S, dev, phase, pools, seed):
    """Kernels 3 and 4 bit-equal to the plain pool at each stem (shape,
    dtype) in @pools that @phase's ranks pooled."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    for shape, dtype in sorted(pools):
        x = relu_input(shape, gen, dev).to(getattr(torch, dtype))
        out_k, idx_k = S.pool_fwd_cuda(x)
        out_p, idx_p = S.pool_fwd_plain(x)
        g = torch.randn(out_k.shape, generator=gen, device=dev).to(x.dtype)
        same = (torch.equal(out_k, out_p) and torch.equal(idx_k, idx_p) and torch.equal(
            S.pool_bwd_cuda(idx_k, g, shape[2:]), S.pool_bwd_plain(idx_p, g, shape[2:])))
        check(same, f"{phase}: kernels 3 / 4 differ from plain at the ranks' {shape} {dtype}")
    log(f"  {phase}: kernels 3 and 4 bit-equal to the plain pool at the ranks' "
        f"{len(pools)} stem shapes {sorted(pools)}")


def check_phase6_pools(phase, pools):
    """Every stem (shape, dtype) in @pools is one phase 6 holds against the
    plain pool (POOL_SHAPES in fp32, POOL_SHAPES_BF16 in bf16)."""
    held = {"float32": set(POOL_SHAPES), "bfloat16": set(POOL_SHAPES_BF16)}
    missing = sorted(p for p in pools if tuple(p[0]) not in held[p[1]])
    check(not missing, f"{phase}: phase 6 holds none of the stems {missing}")


def phase_mesh_cells(CB, S, dev, card, dp1_ms):
    """21c and 22 to 25: the draw-free steps at dp = 2 (``DP_LEGS``, beside
    21b's @dp1_ms), the shipped draws and the .pth under the mesh
    (``MESH22_CELLS``), the policy families (``MESH23_CELLS``), offline RL,
    the hierarchical family, MCR and its pretraining (``MESH24_CELLS``) at
    dp = 2, and every family at (dp, mp) = (1, 2) (``MESH25_CELLS``,
    ``MESH25_NESTED``), each cell on a pair of processes on the one card over
    gloo, MESH_PAIRS pairs at once (``mesh_plan``); rank 0 of a pair takes
    each cell's unsharded run itself and holds the ranks against it, so that
    no state leaves its process. Here: each cell's lines in order, each
    rank's launches recorded by path, each rank's peak reserved memory, and
    each stem shape the ranks pooled held against the plain pool."""
    import torch
    import torch.multiprocessing as tmp

    plan = mesh_plan()
    ports = []
    while len(ports) < len(plan):
        port = free_port()
        if port not in ports:
            ports.append(port)
    log(f"phases 21c and 22 to 25: {sum(map(len, plan))} cells on {len(plan)} pairs of processes at "
        f"once, each pair on the one card over gloo, each cell's unsharded run on its pair's "
        f"rank 0 from a deep copy of the algo it built; the step times are taken beside the "
        f"other pairs' ({card})")
    t0 = time.perf_counter()
    # the ranks' allocator grows its segments rather than caching blocks of
    # every size, so that what a pair reserves stays near what it holds
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as work:
            tmp.spawn(mesh_cells_rank, args=(ports, work, card, plan, dp1_ms),
                      nprocs=2 * len(plan), join=True)
            cells, peaks = {}, {}
            for i in range(len(plan)):
                cells.update(torch.load(os.path.join(work, f"pair{i}_rank0.pt"),
                                        weights_only=False))
                peaks.update(torch.load(os.path.join(work, f"pair{i}_rank1.pt"),
                                        weights_only=False))
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    log(f"  the pairs took {time.perf_counter() - t0:.1f} s; by pair, each cell's seconds "
        f"and its ranks' peak reserved device memory (GiB, ranks 0 / 1): " + "; ".join(
            ", ".join(f"{ph} {tag} {cells[(ph, tag)]['seconds']:.1f} s "
                      f"{cells[(ph, tag)]['peak_gib']:.1f} / {peaks[(ph, tag)]['peak_gib']:.1f}"
                      for ph, tag in cell_list)
            for cell_list in plan))
    log(f"phase 21c: dp = 2 on the one card, {DP_STEPS} steps of the flagship and of "
        f"icl_gmm_paper at B={DP_B} (B/2 a rank), dropout 0 and no crops, against rank 0's "
        f"unsharded steps ({card})")
    for tag in DP_LEGS:
        res = cells[("21c", tag)]
        for line in res["lines"]:
            log(line)
        for r in range(2):
            record_path(f"phase 21c {tag} dp=2 rank {r}", res["launches"][r])
    log(f"phase 22: the mesh with the shipped draws (dropout 0.1, crops), get_action under it "
        f"and the GPT under mp = 2 with its .pth: {DP_STEPS} steps at global B={MESH22_B} "
        f"(22c: {MESH22_MP_B}) and requests at B={MESH22_REQ_B} ({card})")
    for tag, (leg, mp) in MESH22_CELLS.items():
        res = cells[("22", tag)]
        for line in res["lines"]:
            log(line)
        phase, mesh_name = ("22a", "dp=2") if mp == 1 else ("22c", "mp=2")
        serving = "22b" if mp == 1 else "22c"
        record_path(f"phase 22b {leg} unsharded serving", res["unsharded_serve_launches"])
        for r in range(2):
            record_path(f"phase {phase} {leg} {mesh_name} rank {r}", res["launches"][r])
            record_path(f"phase {serving} {leg} {mesh_name} serving rank {r}",
                        res["serve_launches"][r])
            if res["after_launches"][r]:
                record_path(f"phase {serving} {leg} {mesh_name} serving rank {r}",
                            res["after_launches"][r])
    log(f"phase 23: the policy families at dp = 2 (bf16 and packed flagship, the paper's "
        f"tokenizers, icl_mamba, the bc classes, the diffusion policy, ACT), "
        f"{MESH23_STEPS} steps and a B={MESH23_REQ_B} request a cell ({card})")
    for tag, (phase, *_) in MESH23_CELLS.items():
        res = cells[("23", tag)]
        for line in res["lines"]:
            log(line)
        for r in range(2):
            record_path(f"phase {phase} {tag} dp=2 rank {r} training", res["launches"][r])
            record_path(f"phase {phase} {tag} dp=2 rank {r} serving", res["serve_launches"][r])
    check_rank_pools(S, dev, "23", set().union(*(cells[("23", t)]["pools"]
                                                 for t in MESH23_CELLS)), 55)
    log_mesh24_header(card)
    for tag in MESH24_CELLS:
        res = cells[("24", tag)]
        for line in res["lines"]:
            log(line)
        for r in range(2):
            record_path(f"phase 24 {tag} dp=2 rank {r} training", res["launches"][r])
            record_path(f"phase 24 {tag} dp=2 rank {r} serving", res["request_launches"][r])
    check_rank_pools(S, dev, "24", {(tuple(s), "float32") for t in MESH24_CELLS
                                    for s in cells[("24", t)]["shapes"]}, 61)
    log(f"phase 25: every family at (dp, mp) = (1, 2), the GPTs split as JAX's _param_spec "
        f"splits them (ACT's style blocks too), the rest replicated over mp: the flagship "
        f"in bf16 and packed bf16, the paper with LipVQ in bf16 and its other tokenizers, "
        f"BC_Transformer_GMM, MCR_Transformer, ACT, ICLMamba_GMM in bf16 and HBC, "
        f"{MESH23_STEPS} steps and a B={MESH23_REQ_B} request a cell, each rank at the whole "
        f"global batch ({card})")
    pools = set()
    for tag in (*MESH25_CELLS, *MESH25_NESTED):
        res = cells[("25", tag)]
        for line in res["lines"]:
            log(line)
        log(f"  25 {tag}: peak reserved device memory, ranks 0 / 1: "
            f"{res['peak_gib']:.2f} / {peaks[('25', tag)]['peak_gib']:.2f} GiB")
        serving = "request_launches" if tag in MESH25_NESTED else "serve_launches"
        for r in range(2):
            record_path(f"phase 25 {tag} rank {r} training", res["launches"][r])
            record_path(f"phase 25 {tag} rank {r} serving", res[serving][r])
        pools |= res["pools"] if "pools" in res else {(tuple(x), "float32")
                                                       for x in res["shapes"]}
    check_phase6_pools("25", pools)
    check_rank_pools(S, dev, "25", pools, 62)
    log(f"  phases 21c and 22 to 25 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 24: offline RL, the hierarchical family, MCR and its pretraining
# under dp = 2
# ---------------------------------------------------------------------------

MESH24_STEPS = 2        # steps a cell (the second timed for the ratio)
MESH24_CALLS = 2        # a stepwise cell's request: calls after a reset
# the pretraining cell: scripts/train_mcr_representation.py's defaults with
# 19f's --size 50 (32 quintuples of 224 x 224 frames, lr 1e-4, seed 1)
MESH24_PRETRAIN_B = 32


def _mesh24_pretrainer(dev):
    """19f's trainer as the script builds it (ResNet-50, the recorded-argmax
    stem pool always on), its weights from the script's seed."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import (
        MCRPretrainer,
        MCRRepresentation,
    )
    from robot_manipulation_vq_vae_tpu_torch.models.base_nets import set_stem_pool

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = MCRRepresentation(size=50, action_dim=7, resize_to_224=True, state_dim=42)
    set_stem_pool(model, True)
    return MCRPretrainer(model, lr=1e-4, seed=1, device=dev)


def _mesh24_rl(name, dev):
    """18e's @name on the cameras; TD3-BC's critic-step counter at 1 (as
    18e's kernel-against-plain step takes it), so that its actor moves at
    the first step, which phase 24 holds."""
    algo = rl_algo(name, dev, images=True)
    if name == "td3_bc":
        algo.critic_steps = 1
    return algo


def _mesh24_rl_batches(algo, dev):
    import torch

    gen = torch.Generator(dev).manual_seed(56)
    return [rl_batch(gen, dev, algo, RL_B, True) for _ in range(MESH24_STEPS)]


def _mesh24_hier_batches(algo, dev):
    import torch

    gen = torch.Generator(dev).manual_seed(57)
    return [hier_batch(gen, dev, algo, True) for _ in range(MESH24_STEPS)]


def _mesh24_mcr_batches(algo, dev):
    import torch

    gen = torch.Generator(dev).manual_seed(58)
    return [algo.process_batch_for_training(make_train_batch(gen, dev, HIER_B, 1))
            for _ in range(MESH24_STEPS)]


def _mesh24_pretrain_batches(algo, dev):
    from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import synthetic_batches

    return list(synthetic_batches(MESH24_PRETRAIN_B, 224, 7, state_dim=42, seed=59,
                                  num_batches=MESH24_STEPS + 1))


# tag: (phase of the cell's unsharded path, make(dev), batches(algo, dev),
# request kind: "obs" a B = 16 get_action, "stepwise" MESH24_CALLS calls at
# B = 16 after a reset, "eval" the trainer's evaluation step on a third
# batch). Each rank pools half the unsharded rows: the steps' [50] (CQL's
# tiled actor [500], the hierarchical actors' [500]), the requests' [8],
# pretraining's [80, 64, 112, 112].
MESH24_CELLS = {
    **{cls: ("18e", lambda dev, n=name: _mesh24_rl(n, dev), _mesh24_rl_batches, "obs")
       for name, cls, _ in RL_CELLS.values()},
    "HBC": ("19d", lambda dev: hier_algo("hbc", dev, images=True), _mesh24_hier_batches,
            "stepwise"),
    "IRIS": ("19d", lambda dev: hier_algo("iris", dev, images=True), _mesh24_hier_batches,
             "stepwise"),
    "MCR_GMM": ("19e", mcr_algo, _mesh24_mcr_batches, "obs"),
    "MCR pretraining": ("19f", _mesh24_pretrainer, _mesh24_pretrain_batches, "eval"),
}
# cells whose metrics after the first step read Adam's first-step flips
# (below) past test_parallel.py's bounds: MCR pretraining's second-step TCN
# loss lay 0.39 % from unsharded, its first step's 1.4e-6, and a witness (the
# unsharded run on the ranks' shapes, ``split_rows``, with the dp step's
# arithmetic, ``OneRank``) 0.16 % (run CX). Their first step is held; the
# later steps and the evaluation are reported beside the witness's gap.
MESH24_WITNESS = ("MCR pretraining",)


def _mesh25_hier_batches(algo, dev):
    import torch

    gen = torch.Generator(dev).manual_seed(57)
    return [hier_batch(gen, dev, algo, True, b=HIER_B // 2) for _ in range(MESH24_STEPS)]


# phase 25's nested cell, in MESH24_CELLS' format: HBC at (dp, mp) = (1, 2),
# replicated over mp (no weight of it is split), at half of 24's batch
MESH25_NESTED = {
    "HBC mp=2": ("25", lambda dev: hier_algo("hbc", dev, images=True), _mesh25_hier_batches,
                 "stepwise"),
}
# the cells of phases 24 and 25 that ``mesh24_cell`` runs, by tag
NESTED_CELLS = {**MESH24_CELLS, **MESH25_NESTED}
# Adam's first step moves every element by lr times its gradient's sign,
# whatever the gradient's size, so an element whose gradient is near zero
# (SpatialSoftmax's keypoint biases, whose true gradient is 0; some trunk
# weights) steps by the sign of its rounding noise, which may go either way
# between the dp and the unsharded step: 2 lr apart, past
# test_parallel.py's 5e-4 at TD3-BC's lr 3e-4 and CQL's and BCQ's 1e-3.
# TD3-BC's actor reads the first critic as its step left it, so its
# gradient carries that critic's flips too: elements at 1.13 and 1.69 % of
# their tensor's largest first moment flipped (runs CU, CV). Phase 24 holds
# the gradients themselves (the first step's Adam moments) at
# test_parallel.py's bounds, and lets a weight element lie beyond its bound
# after the first step only by up to those 2 lr; later steps read the flips,
# so the weights after the last step are reported.


def mesh24_state(algo):
    """({part + name: tensor} of the networks of every algo @algo is made of
    (``algos_of``; the pretrainer's model), {part + optimizer: Adam
    moments by parameter index}, {part + optimizer: its parameters' names
    in that order}, {part + optimizer: its largest learning rate}), copies
    on the algo's device."""
    nets, moments, names, lrs = {}, {}, {}, {}
    for i, a in enumerate(algos_of(algo)):
        path = f"{i}."
        module = getattr(a, "model", None) or a.nets
        whole = getattr(a, "_full", lambda t: t)   # an mp algo's split weights gathered
        nets.update({path + k: whole(v).detach().clone() for k, v in module.state_dict().items()})
        name_of = {id(p): path + n for n, p in module.named_parameters()}
        for name, opt in ({"model": a.optimizer} if hasattr(a, "model")
                          else a.optimizers).items():
            params = [p for g in opt.param_groups for p in g["params"]]
            names[path + name] = [name_of[id(p)] for p in params]
            moments[path + name] = {j: {k: whole(v).detach().clone()
                                        for k, v in opt.state[p].items()
                                        if k in ("exp_avg", "exp_avg_sq")}
                                    for j, p in enumerate(params) if p in opt.state}
            lrs[path + name] = max(max(g["lr"], g.get("initial_lr", 0.0))
                                   for g in opt.param_groups)
    return nets, moments, names, lrs


def mesh24_request(algo, tag, mesh=None):
    """The cell's request after its steps, on this rank's shards under a dp
    @mesh, the generators seeded: [calls, 16, 12] of the global batch's
    actions on the host, or the evaluation step's metrics."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    kind = NESTED_CELLS[tag][3]
    cut = (lambda d: d) if mesh is None else (lambda d: shard_batch(mesh, d))
    rng = np.random.RandomState(60)
    with deterministic_steps():
        if kind == "eval":
            batch = NESTED_CELLS[tag][2](algo, None)[-1]
            return algo.update(cut(batch), eval=True)
        for a in algos_of(algo):
            a.generator.manual_seed(9)
        if kind == "obs":
            return algo.get_action(cut(request_obs(rng, MESH23_REQ_B))).float().cpu()[None]
        algo.reset()
        obs = [request_obs(rng, MESH23_REQ_B) for _ in range(MESH24_CALLS)]
        return torch.stack([algo.get_action(cut(o)).float().cpu() for o in obs])


def mesh24_steps(algo, tag, dev, mesh=None):
    """The cell's MESH24_STEPS steps (on @mesh's shards), cuDNN
    deterministic: ([metrics], [ms a step by CUDA events], ``mesh24_state``
    after the first step)."""
    import torch

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_batch

    batches = NESTED_CELLS[tag][2](algo, dev)[:MESH24_STEPS]
    metrics, times = [], []
    with deterministic_steps():
        for epoch, batch in enumerate(batches):
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if hasattr(algo, "model"):
                info = algo.update(batch)
            else:
                info = step_metrics(algo, algo.train_on_batch(batch, epoch=epoch))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            metrics.append({k: float(v) for k, v in info.items()})
            if epoch == 0:
                first = mesh24_state(algo)
    return metrics, times, first


def mesh24_run(CB, tag, dev, mesh=None, algo=None):
    """One cell from the seed's weights (@algo when given): its steps (on
    @mesh's shards), then its request, each one's launches and stem shapes
    recorded. Returns what phase 24 holds."""
    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    algo = NESTED_CELLS[tag][1](dev) if algo is None else algo
    if mesh is not None:
        shard_state(mesh, algo)
    shapes, handles = stem_inputs(getattr(algo, "model", algo))
    CB.reset_launch_counts()
    res = {}
    res["metrics"], res["ms"], first = mesh24_steps(algo, tag, dev, mesh)
    res["first"], res["moments"], res["moment_names"], res["lrs"] = first
    res["launches"], res["step_shapes"] = launched(CB), sorted(set(shapes))
    shapes.clear()
    CB.reset_launch_counts()
    res["request"] = mesh24_request(algo, tag, mesh)
    res["request_launches"], res["request_shapes"] = launched(CB), sorted(set(shapes))
    for h in handles:
        h.remove()
    res["state"] = mesh24_state(algo)[0]
    del algo
    free_card()
    if mesh is None and tag in MESH24_WITNESS:
        # the same steps and request unsharded, every convolution and linear
        # layer on the ranks' halves of its rows and the modules on a
        # ``OneRank`` axis (BatchNorm through the dp step's formula): the dp
        # step's rounding with the unsharded step's semantics
        witness = NESTED_CELLS[tag][1](dev)
        for m in witness.model.modules():
            if hasattr(type(m), "dp"):
                m.dp = OneRank()
        with split_rows():
            res["witness"], _, wfirst = mesh24_steps(witness, tag, dev)
            res["witness_request"] = mesh24_request(witness, tag)
        res["witness_moments"] = wfirst[1]
        del witness
        free_card()
    return res


def witness_gaps(got, ref, witness):
    """The largest relative gaps from the unsharded run's metrics @ref of
    @got's and of @witness's (lists of {metric: value})."""
    gaps = [0.0, 0.0]
    for g, w, x in zip(got, ref, witness):
        for k, v in w.items():
            for i, other in enumerate((g, x)):
                gaps[i] = max(gaps[i], abs(other[k] - v) / max(abs(v), 1e-30))
    return gaps


def mesh24_cell(CB, tag, dev, mesh, rank, card):
    """One cell of phase 24 on this rank: the dp = 2 run of the algo it
    built, then, on rank 0, the unsharded run from a deep copy of that algo
    taken before the mesh (the same seed's weights, with no second build),
    against which rank 0 holds the ranks (``check_mesh24_cell``) with the
    other rank's small results gathered. Returns, on rank 0, what the parent
    records: each rank's launches and the stem shapes pooled."""
    algo = NESTED_CELLS[tag][1](dev)
    twin = unsharded_copy(algo) if rank == 0 else None
    res = mesh24_run(CB, tag, dev, mesh, algo=algo)
    del algo
    res["digest"] = state_digest(res["state"])
    ranks = gather_ranks(res, ("launches", "request_launches", "step_shapes",
                               "request_shapes", "metrics", "digest", "request"))
    if rank:
        return None
    ref = mesh24_run(CB, tag, dev, algo=twin)
    del twin
    check_mesh24_cell(tag, ref, ranks, card)
    return {"launches": [r["launches"] for r in ranks],
            "request_launches": [r["request_launches"] for r in ranks],
            "shapes": sorted({s for r in ranks for s in r["step_shapes"] + r["request_shapes"]})}


def moment_gaps(got, ref):
    """{(optimizer, index, moment): ||got - ref|| / ||ref||} over two runs'
    Adam moments (``mesh24_state``'s)."""
    return {(name, i, k): float((got[name][i][k] - w).norm()) / max(float(w.norm()), 1e-30)
            for name, st in ref.items() for i, m in st.items() for k, w in m.items()}


def check_mesh24_state(tag, got, ref):
    """A cell's Adam moments (every optimizer's), weights, buffers and
    targets after its first step against the unsharded run's at
    test_parallel.py's bounds (``check_moments``, ``check_dp_state``); a
    weight element may lie beyond its bound by Adam's first step taken
    either way, 2 lr (see the comment above). A ``MESH24_WITNESS`` cell's
    moments are held per tensor: each within twice the witness's own gap
    from the unsharded run's, relative to its norm (or 1e-4). The weights
    after the last step: their largest gap, reported. Returns a summary."""
    import torch

    label = "25" if NESTED_CELLS[tag][0] == "25" else "24"
    worst = 0.0
    if "witness_moments" in ref:
        dp_gap, own = moment_gaps(got["moments"], ref["moments"]), moment_gaps(
            ref["witness_moments"], ref["moments"])
        for key, gap in dp_gap.items():
            check(gap <= max(1e-4, 2 * own[key]), f"{label} {tag}: Adam moment {key} {gap:.3g} of "
                  f"its norm from unsharded, the witness's {own[key]:.3g}")
        top = sorted(dp_gap, key=dp_gap.get, reverse=True)[:3]
        log(f"  24 {tag}: Adam moments after the first step, the largest gaps (of their "
            f"norm, dp / witness): " + ", ".join(f"{k} {dp_gap[k]:.3g} / {own[k]:.3g}"
                                                  for k in top))
    else:
        for name, want in ref["moments"].items():
            worst = max(worst, check_moments(f"{tag} {name}", got["moments"][name], want,
                                             label))
    lr_of = {param: ref["lrs"][name] for name, names in ref["moment_names"].items()
             for param in names}
    flips = {}
    for k, w in ref["first"].items():
        gap = (got["first"][k] - w).abs() if w.is_floating_point() else None
        if gap is None or not bool((gap > 5e-4 + 1e-2 * w.abs()).any()):
            continue
        check(k in lr_of, f"{label} {tag}: {k} beyond test_parallel.py's bound, no optimizer's")
        check(float(gap.max()) <= 2.02 * lr_of[k], f"{label} {tag}: {k} {float(gap.max())} from "
              f"unsharded after the first step, past Adam's 2 lr {2 * lr_of[k]:g}")
        flips[k] = (int((gap > 5e-4 + 1e-2 * w.abs()).sum()), float(gap.max()))
    summary = check_dp_state(tag, got["first"], ref["first"], "after the first step",
                             phase=label, exempt=tuple(flips))
    last = max((float((got["state"][k].float() - w.float()).abs().max())
                for k, w in ref["state"].items() if w.numel()), default=0.0)
    sizes = sum(int(torch.as_tensor(v).numel()) for k, v in ref["first"].items() if k in flips)
    return (f"{summary}; Adam moments after the first step max|diff| {worst:.3g} over "
            f"{len(ref['moments'])} optimizers; first steps taken either way (elements, "
            f"max|diff|): {flips or 'none'} ({sum(n for n, _ in flips.values())} of {sizes}); "
            f"after the last step, reported: weights max|diff| {last:.3g}")


def log_mesh24_header(card):
    log(f"phase 24: offline RL (IQL, TD3-BC, CQL, BCQ on cameras), HBC, IRIS, MCR_GMM and "
        f"MCR pretraining at dp = 2, {MESH24_STEPS} steps and a request a cell ({card})")


def check_mesh24_cell(tag, ref, ranks, card):
    """A phase 24 cell on rank 0, against the unsharded run's steps and
    request from the seed's weights: each rank's stem-pool launches those of
    the unsharded run on half the rows (its stems at half the leading dim),
    the metrics of every step, and the states and Adam moments after the
    first, within test_parallel.py's bounds (``check_mesh24_state``), the
    request within 1e-3, the ranks equal to the bit; the dp = 2 / unsharded
    ratio of the second step. @ranks: rank 0's results whole, the other's
    small ones (``gather_ranks``)."""
    phase = NESTED_CELLS[tag][0]
    mesh_name, rows = ("mp=2", 1) if phase == "25" else ("dp=2", 2)
    label = "25" if phase == "25" else "24"
    got = ranks[0]
    for kernel in ("stem_pool_fwd", "stem_pool_bwd"):
        check(ref["launches"].get(kernel, 0) > 0,
              f"{label} {tag}: the unsharded steps launched {ref['launches']}")
    for r, res in enumerate(ranks):
        for what in ("launches", "request_launches"):
            check(res[what] == ref[what], f"{label} {tag} rank {r}: {what} {res[what]}, "
                  f"unsharded {ref[what]}")
        for what in ("step_shapes", "request_shapes"):
            mine = sorted({(n // rows, *rest) for n, *rest in ref[what]})
            check(res[what] == mine, f"{label} {tag} rank {r}: {what} {res[what]}, "
                  f"unsharded {ref[what]}")
        check(res["metrics"] == got["metrics"] and res["digest"] == got["digest"],
              f"{label} {tag}: the ranks differ")
    if tag in MESH24_WITNESS:
        check_dp_metrics(tag, got["metrics"][:1], ref["metrics"][:1], label)
        dp_gap, own = witness_gaps(got["metrics"][1:] + [got["request"]],
                                   ref["metrics"][1:] + [ref["request"]],
                                   ref["witness"][1:] + [ref["witness_request"]])
        log(f"  24 {tag}: after the first step (and its evaluation), reported: the "
            f"metrics' largest relative gap {dp_gap:.3g} from unsharded, the witness's "
            f"{own:.3g}")
    else:
        check_dp_metrics(tag, got["metrics"], ref["metrics"], label)
    summary = check_mesh24_state(tag, got, ref)
    if isinstance(ref["request"], dict):
        check(all(r["request"] == got["request"] for r in ranks),
              f"{label} {tag}: the ranks' evaluations differ")
        gaps = [max(abs(r["request"][k] - v) for k, v in ref["request"].items())
                for r in ranks]
    else:
        gaps = [float((r["request"] - ref["request"]).abs().max()) for r in ranks]
        for r, gap in enumerate(gaps):
            check(gap <= 1e-3, f"{label} {tag} rank {r}: the request is {gap} from unsharded")
    log(f"  {phase} {tag}: {summary}; request max|diff| "
        f"{', '.join(f'{g:.3g}' for g in gaps)} (ranks 0, 1; bound 1e-3); launches a rank "
        f"{got['launches']} over {MESH24_STEPS} steps (unsharded {ref['launches']}), "
        f"{got['request_launches']} a request; stems a rank {got['step_shapes']} "
        f"(unsharded {ref['step_shapes']}); ms a step (CUDA events) {mesh_name} rank 0 "
        f"{', '.join(f'{t:.3f}' for t in got['ms'])}, unsharded "
        f"{', '.join(f'{t:.3f}' for t in ref['ms'])}; {mesh_name} / unsharded "
        f"{got['ms'][-1] / ref['ms'][-1]:.3f} ({card})")


def device_profile(tag, fn, share=()):
    """Device time by kernel for one call of @fn (torch.profiler): busy time,
    idle share of the wall time, the top kernels, and the share of the busy
    time of kernels whose names contain one of @share. Returns the busy
    time (ms)."""
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
    return busy


T_START = time.perf_counter()   # the script's start, for main's marks


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print device-time breakdowns of get_action, "
                             "of one training step, of one rollout lockstep and "
                             "of one diffusion-policy request")
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
    t_last = [T_START]

    def mark(what):
        """Log the seconds since the previous mark (the script's start) and
        since the start."""
        now = time.perf_counter()
        log(f"  [{what}: {now - t_last[0]:.1f} s; {now - T_START:.1f} s since the start]")
        t_last[0] = now

    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    seconds = CB.build_kernels()
    log(f"phase 2: kernels built in {seconds:.2f} s")
    for src in sorted({k[0] for k in CB.KERNELS.values()}):
        for line in CB.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    assign = phase_assign(K, dev)
    phase_assign_backward(K, dev)
    mark("phases 1-3b")
    tok_model = tokenizer_model(dev)
    x = torch.randn(TOKENIZER_CHUNKS, 12, generator=torch.Generator(dev).manual_seed(7),
                    device=dev)
    roundtrip = phase_roundtrip(K, dev, tok_model, x)
    tok_counts = phase_tokenizer_path(CB, tok_model, x)
    del tok_model, x
    mark("phases 4-5")
    pool = phase_stem_pool(S, dev)
    mcr_pool = phase_mcr_pool(S, dev)
    mcr_rank_pool = phase_mcr_pool(S, dev, MCR_RANK_POOL)
    pool_bf16, bf16_step_pool = phase_stem_pool_bf16(S, dev)
    pool.update(pool_bf16)
    mark("phases 6-6b")
    torch.cuda.empty_cache()
    route, route_counts = phase_pool_route(CB, P, dev)
    mark("phase 6c")
    torch.cuda.empty_cache()
    pol_counts, paper_request_ms = phase_policy_path(CB, dev, args.profile)
    mark("phase 7")
    torch.cuda.empty_cache()
    train_counts, paper_step_ms = phase_training_path(CB, dev, args.profile)
    mark("phase 8")
    torch.cuda.empty_cache()
    phase_flagship_serving(CB, dev, args.profile)
    mark("phase 9")
    torch.cuda.empty_cache()
    flagship = {mp: phase_flagship_training(CB, dev, mp, args.profile)
                for mp in (False, True)}
    mark("phase 10")
    torch.cuda.empty_cache()
    epoch_counts, trained, ckpt = phase_epoch(CB, dev, flagship[True][1])
    mark("phase 11")
    torch.cuda.empty_cache()
    phase_rollout_paper(CB, dev, paper_request_ms[BATCHES[-1]], args.profile)
    torch.cuda.empty_cache()
    phase_rollout_checkpoint(CB, dev, trained, ckpt)
    mark("phase 12")
    del trained, ckpt
    torch.cuda.empty_cache()
    phase_modalities(CB, dev, paper_step_ms, paper_request_ms, args.profile)
    mark("phase 13")
    torch.cuda.empty_cache()
    assign_bf16 = phase_assign_bf16(K, dev)
    bf16_counts, _ = phase_paper_bf16(CB, dev, paper_step_ms)
    phase_flagship_packed(CB, dev, flagship[True][1])
    phase_flagship_modes(CB, dev, flagship[True][1])
    mark("phase 14")
    free_card()
    mamba_steps = phase_family(CB, dev, card, paper_step_ms, args.profile)
    mark("phase 15")
    free_card()
    row_3g, film_steps = phase_cores(CB, S, dev, card, paper_step_ms, args.profile)
    mark("phase 16")
    free_card()
    baselines = phase_baselines(CB, dev, card, args.profile)
    mark("phase 17")
    free_card()
    phase_offline_rl(CB, dev, card, args.profile)
    mark("phase 18")
    free_card()
    phase_hierarchical(CB, dev, card, args.profile)
    mark("phase 19")
    free_card()
    phase_bf16(CB, dev, card, {"15c": mamba_steps["ICLMamba_GMM LipVQ"], "16": film_steps,
                               "17c": baselines["DiffusionPolicyUNet (DDPM)"][0]},
               args.profile)
    mark("phase 20")
    free_card()
    zoo_kernel, dp1_ms = phase_zoo_and_mesh(CB, K, dev, card)
    mark("phase 21")
    free_card()
    phase_mesh_cells(CB, S, dev, card, dp1_ms)
    mark("phases 21c-25")

    # the assign kernel's row: the B = 16 request's shape, N = 16 x 16 rows
    main_assign = assign[(ASSIGN_DS[0], BATCHES[-1] * 16)]
    kernels = [
        # zoo_shapes: kernel 1 at the tokenizer zoo's (N, D, K) (phase 21a)
        dict(name="lipvq_assign", route="cuda", source=f"{SOURCE}/lipvq_assign.cu",
             replaces=f"{TPU_KERNELS}:39", launches=pol_counts["lipvq_assign"],
             library_ms=None, **main_assign, zoo_shapes=zoo_kernel),
        dict(name="lipvq_roundtrip", route="cuda",
             source=f"{SOURCE}/lipvq_roundtrip.cu", replaces=f"{TPU_KERNELS}:142",
             launches=tok_counts["lipvq_roundtrip"], library_ms=None, **roundtrip),
        # kernel 1's bf16 instance at the paper's bf16 step (phase 14b); at
        # ICLMamba_GMM's bf16 step's N = 320 (phase 20a) under mamba_n320
        dict(name="lipvq_assign_bf16", route="cuda", source=f"{SOURCE}/lipvq_assign.cu",
             replaces=f"{TPU_KERNELS}:39", launches=bf16_counts["lipvq_assign_bf16"],
             library_ms=None, **assign_bf16[PAPER_ASSIGN_N],
             mamba_n320=dict(assign_bf16[320], library_ms=None, launches=PATH_LAUNCHES[
                 "phase 20a ICLMamba_GMM bf16 training"]["lipvq_assign_bf16"])),
        # band_path: the launcher's band kernel at each of R3M's stem shapes
        # (phase 16c's requests and training step), with its device time
        # alone and F.max_pool2d's
        dict(name="stem_pool_fwd", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:60", launches=train_counts["stem_pool_fwd"],
             **pool["stem_pool_fwd"], band_path=row_3g),
        dict(name="stem_pool_bwd", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:113", launches=train_counts["stem_pool_bwd"],
             **pool["stem_pool_bwd"]),
        # the bf16 instances: launches on the flagship's bf16 epoch from disk
        dict(name="stem_pool_fwd_bf16", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:60", launches=epoch_counts["stem_pool_fwd_bf16"],
             **pool["stem_pool_fwd_bf16"]),
        dict(name="stem_pool_bwd_bf16", route="cuda", source=f"{SOURCE}/stem_pool.cu",
             replaces=f"{TPU_POOL}:113", launches=epoch_counts["stem_pool_bwd_bf16"],
             **pool["stem_pool_bwd_bf16"]),
        # kernel 5: launches on its op's path (max_pool_3x3_s2's backward)
        *(dict(name=name, route="cuda", source=f"{SOURCE}/pool_route.cu",
               replaces=f"{TPU_ROUTE}:50", launches=route_counts[name], **route[name])
          for name in ("pool_route", "pool_route_bf16")),
    ]
    # the bf16 stem pool at phase 20's shapes (phase 6b's timing, by device
    # time too)
    for row in kernels:
        if row["name"] in bf16_step_pool:
            row["bf16_step_shapes"] = bf16_step_pool[row["name"]]
    # rows 3h / 4g: kernels 3 and 4 at MCR pretraining's stem (phase 6's
    # timing), with their launches on phase 19f's path
    for row in kernels:
        if row["name"] not in mcr_pool:
            continue
        row["mcr_stem"] = dict(mcr_pool[row["name"]], shape=list(MCR_POOL),
                               launches=PATH_LAUNCHES["phase 19f MCR pretraining"][row["name"]])
        # a dp = 2 rank's half (phase 24), with its launches on rank 0's path
        row["mcr_stem_dp2_rank"] = dict(
            mcr_rank_pool[row["name"]], shape=list(MCR_RANK_POOL),
            launches=PATH_LAUNCHES["phase 24 MCR pretraining dp=2 rank 0 training"][row["name"]])
    # each kernel's launches on every path that ran it
    for row in kernels:
        row["launches_by_path"] = {path: c[row["name"]] for path, c in PATH_LAUNCHES.items()
                                   if c.get(row["name"])}
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
