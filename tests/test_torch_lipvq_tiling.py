"""The LipVQ assign core's tiling, emulated in numpy on the CPU.

The CUDA tile product (``csrc/lipvq_assign_core.cuh``) gives thread
(tx, ty) of a block the codes ``k0 + 64 h + 4 tx + j`` (h < width / 64,
j < 4) of each code tile, visited in ascending order with a strict ``<``;
the 16 partial minima of a row are merged lexicographically on (value,
index), and ``merge_kernel`` merges the codebook splits the same way in
ascending order. These tests replay that order on exact distances and hold
it against the port's plain version and the JAX package (``jnp.argmin`` and
the Pallas assign kernel in interpret mode), and check the shared-memory
swizzle's bank arithmetic. The kernel itself is held against its plain
version on the card by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_manipulation_vq_vae_tpu.ops import quantize as Q
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas

from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _thread_codes(k0, width, tx):
    """The codes of tile @k0 that thread @tx holds, in its visiting order."""
    return [k0 + 64 * h + 4 * tx + j for h in range(width // 64) for j in range(4)]


def _emulate_assign(dist, width, splits, per_split):
    """The kernel's argmin of each row of @dist [N, K]: per thread a running
    minimum replaced on a strict `<`, the 16 threads merged on (value,
    index), then the splits merged on (value, index) in ascending order."""
    n, k = dist.shape
    out_v = np.full(n, np.inf, np.float32)
    out_i = np.zeros(n, np.int64)
    for s in range(splits):
        k_begin, k_end = s * per_split, min(k, (s + 1) * per_split)
        best_v = np.full((16, n), np.inf, np.float32)
        best_i = np.zeros((16, n), np.int64)
        for k0 in range(k_begin, k_end, width):
            for tx in range(16):
                for code in _thread_codes(k0, width, tx):
                    if code >= k_end:
                        continue
                    better = dist[:, code] < best_v[tx]
                    best_v[tx][better] = dist[better, code]
                    best_i[tx][better] = code
        split_v, split_i = best_v[0].copy(), best_i[0].copy()
        for tx in range(1, 16):
            take = (best_v[tx] < split_v) | ((best_v[tx] == split_v) & (best_i[tx] < split_i))
            split_v[take], split_i[take] = best_v[tx][take], best_i[tx][take]
        if s == 0:
            out_v, out_i = split_v, split_i
        else:
            take = (split_v < out_v) | ((split_v == out_v) & (split_i < out_i))
            out_v[take], out_i[take] = split_v[take], split_i[take]
    return out_i


def _exact_inputs(rng, n, k, d):
    """Small integers: every distance is exact in fp32 in any order."""
    return (rng.randint(-3, 4, (n, d)).astype(np.float32),
            rng.randint(-3, 4, (k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,sms", [(16, 1024, 132), (512, 1024, 132),
                                     (65536, 1024, 132), (4224, 1024, 132),
                                     (300, 1030, 132), (20000, 100, 132),
                                     (200, 256, 2), (64, 1030, 3)])
def test_tiling_visits_every_code_once_in_ascending_order(n, k, sms):
    width, splits, per_split = K._assign_splits(n, k, sms)
    assert width in (64, 128) and per_split % width == 0
    assert (splits - 1) * per_split < k <= splits * per_split
    seen = []
    for s in range(splits):
        k_end = min(k, (s + 1) * per_split)
        for k0 in range(s * per_split, k_end, width):
            for tx in range(16):
                codes = [c for c in _thread_codes(k0, width, tx) if c < k_end]
                assert codes == sorted(codes)
                seen += codes
    assert sorted(seen) == list(range(k))


# (N, K, SM count) -> the plan's (width, splits): (64, 4), (128, 2), (64, 1),
# (128, 1); code k repeats at k + period, k + 2 period, ...
@pytest.mark.parametrize("n,k,sms", [(100, 256, 132), (200, 256, 3),
                                     (70, 64, 132), (300, 200, 1)])
@pytest.mark.parametrize("period", [2, 5, 64])
def test_emulated_tie_and_merge_order_keeps_the_first_index(n, k, sms, period):
    """Exact ties inside one thread's columns (k, k + 2; k, k + 64 at width
    128), across threads, code tiles and splits: the emulated kernel order
    picks the first index, as the plain version, jnp.argmin and the Pallas
    kernel do."""
    rng = np.random.RandomState(period)
    z, base = _exact_inputs(rng, n, period, 24)
    cb = np.tile(base, (-(-k // period), 1))[:k]
    dist = ((cb.astype(np.float64) ** 2).sum(1)[None]
            - 2.0 * z.astype(np.float64) @ cb.T.astype(np.float64)).astype(np.float32)
    idx_e = _emulate_assign(dist, *K._assign_splits(n, k, sms))
    idx_p, zq_p = K.l2_nearest_plain(torch.from_numpy(z), torch.from_numpy(cb))
    idx_x, _ = Q.l2_nearest(jnp.asarray(z), jnp.asarray(cb))
    idx_pl, _ = l2_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), 64, True)
    assert idx_e.max() < period
    np.testing.assert_array_equal(idx_e, idx_p.numpy())
    np.testing.assert_array_equal(idx_e, np.asarray(idx_x))
    np.testing.assert_array_equal(idx_e, np.asarray(idx_pl))
    np.testing.assert_array_equal(zq_p.numpy(), cb[idx_e])


def _swz(k):
    return ((k >> 2) & 3) << 3


def _banks(addresses):
    """Shared-memory wavefronts of one warp's 4-byte stores: the most
    distinct addresses that fall in one of the 32 banks."""
    per_bank = {}
    for a in set(addresses):
        per_bank.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("width", [64, 128])
def test_swizzle_spreads_transposing_stores_and_keeps_float4_groups(width):
    """A warp's transposing stores (8 rows x 4 depth quads, element (k, m) at
    k * width + (m ^ swz(k))) hit every bank once; the depth-major stores of
    the gather and of x (32 rows of one depth) too; and the 4 columns that a
    thread reads with one 16-byte load stay contiguous and aligned."""
    for warp in range(width * 4 // 32):
        for i in range(4):
            addrs = []
            for lane in range(32):
                e = 32 * warp + lane
                m, q = e >> 2, e & 3
                k = 4 * q + i
                addrs.append(k * width + (m ^ _swz(k)))
            assert _banks(addrs) == 1
    for k in range(32):
        for half in range(2):
            assert _banks([k * 64 + ((32 * half + lane) ^ _swz(k)) for lane in range(32)]) == 1
    for k in range(16):
        for col in range(0, width, 4):
            phys = [(col + j) ^ _swz(k) for j in range(4)]
            assert phys[0] % 4 == 0 and phys == list(range(phys[0], phys[0] + 4))
            assert phys[0] // 64 == col // 64
