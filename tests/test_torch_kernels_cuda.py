"""The port's two CUDA kernels against their plain PyTorch versions on the
card (``cuda`` marker: they skip where there is none), and the wrappers'
device rule. This file imports neither JAX nor the JAX package, so that it
runs on a machine with only PyTorch:

    RMVQ_TESTS_ON_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py

(the variable keeps the repository's conftest from importing JAX)."""

import pytest
import torch

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K


@pytest.fixture
def cuda_device():
    """The card; decided at run time, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _near_code_inputs(n, k, d, device):
    """Rows near random codes: far from every Voronoi boundary."""
    gen = torch.Generator().manual_seed(5)
    cb = torch.randn(k, d, generator=gen)
    z = cb[torch.randint(0, k, (n,), generator=gen)] + 0.1 * torch.randn(n, d, generator=gen)
    return z.to(device), cb.to(device)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    z, cb = _near_code_inputs(20, 32, 8, "cpu")
    before = dict(K.LAUNCHES)
    idx, zq = K.l2_nearest_cuda(z, cb)
    idx_p, zq_p = K.l2_nearest_plain(z, cb)
    assert K.LAUNCHES == before
    assert idx.dtype == torch.int32
    torch.testing.assert_close(idx, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(zq, zq_p, rtol=0, atol=0)


@pytest.mark.cuda
# the codebook is split over 16, 16, 16, 4 and 1 block ranges on an H100
@pytest.mark.parametrize("n,d", [(16, 976), (300, 210), (65, 37), (4096, 37),
                                 (16896, 37)])
def test_assign_kernel_matches_plain(cuda_device, n, d):
    z, cb = _near_code_inputs(n, 1024, d, cuda_device)
    before = K.LAUNCHES["lipvq_assign"]
    idx_k, zq_k = K.l2_nearest_cuda(z, cb)
    torch.cuda.synchronize()
    assert K.LAUNCHES["lipvq_assign"] == before + 1
    idx_p, _ = K.l2_nearest_plain(z, cb)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(zq_k, cb[idx_k.long()], rtol=0, atol=0)


@pytest.mark.cuda
def test_assign_kernel_keeps_the_first_index_on_a_tie(cuda_device):
    z, base = _near_code_inputs(100, 64, 48, cuda_device)
    cb = torch.cat([base, base, base])  # codes k, k + 64, k + 128 tie exactly
    idx, _ = K.l2_nearest_cuda(z, cb)
    idx_p, _ = K.l2_nearest_plain(z, cb)
    assert int(idx.max()) < 64
    torch.testing.assert_close(idx, idx_p, rtol=0, atol=0)


@pytest.mark.cuda
def test_roundtrip_kernel_matches_plain(cuda_device):
    gen = torch.Generator().manual_seed(1)
    model = LipVQVAE(12, 210, num_codes=1024)
    x = torch.randn(1000, 12, generator=gen).to(cuda_device)
    model.to(cuda_device)
    before = K.LAUNCHES["lipvq_roundtrip"]
    with torch.no_grad():
        rec_k, idx_k = model.roundtrip_fused(x)
        rec_p, idx_p = K.lipvq_roundtrip_plain(x, **model.fused_weights())
    assert K.LAUNCHES["lipvq_roundtrip"] == before + 1
    same = idx_k == idx_p
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(rec_k[same], rec_p[same], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kernel_path_refuses_gradients_and_bad_inputs(cuda_device):
    cb = torch.randn(64, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        K.l2_nearest_cuda(torch.randn(8, 16, device=cuda_device), cb)
    with pytest.raises(TypeError):
        K.l2_nearest_cuda(torch.randn(8, 16, device=cuda_device).double(),
                          cb.detach().double())
    with pytest.raises(ValueError):
        K.l2_nearest_cuda(torch.randn(8, 15, device=cuda_device), cb.detach())
