"""robot_manipulation_vq_vae_tpu_torch: the PyTorch / CUDA port of
``robot_manipulation_vq_vae_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports neither JAX
nor anything of that package. Its layout mirrors the reference's
(``config/``, ``ops/``, ``models/``, ``models/tokenizers/``, ``algo/``,
``utils/``) so each module's counterpart is easy to find. The hand-written
CUDA kernels live under ``csrc/`` and are built with ``nvcc`` at first use
(``ops/cuda_build.py``); their wrappers and plain versions are in
``ops/lipvq_kernel.py``, ``ops/stem_pool.py`` and ``ops/pool.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit ``cpu`` they raise.

Importing the package does not import torch: the environment workers of
``envs/vector_env.py`` start by ``spawn`` and import only numpy modules.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless @device says
    otherwise. Raises when no card is present and no device was given."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
