"""``train.mixed_precision`` as the JAX package's steps compute it.

The JAX steps cast the policy's fp32 parameters, its auxiliary state and its
floating inputs to bf16 and apply the Flax modules to those copies; which
layer then computes in bf16 is decided by JAX's type promotion: a Dense or a
convolution computes in the promoted type of its input and its (bf16)
parameters, so a layer whose input is fp32 computes in fp32. ``half_call``
does the same: it calls a module on bf16 copies of its parameters (through
``torch.func.functional_call``, so the gradients reach the fp32 parameters,
rounded to bf16 by the casts as JAX's are) and of its floating inputs, under
``JaxPromotion``, which gives the ops that torch does not promote (linear,
the matrix products, convolution, LayerNorm) their operands in the promoted
type. Elementwise ops, ``cat`` and ``stack`` promote in torch already.

The modules keep their buffers fp32; where the JAX step would carry a bf16
copy of one (BatchNorm's statistics, the bin tokenizer's running range, the
spectral-norm vectors), the module rounds it through the type of its input.
Where a JAX layer asks for an fp32 result of a bf16 product
(``preferred_element_type=float32``: the GPT's attention products, the
LipVQ latent layer), the port's layer lifts its operands with
``at_least_f32``.
"""

import torch
from torch.overrides import TorchFunctionMode

HALF = torch.bfloat16

# the functions whose floating operands JaxPromotion brings to one type
_PROMOTED = frozenset({"linear", "conv1d", "conv2d", "layer_norm", "matmul",
                       "__matmul__", "__rmatmul__", "mm", "bmm", "einsum"})


def at_least_f32(t):
    """@t in fp32 if it is of a narrower floating type, else unchanged."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _floating(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _map_floating(fn, tree):
    if _floating(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_floating(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floating(fn, v) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


class JaxPromotion(TorchFunctionMode):
    """Gives a linear, matrix product, convolution or LayerNorm all its
    floating operands in their promoted type, as JAX's ``dot_general`` /
    ``conv`` / Flax's LayerNorm see them: bf16 with bf16 stays bf16, bf16
    with fp32 becomes fp32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in _PROMOTED:
            dtypes = {t.dtype for t in _leaves((args, kwargs)) if _floating(t)}
            if len(dtypes) > 1:
                dtype = dtypes.pop()
                for d in dtypes:
                    dtype = torch.promote_types(dtype, d)
                args, kwargs = _map_floating(lambda t: t.to(dtype), (args, kwargs))
        return func(*args, **kwargs)


def half_call(module, args=(), kwargs=None):
    """``module(*args, **kwargs)`` on bf16 copies of @module's parameters and
    of the floating tensors among the arguments, under ``JaxPromotion``."""
    params = {name: p.to(HALF) for name, p in module.named_parameters()}
    args, kwargs = _map_floating(lambda t: t.to(HALF), (tuple(args), kwargs or {}))
    with JaxPromotion():
        return torch.func.functional_call(module, params, args, kwargs)


def full(tree):
    """bf16 -> fp32 over the tensors of @tree (and of a dataclass's fields)."""
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{k: full(getattr(tree, k)) for k in tree.__dataclass_fields__})
    return _map_floating(lambda t: t.float() if t.dtype == HALF else t, tree)
