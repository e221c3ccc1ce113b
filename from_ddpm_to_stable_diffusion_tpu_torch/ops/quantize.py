"""Int8 (W8A8) projections for serving (port of ``ops/quantize.py``).

Weights: symmetric int8 with one fp32 scale per output channel,
``scale = max(amax, 1e-8) / 127`` and ``q = round(w / scale)`` (half to
even, as ``jnp.round``). Activations: per-token dynamic scales, each row of
x over its own abs-max / 127, and ``xq = round(x / xs)``. The JAX package
runs these under ``jax.jit`` (``quantize_int8``, the int8 forwards), where
XLA turns the division by the constant 127 into a product with its fp32
reciprocal; the port computes that form, and divides by the scales
themselves as JAX does, so that ``q``, ``scale``, ``xq`` and ``xs`` equal the
JAX serving path's bit for bit on the same inputs. int8 x int8 accumulates
in int32, then ``(acc * xs) * scale`` in fp32, cast to the input's dtype,
then the bias (``QuantDense``'s order).

The product is a library call here, as ``jax.lax.dot_general(...,
preferred_element_type=int32)`` is XLA's work and no Pallas kernel in the
JAX package: on CUDA tensors ``torch._int_mm`` (cuBLASLt), which wants more
than 16 rows and K, N multiples of 8. Fewer rows are padded with zero rows;
any other shape it cannot take raises, never falling back to a float
product. On the CPU the product is exact in fp64 (|acc| <= K * 127^2, far
below 2^53) and returned as int32. The quantization and the dequantization
stay eager elementwise PyTorch, as they are XLA elementwise ops in JAX.

Convs are not quantized, nor anything :data:`DEFAULT_TARGETS` misses
(adaLN, embedders, final layers, CLIP towers unless asked for).
"""

from __future__ import annotations

import re
from typing import Optional, Pattern

import torch
import torch.nn.functional as F
from torch import nn

# the JAX package's regex, verbatim: matched against the Flax path of each
# 2-D kernel. "/proj" and "/out", not bare substrings: SD1ResBlock's
# time_proj stays in its dtype, and a bare "out" would match "router".
DEFAULT_TARGETS = re.compile(
    r"(qkv|/proj|/out|geglu_in|geglu_out|mlp_fc1|mlp_fc2|wi_0|wi_1|wo"
    r"|/q|/k|/v|/o)/kernel$")

# 1 / 127 rounded to fp32: XLA's form of "/ 127.0" under jit
RECIP_127 = 1.0 / 127.0

# torch._int_mm's shape rules (aten/src/ATen/native/cuda/Blas.cpp)
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def quantize_per_channel(w: torch.Tensor, axis: int = 0):
    """Symmetric int8 per-output-channel quantization of a 2-D weight.
    ``axis`` is the contraction axis (0 for a Flax (K, N) kernel, 1 for a
    PyTorch (N, K) weight). Returns (q int8 of w's shape, scale fp32 (N,))."""
    w = w.float()
    amax = w.abs().amax(dim=axis)
    scale = amax.clamp(min=1e-8) * RECIP_127
    q = torch.round(w / scale.unsqueeze(axis)).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """Per-token dynamic quantization of x (..., K): (xq int8, xs fp32
    (..., 1)); |x / xs| <= 127, so the rounding never leaves int8."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) * RECIP_127
    return torch.round(xf / xs).to(torch.int8), xs


def _column_major(q: torch.Tensor) -> torch.Tensor:
    """q (K, N) as the transpose of a contiguous (N, K) tensor, the layout
    cuBLASLt's int8 product reads without a copy."""
    if q.stride() == (1, q.shape[0]):
        return q
    return q.t().contiguous().t()


def int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact. On the card
    ``torch._int_mm`` (rows padded to 17 when fewer; K or N off a multiple
    of 8 raises ValueError); on the CPU an fp64 product."""
    if xq.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError("int8_matmul takes int8 operands")
    m, k = xq.shape
    if q.shape[0] != k:
        raise ValueError(f"inner dims differ: {tuple(xq.shape)} x "
                         f"{tuple(q.shape)}")
    n = q.shape[1]
    if not xq.is_cuda:
        return (xq.double() @ q.double()).to(torch.int32)
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(f"torch._int_mm needs K and N multiples of "
                         f"{INT_MM_MULTIPLE}, got K={k}, N={n}")
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    int8_matmul.launches += 1
    return torch._int_mm(xq.contiguous(), _column_major(q))[:m]


# calls of torch._int_mm, counted where it is called (chip_smoke.py reads
# it to show that the int8 paths took it)
int8_matmul.launches = 0


def int8_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """x (..., K) float against q (K, N) int8 with per-channel ``scale``
    (N,): per-token int8 activations, int32 accumulation, then
    ``(acc * xs) * scale`` in fp32 cast to x's dtype."""
    xq, xs = quantize_rows(x)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), q)
    acc = acc.reshape(*x.shape[:-1], q.shape[1])
    return (acc.float() * xs * scale).to(x.dtype)


class QuantLinear(nn.Module):
    """The counterpart of ``QuantDense``: an int8 weight ``q`` (N, K) (the
    product reads its transpose column-major) with an fp32 per-channel
    ``scale`` (N,), both buffers, and a bias parameter. ``compute_dtype``
    is the dtype x is cast to first (the replaced layer's: its weight's
    dtype or its own ``compute_dtype``); :func:`..utils.dtypes.
    cast_params_for_inference` sets it with the bias's dtype. The
    constructor takes :class:`..models.layers.Linear`'s arguments."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype or torch.float32
        self.register_buffer("q", torch.zeros(out_features, in_features,
                                              dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        """Quantize ``linear``'s weight on its device; the fp32 copy lives
        only while this one weight is converted."""
        w = linear.weight.detach()
        dtype = getattr(linear, "compute_dtype", None) or w.dtype
        with torch.device("meta"):
            out = cls(linear.in_features, linear.out_features,
                      bias=linear.bias is not None, compute_dtype=dtype)
        q, scale = quantize_per_channel(w, axis=1)
        out.q, out.scale = q, scale
        if linear.bias is not None:
            out.bias = nn.Parameter(linear.bias.detach(),
                                    requires_grad=False)
        return out

    def forward(self, x):
        y = int8_dot(x.to(self.compute_dtype), self.q.t(), self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}, "
                f"compute_dtype={self.compute_dtype}")


def dense_cls(int8_mm: bool):
    """:class:`..models.layers.Linear`, or :class:`QuantLinear` for the
    W8A8 serving path."""
    from ..models.layers import Linear

    return QuantLinear if int8_mm else Linear


def flax_kernel_path(name: str) -> str:
    """The Flax path of a port linear's kernel: the module's dotted name
    with ``/`` for ``.`` and ``/kernel`` at the end."""
    return name.replace(".", "/") + "/kernel"


@torch.no_grad()
def quantize_module(module: nn.Module,
                    targets: Optional[Pattern] = None) -> list:
    """Replace, in place and one at a time, every ``nn.Linear`` of
    ``module`` whose Flax kernel path matches ``targets`` (default
    :data:`DEFAULT_TARGETS`) by a :class:`QuantLinear` on the same device;
    each float weight is dropped before the next is converted. Returns the
    dotted names converted."""
    targets = targets or DEFAULT_TARGETS
    names = [name for name, m in module.named_modules()
             if isinstance(m, nn.Linear) and targets.search(
                 flax_kernel_path(name))]
    for name in names:
        parent_name, _, leaf = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        setattr(parent, leaf, QuantLinear.from_linear(getattr(parent, leaf)))
    return names
