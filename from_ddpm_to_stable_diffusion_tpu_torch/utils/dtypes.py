"""Mixed-precision policies and the inference cast (port of
``utils/dtypes.py``)."""

from __future__ import annotations

import dataclasses
import re

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype     # dtype parameters are stored in
    compute_dtype: torch.dtype   # dtype activations and matmuls run in
    name: str = ""


POLICIES = {
    "fp32": DTypePolicy(torch.float32, torch.float32, "fp32"),
    "bf16": DTypePolicy(torch.float32, torch.bfloat16, "bf16"),
    "full_bf16": DTypePolicy(torch.bfloat16, torch.bfloat16, "full_bf16"),
}

_NORM_PATH = re.compile(r"(^|_)(norm|ln)($|_|\d)|groupnorm|layernorm|rms",
                        re.IGNORECASE)


def cast_params_for_inference(module: nn.Module,
                              dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Store conv and linear weights and biases (and embeddings) in the
    compute dtype, in place; parameters of norm layers (a path component
    matching norm/ln) stay fp32, since they feed fp32 statistics. An int8
    projection (``QuantLinear``) keeps its int8 weight and fp32 scale and
    computes in ``dtype``, as its bias is then stored."""
    from ..ops.quantize import QuantLinear

    for m in module.modules():
        if isinstance(m, QuantLinear):
            m.compute_dtype = dtype
    for name, p in module.named_parameters():
        if not p.is_floating_point():
            continue
        norm = any(_NORM_PATH.search(part) for part in name.split("."))
        if p.dim() >= 2 or (p.dim() == 1 and not norm):
            p.data = p.data.to(dtype)
    return module
