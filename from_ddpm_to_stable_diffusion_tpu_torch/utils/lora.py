"""LoRA: low-rank adapters over a frozen module (port of ``utils/lora.py``).

The adapter set is a flat dict keyed by the Flax path of each adapted
kernel (``ops/quantize.py::flax_kernel_path``: the port names its
submodules after the Flax parameter paths), and each adapter is kept in the
Flax layout: a kernel of Flax shape s gets A: s[:-1] + (r,) and B: (r, s[-1]),
ΔW = tensordot(A, B). So a JAX adapter dict carries across one to one
(:func:`lora_from_jax`, :func:`jax_lora_from_port`).

:func:`merge_lora` returns the parameters to call the module with
(``torch.func.functional_call``): W + (scale/r)·ΔW for each adapted weight,
ΔW turned into the torch layout (a Dense kernel (in, out) transposed, a conv
kernel (kh, kw, in, out) permuted to (out, in, kh, kw), as
``io/from_jax.py::state_dict_from_jax`` turns kernels). Inside the loss,
autograd routes the gradient to A and B only while the base weights are
frozen. B starts at zero, so the merged module equals the base at init.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping, Optional, Pattern

import numpy as np
import torch
from torch import nn

from ..ops.quantize import flax_kernel_path

# Attention and MLP projection kernels, the standard LoRA placement (the
# JAX package's pattern, on Flax paths).
DEFAULT_TARGETS = re.compile(
    r"(qkv|/q|/k|/v|out|proj|fc1|fc2|geglu_in|geglu_out|mlp_fc1|mlp_fc2"
    r"|wi_0|wi_1|wo)[^/]*/kernel$")

_KERNEL = "/kernel"


def _kernels(module: nn.Module):
    """(Flax path, port weight name, weight) of every Dense and conv kernel
    of ``module``, in registration order."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            yield flax_kernel_path(name), f"{name}.weight", m.weight


def _flax_shape(w: torch.Tensor) -> tuple:
    if w.dim() == 2:
        return (w.shape[1], w.shape[0])
    if w.dim() == 4:
        return (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
    raise ValueError(f"{w.dim()}-D kernel")


def _to_torch_layout(delta: torch.Tensor) -> torch.Tensor:
    """A Flax-layout kernel as the port's weight (a view)."""
    return delta.t() if delta.dim() == 2 else delta.permute(3, 2, 0, 1)


def weight_name(path: str) -> str:
    """The port parameter name of a Flax kernel path."""
    if not path.endswith(_KERNEL):
        raise ValueError(f"{path}: not a kernel path")
    return path[:-len(_KERNEL)].replace("/", ".") + ".weight"


@torch.no_grad()
def init_lora(module: nn.Module, rank: int = 8,
              targets: Optional[Pattern] = None, min_dim: int = 1,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero-effect adapters for every kernel whose Flax path matches
    ``targets``: {path: {"a": s[:-1] + (r,) normal(1/√fan_in), "b": (r,
    s[-1]) zeros}} in fp32 on the kernel's device, Flax layout, requiring
    grad. ``min_dim``: skip kernels whose output dim is smaller."""
    targets = targets or DEFAULT_TARGETS
    lora = {}
    for path, _, w in sorted(_kernels(module)):
        s = _flax_shape(w)
        if s[-1] < min_dim or not targets.search(path):
            continue
        fan_in = int(np.prod(s[:-1]))
        a = torch.randn(s[:-1] + (rank,), generator=generator,
                        device=w.device) / math.sqrt(fan_in)
        b = torch.zeros((rank, s[-1]), device=w.device)
        lora[path] = {"a": a.requires_grad_(), "b": b.requires_grad_()}
    if not lora:
        raise ValueError("no parameter matched the LoRA target pattern")
    return lora


def merge_lora(named_params: Mapping[str, torch.Tensor],
               lora: Mapping[str, Mapping[str, torch.Tensor]],
               scale: float = 1.0,
               shard: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """name -> W + (scale/r)·ΔW for every adapted weight, ΔW = tensordot(A,
    B) in the Flax layout turned into the torch layout; every other
    parameter of ``named_params`` passes through untouched. ``shard(name,
    ΔW)``: the part of ΔW that a tensor-parallel rank's slice W takes."""
    merged = dict(named_params)
    for path, e in lora.items():
        name = weight_name(path)
        w = merged[name]
        r = e["b"].shape[0]
        delta = _to_torch_layout(torch.tensordot(e["a"], e["b"],
                                                 dims=([-1], [0])))
        if shard is not None:
            delta = shard(name, delta)
        merged[name] = w + (scale / r) * delta.to(w.dtype)
    return merged


def num_lora_params(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return sum(x.numel() for e in lora.values() for x in e.values())


def lora_from_jax(tree: Mapping, device=None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter dict ({path: {"a", "b"}} of arrays) as the port's, in
    fp32 on ``device``, requiring grad."""
    return {path: {k: torch.tensor(np.asarray(v, np.float32),
                                   device=device).requires_grad_()
                   for k, v in e.items()} for path, e in tree.items()}


def jax_lora_from_port(lora: Mapping[str, Mapping[str, torch.Tensor]]
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's adapter dict as the JAX one (numpy arrays)."""
    return {path: {k: v.detach().cpu().numpy() for k, v in e.items()}
            for path, e in lora.items()}
