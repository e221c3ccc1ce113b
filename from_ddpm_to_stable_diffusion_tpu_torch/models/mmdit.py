"""MMDiT, the SD3 multimodal diffusion transformer (port of
``models/mmdit.py``).

Patchify conv (k = s = patch), a learned position grid that is
centre-cropped to the latent's size, timestep and pooled-vector embedders,
adaLN "dismantled" blocks with 6-way (pre-only: 2-way) modulation, and
joint attention: context and latent tokens are projected separately and
attend over both streams (:func:`..ops.attention.joint_attention_blhd`,
which on the card runs the position-masked flash kernel four times per
block). hidden = 64·depth and heads = depth, so the head dim is always 64.
The last block's context side is ``pre_only``: it gives keys and values
only. NHWC in and out, the output fp32.

dtype: without ``compute_dtype`` every linear and the patchify conv compute
in the dtype their weights are stored in (serving stores bf16 weights).
With ``compute_dtype`` (training: the JAX ``MMDiT(dtype=...)`` over fp32
parameters) inputs, weights and biases are cast to it at each call and the
parameters stay as stored; LayerNorm and the q / k norms keep fp32
statistics and gains either way. ``torch.autocast`` is not used.

``int8_mm=True`` builds each block's ``qkv``, ``proj``, ``mlp_fc1`` and
``mlp_fc2`` as :class:`..ops.quantize.QuantLinear` (W8A8 serving); adaLN, the
embedders and the final layer stay in their dtype, and the joint attention
stays bf16 flash.

Not ported yet (ROADMAP.md): sequence-parallel attention (``ring``,
``ulysses``) and the Switch-MoE MLP (queue A8), pipeline parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_blhd, joint_attention_blhd
from ..ops.embeddings import crop_pos_embed, timestep_embedding
from ..ops.groupnorm import layer_norm, rms_norm
from ..ops.quantize import dense_cls
from .layers import Conv2d, Linear


def modulate(x, shift, scale):
    """adaLN modulation x·(1 + scale) + shift, per batch element."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class MLPEmbedder(nn.Module):
    """Linear → SiLU → Linear (the timestep and pooled-vector embedders)."""

    def __init__(self, in_features: int, hidden_size: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_size,
                          compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_size, hidden_size,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class QKNorm(nn.Module):
    """Per-head-dim q / k normalisation over (B, L, H, D): 'rms', 'ln' or
    None (identity, no parameters)."""

    def __init__(self, kind: Optional[str], head_dim: int):
        super().__init__()
        if kind not in (None, "rms", "ln"):
            raise ValueError(kind)
        self.kind = kind
        if kind is not None:
            self.weight = nn.Parameter(torch.ones(head_dim))
        if kind == "ln":
            self.bias = nn.Parameter(torch.zeros(head_dim))

    def forward(self, x):
        if self.kind is None:
            return x
        if self.kind == "rms":
            return rms_norm(x, self.weight, eps=1e-6)
        return layer_norm(x, self.weight, self.bias, eps=1e-6)


class DismantledBlock(nn.Module):
    """adaLN DiT block split into pre_attention / post_attention halves."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 pre_only: bool = False, qk_norm: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False):
        super().__init__()
        hs, dt = hidden_size, compute_dtype
        dense = dense_cls(int8_mm)
        self.num_heads, self.head_dim = num_heads, hs // num_heads
        self.pre_only = pre_only
        self.qkv = dense(hs, 3 * hs, bias=qkv_bias, compute_dtype=dt)
        self.ln_q = QKNorm(qk_norm, self.head_dim)
        self.ln_k = QKNorm(qk_norm, self.head_dim)
        self.adaLN = Linear(hs, (2 if pre_only else 6) * hs, compute_dtype=dt)
        if not pre_only:
            self.proj = dense(hs, hs, compute_dtype=dt)
            self.mlp_fc1 = dense(hs, int(hs * mlp_ratio), compute_dtype=dt)
            self.mlp_fc2 = dense(int(hs * mlp_ratio), hs, compute_dtype=dt)

    def _mods(self, c):
        m = self.adaLN(F.silu(c))
        if self.pre_only:
            shift, scale = m.chunk(2, dim=-1)
            return (shift, scale), None
        sh_msa, s_msa, g_msa, sh_mlp, s_mlp, g_mlp = m.chunk(6, dim=-1)
        return (sh_msa, s_msa), (g_msa, sh_mlp, s_mlp, g_mlp)

    def pre_attention(self, x, c):
        """((q, k, v) each (B, L, H, D), residual_state). q, k and v are
        views of the fused projection; the attention kernels read them
        through their strides."""
        (shift, scale), post_mods = self._mods(c)
        h = modulate(layer_norm(x, None, None, eps=1e-6), shift, scale)
        b, l, _ = h.shape
        qkv = self.qkv(h).reshape(b, l, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        return (self.ln_q(q), self.ln_k(k), v), (x, post_mods)

    def post_attention(self, attn_out, residual_state):
        """attn_out (B, L, hidden): gated residual, then the adaLN MLP."""
        x, (g_msa, sh_mlp, s_mlp, g_mlp) = residual_state
        x = x + g_msa[:, None, :] * self.proj(attn_out)
        h = modulate(layer_norm(x, None, None, eps=1e-6), sh_mlp, s_mlp)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + g_mlp[:, None, :] * h

    def forward(self, x, c):
        (q, k, v), state = self.pre_attention(x, c)
        out = attention_blhd(q, k, v)
        return self.post_attention(out.reshape(*out.shape[:2], -1), state)


class JointBlock(nn.Module):
    """One MMDiT layer: a context block and an x block sharing one joint
    attention. ``stability``: None picks "bounded" (fixed-max softmax) when
    ``qk_norm`` bounds the logits and "online" otherwise."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 context_pre_only: bool = False,
                 qk_norm: Optional[str] = None,
                 stability: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.stability = stability or ("bounded" if qk_norm else "online")
        self.context_block = DismantledBlock(
            hidden_size, num_heads, mlp_ratio, qkv_bias,
            pre_only=context_pre_only, qk_norm=qk_norm,
            compute_dtype=compute_dtype, int8_mm=int8_mm)
        self.x_block = DismantledBlock(
            hidden_size, num_heads, mlp_ratio, qkv_bias, pre_only=False,
            qk_norm=qk_norm, compute_dtype=compute_dtype, int8_mm=int8_mm)

    def forward(self, context, x, c):
        ctx_qkv, ctx_state = self.context_block.pre_attention(context, c)
        x_qkv, x_state = self.x_block.pre_attention(x, c)
        ctx_attn, x_attn = joint_attention_blhd(ctx_qkv, x_qkv,
                                                stability=self.stability)
        b, lc = context.shape[:2]
        new_context = (None if self.context_pre_only else
                       self.context_block.post_attention(
                           ctx_attn.reshape(b, lc, -1), ctx_state))
        return new_context, self.x_block.post_attention(
            x_attn.reshape(b, x.shape[1], -1), x_state)


def qk_norm_logit_bound(model: nn.Module, head_dim: int,
                        kind: str = "rms") -> float:
    """Largest |scale·q·k| any attention logit can reach, from the QKNorm
    gains of ``model``: the certificate for ``stability="bounded"``.

    rms: ‖x̂‖₂ = √d, so ‖g⊙x̂‖₂ ≤ max|g|·√d. ln: ‖(x−μ)/σ·g + b‖₂ ≤
    max|g|·√d + ‖b‖₂. Then |q·k|/√d ≤ term_q·term_k/√d; the largest over all
    (ln_q, ln_k) pairs. Above :data:`BOUNDED_LOGIT_BUDGET` a caller should
    take the online softmax."""

    def term(norm: QKNorm) -> float:
        t = norm.weight.detach().double().abs().max().item() * math.sqrt(
            head_dim)
        if kind == "ln" and norm.kind == "ln":
            t += norm.bias.detach().double().norm().item()
        return t

    worst = 0.0
    for m in model.modules():
        if isinstance(m, DismantledBlock) and m.ln_q.kind is not None:
            worst = max(worst,
                        term(m.ln_q) * term(m.ln_k) / math.sqrt(head_dim))
    return worst


# fp32 exp overflows near 88.7 and the softmax sum adds ln(L) ≈ 9 on top; the
# bounded softmax needs the certified bound to clear that with a margin.
BOUNDED_LOGIT_BUDGET = 70.0


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    depth: int = 24                    # hidden = 64·depth, heads = depth
    mlp_ratio: float = 4.0
    adm_in_channels: Optional[int] = 2048
    context_dim: Optional[int] = 4096
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None
    qkv_bias: bool = True
    attention_impl: str = "flash"      # 'ring' | 'ulysses': queue A8
    int8_mm: bool = False              # W8A8 block projections
    moe_experts: Optional[int] = None  # queue A8
    stability: Optional[str] = None    # None: 'bounded' iff qk_norm

    @property
    def hidden_size(self) -> int:
        return 64 * self.depth


class MMDiT(nn.Module):
    """x (B, H, W, C) NHWC latent, t (B,) timesteps, y (B, adm) pooled
    conditioning, context (B, Lc, context_dim) -> (B, H, W, C) fp32.
    ``compute_dtype``: see the module docstring."""

    def __init__(self, config: MMDiTConfig = MMDiTConfig(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg, dt = config, compute_dtype
        self.compute_dtype = compute_dtype
        for name, off in (("attention_impl", "flash"),
                          ("moe_experts", None)):
            if getattr(cfg, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} is not ported yet "
                    f"(ROADMAP.md queue A8)")
        self.config = cfg
        hs, p = cfg.hidden_size, cfg.patch_size
        self.x_embedder = Conv2d(cfg.in_channels, hs, p, stride=p,
                                 compute_dtype=dt)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_embed_max_size ** 2, hs))
        self.t_embedder = MLPEmbedder(256, hs, dt)
        if cfg.adm_in_channels is not None:
            self.y_embedder = MLPEmbedder(cfg.adm_in_channels, hs, dt)
        if cfg.context_dim is not None:
            self.context_embedder = Linear(cfg.context_dim, hs,
                                           compute_dtype=dt)
        for i in range(cfg.depth):
            self.add_module(f"joint_block{i}", JointBlock(
                hs, cfg.depth, cfg.mlp_ratio, cfg.qkv_bias,
                context_pre_only=(i == cfg.depth - 1), qk_norm=cfg.qk_norm,
                stability=cfg.stability, compute_dtype=dt,
                int8_mm=cfg.int8_mm))
        self.final_adaLN = Linear(hs, 2 * hs, compute_dtype=dt)
        self.final_linear = Linear(hs, p * p * cfg.in_channels,
                                   compute_dtype=dt)

    def forward(self, x, t, y=None, context=None):
        cfg = self.config
        dt = self.compute_dtype or self.x_embedder.weight.dtype
        b, h, w, _ = x.shape
        p = cfg.patch_size
        hp, wp = h // p, w // p

        xe = self.x_embedder(x.to(dt)).reshape(b, hp * wp, cfg.hidden_size)
        xe = xe + crop_pos_embed(self.pos_embed, cfg.pos_embed_max_size, hp,
                                 wp).to(dt)
        c = self.t_embedder(timestep_embedding(t, 256).to(dt))
        if y is not None and cfg.adm_in_channels is not None:
            c = c + self.y_embedder(y.to(dt))
        if context is not None and cfg.context_dim is not None:
            context = self.context_embedder(context.to(dt))

        for i in range(cfg.depth):
            context, xe = getattr(self, f"joint_block{i}")(context, xe, c)

        shift, scale = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        xe = modulate(layer_norm(xe, None, None, eps=1e-6), shift, scale)
        xe = self.final_linear(xe)

        # unpatchify: (b, hp, wp, p, q, c) -> (b, hp, p, wp, q, c) -> NHWC
        xe = xe.reshape(b, hp, wp, p, p, cfg.in_channels)
        xe = xe.permute(0, 1, 3, 2, 4, 5)
        return xe.reshape(b, hp * p, wp * p, cfg.in_channels).float()
