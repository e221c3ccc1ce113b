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

Parallel forms (:mod:`..parallel`): ``MMDiTConfig.attention_impl`` "ring"
or "ulysses" with ``MMDiT(mesh=)`` runs each joint attention over one
concatenated [context | x] sequence, padded to a multiple of the ``seq``
axis and sharded over it (:func:`..parallel.ring_attention.ring_attention`,
:func:`..parallel.ring_attention.ulysses_attention`); ``moe_experts``
replaces every x-stream MLP by a :class:`..parallel.expert.SwitchFFN`
whose experts shard over the mesh's ``expert`` axis, and
:func:`collect_losses` gathers its balance losses; the four pipeline
functions at the end run the block stack over a ``stage`` axis
(:mod:`..parallel.pipeline`). Tensor parallelism over a ``model`` axis
(:func:`..parallel.sharding.apply_tp`): each shard runs the joint attention
on its heads of both streams (so every flash call has H/n heads), ``proj``
and the MLPs are Megatron pairs, and the ``adaLN`` / ``final_adaLN``
modulations are gathered whole. The two compose on one mesh with ``seq``
and ``model`` axes (or a ``seq`` mesh and a ``model`` one): each head
shard runs its own ring or Ulysses over ``seq``, so a ring hop launches K5
at (B, H/model, L/seq, D).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_blhd, joint_attention_blhd
from ..ops.embeddings import crop_pos_embed, timestep_embedding
from ..ops.groupnorm import layer_norm, rms_norm
from ..ops.quantize import dense_cls
from ..parallel.expert import SwitchFFN
from ..parallel.pipeline import pipeline_apply
from ..parallel.ring_attention import ring_attention, ulysses_attention
from ..parallel.sharding import column, gathered, row
from .layers import Conv2d, Linear


def modulate(x, shift, scale):
    """adaLN modulation x·(1 + scale) + shift, per batch element."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class MLPEmbedder(nn.Module):
    """Linear → SiLU → Linear (the timestep and pooled-vector embedders)."""

    TP_LAYERS = {"fc1": ("column", 1), "fc2": ("row", 1)}
    tp = None

    def __init__(self, in_features: int, hidden_size: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_size,
                          compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_size, hidden_size,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        if self.tp is not None:
            return row(self.fc2, [F.silu(h) for h in column(
                self.fc1, x, self.tp)], self.tp)
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
    """adaLN DiT block split into pre_attention / post_attention halves.
    ``moe_experts``: a Switch-MoE MLP (experts sharded over the ``expert``
    axis of ``moe_mesh`` when given) in place of the dense one; its balance
    loss goes into the dict :func:`collect_losses` opens, and nowhere
    without one (Flax's ``sow`` into an immutable collection). Under TP
    (``tp`` set) :meth:`pre_attention` gives one (q, k, v) per held shard
    and :meth:`post_attention` takes one output per held shard; a Switch-MoE
    MLP runs whole."""

    TP_LAYERS = {"qkv": ("column", 3), "adaLN": ("gathered", 1),
                 "proj": ("row", 1), "mlp_fc1": ("column", 1),
                 "mlp_fc2": ("row", 1)}
    tp = None

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 pre_only: bool = False, qk_norm: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False, moe_experts: Optional[int] = None,
                 moe_mesh=None):
        super().__init__()
        hs, dt = hidden_size, compute_dtype
        dense = dense_cls(int8_mm)
        self.num_heads, self.head_dim = num_heads, hs // num_heads
        self.pre_only = pre_only
        self.moe_experts, self.moe_mesh = moe_experts, moe_mesh
        self.sown: Optional[Dict[str, torch.Tensor]] = None
        self.qkv = dense(hs, 3 * hs, bias=qkv_bias, compute_dtype=dt)
        self.ln_q = QKNorm(qk_norm, self.head_dim)
        self.ln_k = QKNorm(qk_norm, self.head_dim)
        self.adaLN = Linear(hs, (2 if pre_only else 6) * hs, compute_dtype=dt)
        if not pre_only:
            self.proj = dense(hs, hs, compute_dtype=dt)
            if moe_experts:
                self.moe = SwitchFFN(hs, moe_experts,
                                     hidden_mult=int(mlp_ratio))
            else:
                self.mlp_fc1 = dense(hs, int(hs * mlp_ratio),
                                     compute_dtype=dt)
                self.mlp_fc2 = dense(int(hs * mlp_ratio), hs,
                                     compute_dtype=dt)

    def _mods(self, c):
        m = (self.adaLN(F.silu(c)) if self.tp is None else
             gathered(self.adaLN, F.silu(c), self.tp))
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
        if self.tp is not None:
            heads = (b, l, self.num_heads // self.tp.n, self.head_dim)
            return [(self.ln_q(q.reshape(heads)), self.ln_k(k.reshape(heads)),
                     v.reshape(heads))
                    for q, k, v in column(self.qkv, h, self.tp, 3)], \
                (x, post_mods)
        qkv = self.qkv(h).reshape(b, l, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        return (self.ln_q(q), self.ln_k(k), v), (x, post_mods)

    def post_attention(self, attn_out, residual_state):
        """attn_out (B, L, hidden): gated residual, then the adaLN MLP."""
        x, (g_msa, sh_mlp, s_mlp, g_mlp) = residual_state
        tp = self.tp
        x = x + g_msa[:, None, :] * (self.proj(attn_out) if tp is None
                                     else row(self.proj, attn_out, tp))
        h = modulate(layer_norm(x, None, None, eps=1e-6), sh_mlp, s_mlp)
        if self.moe_experts:
            h, aux = self.moe(h, mesh=self.moe_mesh)
            if self.sown is not None:
                self.sown[self.sow_name] = aux
        elif tp is not None:
            h = row(self.mlp_fc2, [F.gelu(a, approximate="tanh")
                                   for a in column(self.mlp_fc1, h, tp)], tp)
        else:
            h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + g_mlp[:, None, :] * h

    def forward(self, x, c):
        (q, k, v), state = self.pre_attention(x, c)
        out = attention_blhd(q, k, v)
        return self.post_attention(out.reshape(*out.shape[:2], -1), state)


class JointBlock(nn.Module):
    """One MMDiT layer: a context block and an x block sharing one joint
    attention. ``stability``: None picks "bounded" (fixed-max softmax) when
    ``qk_norm`` bounds the logits and "online" otherwise.

    ``mesh`` / ``seq_axis`` / ``seq_impl`` ("ring" | "ulysses") switch the
    joint attention to the sequence-parallel one: [context | x] as one
    sequence, padded to a multiple of the axis size, (B, H, L, D), the padded
    keys masked by ``kv_valid_len`` and the padded rows sliced off. The split
    K/V streams of the one-device path and this concatenation agree up to
    floating-point reassociation. Under TP (the blocks' ``tp`` set) each
    held head shard runs that attention on its heads. The MoE MLP
    (``moe_experts``) is on the x stream only: its 4096 tokens fill expert
    capacity, the context's 154 do not."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 context_pre_only: bool = False,
                 qk_norm: Optional[str] = None,
                 stability: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False, mesh=None, seq_axis: str = "seq",
                 seq_impl: str = "ring", moe_experts: Optional[int] = None,
                 moe_mesh=None):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.stability = stability or ("bounded" if qk_norm else "online")
        self.mesh, self.seq_axis, self.seq_impl = mesh, seq_axis, seq_impl
        self.context_block = DismantledBlock(
            hidden_size, num_heads, mlp_ratio, qkv_bias,
            pre_only=context_pre_only, qk_norm=qk_norm,
            compute_dtype=compute_dtype, int8_mm=int8_mm)
        self.x_block = DismantledBlock(
            hidden_size, num_heads, mlp_ratio, qkv_bias, pre_only=False,
            qk_norm=qk_norm, compute_dtype=compute_dtype, int8_mm=int8_mm,
            moe_experts=moe_experts, moe_mesh=moe_mesh)

    def _joint_sp(self, ctx_qkv, x_qkv):
        """(ctx_attn, x_attn) of the joint sequence over the ``seq`` axis,
        each (B, L, h·D), for (q, k, v) of h heads."""
        comm = self.mesh.comm(self.seq_axis)
        b, lc = ctx_qkv[0].shape[:2]
        l_actual = lc + x_qkv[0].shape[1]
        pad = (-l_actual) % comm.n

        def joint(a, z):
            parts = [a, z] + ([a.new_zeros(b, pad, *a.shape[2:])] if pad
                              else [])
            return comm.scatter(torch.cat(parts, 1).transpose(1, 2), 2)

        q, k, v = (joint(a, z) for a, z in zip(ctx_qkv, x_qkv))
        sp = ulysses_attention if self.seq_impl == "ulysses" else \
            ring_attention
        out = comm.gather(sp(q, k, v, self.mesh, self.seq_axis,
                             kv_valid_len=l_actual), 2)[:, :, :l_actual]
        out = out.transpose(1, 2).reshape(b, l_actual, -1)
        return out[:, :lc], out[:, lc:]

    def _sequence_parallel(self, ctx_qkv, x_qkv):
        """For each held head shard's (q, k, v) of both streams, its
        (ctx_attn, x_attn) over the ``seq`` axis: the ring on the shard's
        heads. Ulysses reshards heads over ``seq``; where a shard's heads do
        not divide by it, the shards are gathered and the joint attention
        runs on every head, each shard keeping its heads of the output (the
        JAX shard_map keeps the head axis whole)."""
        tp = self.x_block.tp
        heads = ctx_qkv[0][0].shape[2]
        if tp is None or self.seq_impl != "ulysses" or \
                heads % self.mesh.shape[self.seq_axis] == 0:
            return [self._joint_sp(cq, xq) for cq, xq in zip(ctx_qkv,
                                                              x_qkv)]
        if tp.distributed:
            whole = lambda shards: tuple(tp.gather(a, 2) for a in shards[0])
            split = lambda t: [tp.scatter(t, 2)]
        else:
            whole = lambda shards: tuple(torch.cat(a, 2)
                                         for a in zip(*shards))
            split = lambda t: t.chunk(tp.n, 2)
        outs = self._joint_sp(whole(ctx_qkv), whole(x_qkv))
        return list(zip(*(split(o) for o in outs)))

    def forward(self, context, x, c):
        ctx_qkv, ctx_state = self.context_block.pre_attention(context, c)
        x_qkv, x_state = self.x_block.pre_attention(x, c)
        b, lc = context.shape[:2]
        tp = self.x_block.tp is not None
        if not tp:      # one (q, k, v) of every head
            ctx_qkv, x_qkv = [ctx_qkv], [x_qkv]
        if self.mesh is None:
            outs = [joint_attention_blhd(cq, xq, stability=self.stability)
                    for cq, xq in zip(ctx_qkv, x_qkv)]
        else:
            outs = self._sequence_parallel(ctx_qkv, x_qkv)
        ctx_attn = [o[0].reshape(b, lc, -1) for o in outs]
        x_attn = [o[1].reshape(b, x.shape[1], -1) for o in outs]
        if not tp:
            ctx_attn, x_attn = ctx_attn[0], x_attn[0]
        new_context = (None if self.context_pre_only else
                       self.context_block.post_attention(ctx_attn,
                                                         ctx_state))
        return new_context, self.x_block.post_attention(x_attn, x_state)


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
    # 'flash' (one device) | 'ring' | 'ulysses' (sequence-parallel over the
    # ``seq`` axis of MMDiT(mesh=))
    attention_impl: str = "flash"
    int8_mm: bool = False              # W8A8 block projections
    # Switch-MoE MLP in every x-stream block, experts over the mesh's
    # 'expert' axis when it has one; balance losses via collect_losses
    moe_experts: Optional[int] = None
    stability: Optional[str] = None    # None: 'bounded' iff qk_norm

    @property
    def hidden_size(self) -> int:
        return 64 * self.depth


class MMDiT(nn.Module):
    """x (B, H, W, C) NHWC latent, t (B,) timesteps, y (B, adm) pooled
    conditioning, context (B, Lc, context_dim) -> (B, H, W, C) fp32.
    ``compute_dtype``: see the module docstring. ``mesh`` (:mod:`..parallel`)
    carries the ``seq`` axis (``seq_axis``) of a ring / Ulysses config and
    the ``expert`` axis of an MoE one; the flash config ignores its ``seq``
    axis, as the JAX model does. Under TP (:func:`..parallel.sharding.
    apply_tp`) ``final_adaLN`` is gathered whole."""

    TP_LAYERS = {"final_adaLN": ("gathered", 1)}
    tp = None

    def __init__(self, config: MMDiTConfig = MMDiTConfig(),
                 compute_dtype: Optional[torch.dtype] = None, mesh=None,
                 seq_axis: str = "seq"):
        super().__init__()
        cfg, dt = config, compute_dtype
        self.compute_dtype = compute_dtype
        if cfg.attention_impl not in ("flash", "ring", "ulysses"):
            raise ValueError(f"attention_impl must be flash|ring|ulysses: "
                             f"{cfg.attention_impl!r}")
        self.config, self.mesh, self.seq_axis = cfg, mesh, seq_axis
        sp_mesh = mesh if cfg.attention_impl in ("ring", "ulysses") else None
        ep_mesh = (mesh if mesh is not None and cfg.moe_experts
                   and "expert" in mesh.shape else None)
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
                int8_mm=cfg.int8_mm, mesh=sp_mesh, seq_axis=seq_axis,
                seq_impl=cfg.attention_impl, moe_experts=cfg.moe_experts,
                moe_mesh=ep_mesh))
        self.final_adaLN = Linear(hs, 2 * hs, compute_dtype=dt)
        self.final_linear = Linear(hs, p * p * cfg.in_channels,
                                   compute_dtype=dt)

    def set_attention(self, impl: str, mesh=None, seq_axis: str = "seq"):
        """Switch the joint attention in place, the parameters kept: "flash"
        (one device) or "ring" / "ulysses" over the ``seq_axis`` of
        ``mesh``, as the JAX CLI rebuilds its MMDiT with
        ``attention_impl=`` and ``mesh=`` over the same parameters."""
        if impl not in ("flash", "ring", "ulysses"):
            raise ValueError(f"attention_impl must be flash|ring|ulysses: "
                             f"{impl!r}")
        if impl != "flash" and (mesh is None or seq_axis not in mesh.shape):
            raise ValueError(f"{impl} attention needs a mesh with a "
                             f"{seq_axis!r} axis")
        self.config = dataclasses.replace(self.config, attention_impl=impl)
        self.mesh, self.seq_axis = mesh, seq_axis
        for i in range(self.config.depth):
            blk = getattr(self, f"joint_block{i}")
            blk.mesh = None if impl == "flash" else mesh
            blk.seq_axis, blk.seq_impl = seq_axis, impl
        return self

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

        mods = (self.final_adaLN(F.silu(c)) if self.tp is None else
                gathered(self.final_adaLN, F.silu(c), self.tp))
        shift, scale = mods.chunk(2, dim=-1)
        xe = modulate(layer_norm(xe, None, None, eps=1e-6), shift, scale)
        xe = self.final_linear(xe)

        # unpatchify: (b, hp, wp, p, q, c) -> (b, hp, p, wp, q, c) -> NHWC
        xe = xe.reshape(b, hp, wp, p, p, cfg.in_channels)
        xe = xe.permute(0, 1, 3, 2, 4, 5)
        return xe.reshape(b, hp * p, wp * p, cfg.in_channels).float()


@contextlib.contextmanager
def collect_losses(model: nn.Module):
    """Inside the block, every MoE block of ``model`` puts its balance loss
    of the last forward into the yielded dict, under its module name
    (``joint_block{i}.x_block``): Flax's ``sow`` into a mutable ``losses``
    collection. Outside, the losses go nowhere."""
    sown: Dict[str, torch.Tensor] = {}
    blocks = [(name, m) for name, m in model.named_modules()
              if isinstance(m, DismantledBlock) and m.moe_experts]
    for name, m in blocks:
        m.sown, m.sow_name = sown, name
    try:
        yield sown
    finally:
        for _, m in blocks:
            m.sown = None


# --------------------------------------------------------------------------
# Pipeline parallelism over the joint-block stack
# --------------------------------------------------------------------------
# The homogeneous prefix of the stack (blocks 0..depth-2; the last block is
# pre_only) splits over a ``stage`` mesh axis and runs under
# parallel.pipeline's GPipe / 1F1B schedules. (context, x, c) travel as one
# (B, Lc + Lx + 1, hidden) tensor, so a microbatch is one hand-off.

def _sub(params, prefix):
    """The entries of a flat parameter dict under ``prefix.``, renamed
    relative to it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def stack_joint_block_params(params, n_blocks: int, n_stages: int):
    """The parameters of ``joint_block0`` .. ``joint_block{n_blocks-1}`` of
    a flat MMDiT parameter dict (``dict(model.named_parameters())``) as
    {name within a block: (n_stages, k, ...)}, k = n_blocks / n_stages."""
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} blocks do not divide over {n_stages} "
                         "stages")
    k = n_blocks // n_stages
    blocks = [_sub(params, f"joint_block{i}") for i in range(n_blocks)]
    return {name: torch.stack([b[name] for b in blocks]).reshape(
        n_stages, k, *blocks[0][name].shape) for name in blocks[0]}


def make_joint_block_stage_fn(cfg: MMDiTConfig, lc: int, k: int,
                              compute_dtype: Optional[torch.dtype] = None):
    """stage_fn(params_k, z) applying k consecutive JointBlocks to z =
    [context | x | c-token] (B, Lc + Lx + 1, hidden); the leaves of
    ``params_k`` have leading dim k (this stage's blocks)."""
    with torch.device("meta"):
        blk = JointBlock(cfg.hidden_size, cfg.depth, cfg.mlp_ratio,
                         cfg.qkv_bias, context_pre_only=False,
                         qk_norm=cfg.qk_norm, compute_dtype=compute_dtype)

    def stage_fn(params_k, z):
        context, x, c = z[:, :lc], z[:, lc:-1], z[:, -1]
        for j in range(k):
            pj = {name: p[j] for name, p in params_k.items()}
            context, x = torch.func.functional_call(blk, pj, (context, x, c))
        return torch.cat([context, x, c[:, None]], dim=1)

    return stage_fn


def pipelined_joint_blocks(cfg: MMDiTConfig, params, context, x, c, mesh,
                           n_microbatches: int, axis: str = "stage",
                           n_blocks: Optional[int] = None,
                           compute_dtype: Optional[torch.dtype] = None):
    """The homogeneous joint blocks 0..n_blocks-1 (default depth - 1, every
    block but the pre_only last) pipelined over ``axis`` of ``mesh``.
    context (B, Lc, hidden) embedded, x (B, Lx, hidden) patchified tokens,
    c (B, hidden) conditioning; returns (context, x). ``params``: the
    MMDiT's flat parameter dict, whole on every shard."""
    n_blocks = cfg.depth - 1 if n_blocks is None else n_blocks
    comm = mesh.comm(axis)
    stacked = {name: comm.scatter(p, 0) for name, p in
               stack_joint_block_params(params, n_blocks, comm.n).items()}
    lc = context.shape[1]
    z = torch.cat([context, x, c[:, None]], dim=1)
    stage_fn = make_joint_block_stage_fn(cfg, lc, n_blocks // comm.n,
                                         compute_dtype)
    z = pipeline_apply(stage_fn, stacked, z, mesh, n_microbatches, axis=axis)
    return z[:, :lc], z[:, lc:-1]


def mmdit_forward_pp(cfg: MMDiTConfig, params, x, t, y, context, mesh,
                     n_microbatches: int, axis: str = "stage",
                     compute_dtype: Optional[torch.dtype] = None):
    """The whole MMDiT forward with blocks 0..depth-2 pipelined over
    ``axis`` (GPipe); the embeddings, the pre_only last block and the head
    run whole. ``params``: the flat parameter dict of an ``MMDiT(cfg,
    compute_dtype)`` (``dict(model.named_parameters())``); equals that
    model's forward. Differentiable in ``params``."""
    with torch.device("meta"):
        model = MMDiT(dataclasses.replace(cfg, attention_impl="flash",
                                          moe_experts=None),
                      compute_dtype=compute_dtype)
    call = lambda name, *args: torch.func.functional_call(
        getattr(model, name), _sub(params, name), args)
    dt = compute_dtype or params["x_embedder.weight"].dtype
    hs, p = cfg.hidden_size, cfg.patch_size
    b, h, w, _ = x.shape
    hp, wp = h // p, w // p
    xe = call("x_embedder", x.to(dt)).reshape(b, hp * wp, hs)
    xe = xe + crop_pos_embed(params["pos_embed"], cfg.pos_embed_max_size, hp,
                             wp).to(dt)
    c = call("t_embedder", timestep_embedding(t, 256).to(dt))
    if y is not None and cfg.adm_in_channels is not None:
        c = c + call("y_embedder", y.to(dt))
    if context is not None and cfg.context_dim is not None:
        context = call("context_embedder", context.to(dt))
    context, xe = pipelined_joint_blocks(cfg, params, context, xe, c, mesh,
                                         n_microbatches, axis=axis,
                                         compute_dtype=compute_dtype)
    _, xe = call(f"joint_block{cfg.depth - 1}", context, xe, c)
    shift, scale = call("final_adaLN", F.silu(c)).chunk(2, dim=-1)
    xe = call("final_linear",
              modulate(layer_norm(xe, None, None, eps=1e-6), shift, scale))
    xe = xe.reshape(b, hp, wp, p, p, cfg.in_channels).permute(0, 1, 3, 2, 4, 5)
    return xe.reshape(b, hp * p, wp * p, cfg.in_channels).float()
