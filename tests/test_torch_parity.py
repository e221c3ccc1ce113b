"""Numerical parity: random-weight torch oracle blocks → weight import →
our Flax modules must reproduce the outputs (fp32, tolerance 1e-4).

These tests build small torch modules in the test body (independent
oracles, not reference code), export their state dicts, import them through
the declarative mapping layer, and compare forward passes — validating the
layout conversions, key mappings, and module semantics together, which is
exactly what real-checkpoint loading relies on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from from_ddpm_to_stable_diffusion_tpu.io import weights as W
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.slow  # compile-heavy: full models/pipelines


def _to_jax_tree(rules, state):
    return jax.tree_util.tree_map(jnp.asarray, W.apply_rules(state, rules))


def test_sd1_resblock_parity():
    torch.manual_seed(0)

    class TorchRes(nn.Module):
        def __init__(self, cin, cout, n_time):
            super().__init__()
            self.groupnorm_feature = nn.GroupNorm(32, cin)
            self.conv_feature = nn.Conv2d(cin, cout, 3, padding=1)
            self.linear_time = nn.Linear(n_time, cout)
            self.groupnorm_merged = nn.GroupNorm(32, cout)
            self.conv_merged = nn.Conv2d(cout, cout, 3, padding=1)
            self.residual_layer = nn.Conv2d(cin, cout, 1)

        def forward(self, x, t):
            h = self.conv_feature(F.silu(self.groupnorm_feature(x)))
            h = h + self.linear_time(F.silu(t))[:, :, None, None]
            h = self.conv_merged(F.silu(self.groupnorm_merged(h)))
            return h + self.residual_layer(x)

    tm = TorchRes(32, 64, 128).eval()
    x = torch.randn(2, 32, 8, 8)
    t = torch.randn(2, 128)
    with torch.no_grad():
        want = tm(x, t).numpy()

    from from_ddpm_to_stable_diffusion_tpu.io.weights import _unet_res
    from from_ddpm_to_stable_diffusion_tpu.models.sd1 import SD1ResBlock

    state = {f"blk.{k}": v.numpy() for k, v in tm.state_dict().items()}
    params = _to_jax_tree(_unet_res("blk", ""), state)
    model = SD1ResBlock(64)
    got = model.apply({"params": params},
                      jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      jnp.asarray(t.numpy()))
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sd1_attention_block_parity():
    torch.manual_seed(1)
    c, heads, d_ctx = 64, 4, 48

    class TorchAttnBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.groupnorm = nn.GroupNorm(32, c, eps=1e-6)
            self.conv_input = nn.Conv2d(c, c, 1)
            self.layernorm_1 = nn.LayerNorm(c)
            self.attn1_in = nn.Linear(c, 3 * c, bias=False)
            self.attn1_out = nn.Linear(c, c)
            self.layernorm_2 = nn.LayerNorm(c)
            self.q = nn.Linear(c, c, bias=False)
            self.k = nn.Linear(d_ctx, c, bias=False)
            self.v = nn.Linear(d_ctx, c, bias=False)
            self.attn2_out = nn.Linear(c, c)
            self.layernorm_3 = nn.LayerNorm(c)
            self.geglu1 = nn.Linear(c, 8 * c)
            self.geglu2 = nn.Linear(4 * c, c)
            self.conv_output = nn.Conv2d(c, c, 1)

        def _mha(self, q, k, v):
            b, lq, _ = q.shape
            lk = k.shape[1]
            q = q.view(b, lq, heads, c // heads).transpose(1, 2)
            k = k.view(b, lk, heads, c // heads).transpose(1, 2)
            v = v.view(b, lk, heads, c // heads).transpose(1, 2)
            o = F.scaled_dot_product_attention(q, k, v)
            return o.transpose(1, 2).reshape(b, lq, c)

        def forward(self, x, ctx):
            long = x
            x = self.conv_input(self.groupnorm(x))
            b, ch, hh, ww = x.shape
            x = x.view(b, ch, hh * ww).transpose(-1, -2)
            y = self.layernorm_1(x)
            qkv = self.attn1_in(y)
            q, k, v = qkv.chunk(3, dim=-1)
            x = x + self.attn1_out(self._mha(q, k, v))
            y = self.layernorm_2(x)
            x = x + self.attn2_out(self._mha(self.q(y), self.k(ctx),
                                             self.v(ctx)))
            y = self.layernorm_3(x)
            a, gate = self.geglu1(y).chunk(2, dim=-1)
            x = x + self.geglu2(a * F.gelu(gate))
            x = x.transpose(-1, -2).view(b, ch, hh, ww)
            return self.conv_output(x) + long

    tm = TorchAttnBlock().eval()
    x = torch.randn(2, c, 4, 4)
    ctx = torch.randn(2, 7, d_ctx)
    with torch.no_grad():
        want = tm(x, ctx).numpy()

    # rename oracle fields to the reference layout the rules expect
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    state = {}
    ren = {
        "groupnorm": "groupnorm", "conv_input": "conv_input",
        "layernorm_1": "layernorm_1",
        "attn1_in": "attention_1.in_proj", "attn1_out": "attention_1.out_proj",
        "layernorm_2": "layernorm_2",
        "q": "attention_2.q_proj", "k": "attention_2.k_proj",
        "v": "attention_2.v_proj", "attn2_out": "attention_2.out_proj",
        "layernorm_3": "layernorm_3", "geglu1": "linear_geglu_1",
        "geglu2": "linear_geglu_2", "conv_output": "conv_output",
    }
    for k, v in sd.items():
        mod, leaf = k.rsplit(".", 1)
        state[f"blk.{ren[mod]}.{leaf}"] = v

    from from_ddpm_to_stable_diffusion_tpu.io.weights import _unet_att
    from from_ddpm_to_stable_diffusion_tpu.models.layers import TransformerBlock

    params = _to_jax_tree(_unet_att("blk", ""), state)
    model = TransformerBlock(num_heads=heads)
    got = model.apply({"params": params},
                      jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      jnp.asarray(ctx.numpy()))
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_t5_block_parity():
    torch.manual_seed(2)
    d_model, d_ff, heads, L = 32, 64, 4, 9

    class TorchT5Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.Parameter(torch.rand(d_model) + 0.5)
            self.q = nn.Linear(d_model, d_model, bias=False)
            self.k = nn.Linear(d_model, d_model, bias=False)
            self.v = nn.Linear(d_model, d_model, bias=False)
            self.o = nn.Linear(d_model, d_model, bias=False)
            self.rel = nn.Embedding(32, heads)
            self.ln2 = nn.Parameter(torch.rand(d_model) + 0.5)
            self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
            self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
            self.wo = nn.Linear(d_ff, d_model, bias=False)

        @staticmethod
        def rms(x, w):
            var = x.pow(2).mean(-1, keepdim=True)
            return w * (x * torch.rsqrt(var + 1e-6))

        def forward(self, x, bias):
            h = self.rms(x, self.ln1)
            b, l, _ = h.shape
            dh = d_model // heads
            q = self.q(h).view(b, l, heads, dh).transpose(1, 2)
            k = self.k(h).view(b, l, heads, dh).transpose(1, 2)
            v = self.v(h).view(b, l, heads, dh).transpose(1, 2)
            logits = q @ k.transpose(-1, -2) + bias  # unscaled + rel bias
            att = logits.softmax(-1) @ v
            att = att.transpose(1, 2).reshape(b, l, d_model)
            x = x + self.o(att)
            h = self.rms(x, self.ln2)
            h = self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))
            return x + h

    tm = TorchT5Block().eval()
    x = torch.randn(1, L, d_model)
    # oracle bias from the torch-side bucket table
    from from_ddpm_to_stable_diffusion_tpu.models.text_encoders import (
        t5_relative_position_bucket)

    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    buckets = np.asarray(t5_relative_position_bucket(jnp.asarray(rel)))
    with torch.no_grad():
        bias = tm.rel(torch.tensor(buckets)).permute(2, 0, 1)[None]
        want = tm(x, bias).numpy()

    from from_ddpm_to_stable_diffusion_tpu.io.weights_sd3 import sd3_t5_rules
    from from_ddpm_to_stable_diffusion_tpu.models.text_encoders import (
        T5Block, T5Config)

    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    state = {
        "encoder.block.0.layer.0.SelfAttention.q.weight": sd["q.weight"],
        "encoder.block.0.layer.0.SelfAttention.k.weight": sd["k.weight"],
        "encoder.block.0.layer.0.SelfAttention.v.weight": sd["v.weight"],
        "encoder.block.0.layer.0.SelfAttention.o.weight": sd["o.weight"],
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            sd["rel.weight"],
        "encoder.block.0.layer.0.layer_norm.weight": sd["ln1"],
        "encoder.block.0.layer.1.DenseReluDense.wi_0.weight": sd["wi_0.weight"],
        "encoder.block.0.layer.1.DenseReluDense.wi_1.weight": sd["wi_1.weight"],
        "encoder.block.0.layer.1.DenseReluDense.wo.weight": sd["wo.weight"],
        "encoder.block.0.layer.1.layer_norm.weight": sd["ln2"],
    }
    rules = [r for r in sd3_t5_rules(num_layers=1)
             if not r[0].startswith(("encoder.embed", "encoder.final"))]
    params = _to_jax_tree(rules, state)["block0"]
    cfg = T5Config(vocab_size=10, d_model=d_model, d_ff=d_ff, num_layers=1,
                   num_heads=heads)
    model = T5Block(cfg, has_relative_bias=True)
    got, _ = model.apply({"params": params}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4)


def test_mmdit_dismantled_block_parity():
    torch.manual_seed(3)
    hs, heads = 64, 2

    class TorchDismantled(nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(hs, 3 * hs)
            self.proj = nn.Linear(hs, hs)
            self.adaLN = nn.Linear(hs, 6 * hs)
            self.fc1 = nn.Linear(hs, 4 * hs)
            self.fc2 = nn.Linear(4 * hs, hs)

        def forward(self, x, c):
            mods = self.adaLN(F.silu(c)).chunk(6, dim=1)
            sh_msa, s_msa, g_msa, sh_mlp, s_mlp, g_mlp = mods
            h = F.layer_norm(x, (hs,), eps=1e-6)
            h = h * (1 + s_msa[:, None]) + sh_msa[:, None]
            b, l, _ = h.shape
            dh = hs // heads
            qkv = self.qkv(h).view(b, l, 3, heads, dh)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            att = F.scaled_dot_product_attention(q, k, v)
            att = att.transpose(1, 2).reshape(b, l, hs)
            x = x + g_msa[:, None] * self.proj(att)
            h = F.layer_norm(x, (hs,), eps=1e-6)
            h = h * (1 + s_mlp[:, None]) + sh_mlp[:, None]
            h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
            return x + g_mlp[:, None] * h

    tm = TorchDismantled().eval()
    x = torch.randn(2, 10, hs)
    c = torch.randn(2, hs)
    with torch.no_grad():
        want = tm(x, c).numpy()

    from from_ddpm_to_stable_diffusion_tpu.io.weights_sd3 import _dismantled_rules
    from from_ddpm_to_stable_diffusion_tpu.models.mmdit import DismantledBlock

    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    state = {
        "b.attn.qkv.weight": sd["qkv.weight"],
        "b.attn.qkv.bias": sd["qkv.bias"],
        "b.attn.proj.weight": sd["proj.weight"],
        "b.attn.proj.bias": sd["proj.bias"],
        "b.adaLN_modulation.1.weight": sd["adaLN.weight"],
        "b.adaLN_modulation.1.bias": sd["adaLN.bias"],
        "b.mlp.fc1.weight": sd["fc1.weight"],
        "b.mlp.fc1.bias": sd["fc1.bias"],
        "b.mlp.fc2.weight": sd["fc2.weight"],
        "b.mlp.fc2.bias": sd["fc2.bias"],
    }
    params = _to_jax_tree(_dismantled_rules("b", "", False, False), state)
    model = DismantledBlock(hs, heads, qkv_bias=True)
    got = model.apply({"params": params}, jnp.asarray(x.numpy()),
                      jnp.asarray(c.numpy()))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4)
