"""Trainable VAE family of stage 03: VanillaVAE and VQ-VAE (port of
``models/vae.py``).

- :class:`VanillaVAE`: a stride-2 conv ladder (32, 64, 128, 256, 512) with
  BatchNorm and leaky ReLU, linear mu / log-variance heads, a
  reparameterised latent, a mirrored transposed-conv decoder with a tanh
  output; loss MSE + kld_weight · KLD.
- :class:`VQVAE`: a k4 s2 conv ladder (64, 128, 256) and six residual
  layers, the L2-nearest codebook entry with straight-through gradients,
  commitment β = 0.25, a mirrored decoder.

NHWC, as the JAX modules. Submodules are named after the Flax parameter
paths (``enc0.conv``, ``encoder.res3.conv1``, ``vq.codebook``, ...), and
the BatchNorm running statistics are buffers named after Flax's
``batch_stats`` leaves (``enc0.bn.mean``, ``enc0.bn.var``), so
:func:`..io.from_jax.load_jax_params` fills a model from a Flax tree and
its ``batch_stats``. ``dtype`` is the compute dtype of every conv and
linear over fp32 parameters; BatchNorm statistics and outputs are fp32.

Flax's ``train=`` argument is the module's mode here: ``model.train()``
normalises by the batch's statistics and updates the running ones,
``model.eval()`` uses the running ones. Every random draw takes a hook
(``eps=``, ``noise=``) or a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear


def _normal(shape, noise, generator, device):
    if noise is not None:
        return torch.as_tensor(noise, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, device=device)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of an NHWC tensor, in fp32:
    in training mode the batch's mean and biased variance (E[x²] − E[x]²,
    clamped at 0) normalise, and the running ones move as ``momentum · ra
    + (1 − momentum) · batch`` (torch's ``BatchNorm2d`` would use momentum
    0.1 and the unbiased variance); in eval mode the running ones
    normalise. With ``data_axis`` a process-group ``data`` axis (mesh form
    (b), set by the trainer) the statistics are the global batch's: each
    rank's sums gathered (``AxisComm.gather_batch``, so that the gradient
    reaches every rank's rows), as JAX's mean over a sharded batch is."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.data_axis = None

    def reset_running_stats(self) -> None:
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            data = self.data_axis
            if data is not None and data.distributed:
                sums = torch.stack([xf.sum(axes), (xf * xf).sum(axes)])
                moments = data.gather_batch(sums[None], 0).sum(0) / (
                    xf[..., 0].numel() * data.n)
                mean = moments[0]
                var = torch.clamp(moments[1] - mean * mean, min=0.0)
            else:
                mean = xf.mean(axes)
                var = torch.clamp((xf * xf).mean(axes) - mean * mean,
                                  min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


class ConvTranspose2d(Conv2d):
    """Flax ``nn.ConvTranspose(padding="SAME")`` on NHWC tensors, with an
    optional compute dtype. The weight is stored as a conv's, (out, in, kH,
    kW), the Flax kernel (kH, kW, in, out) transposed as every conv kernel
    is. Flax does not flip the kernel (``transpose_kernel=False``), so the
    call flips it and swaps in and out for ``conv_transpose2d``; and Flax
    pads the dilated input (pad_a, pad_b) = ``lax._conv_transpose_padding``,
    (2, 1) at k = 3 and (2, 2) at k = 4 for stride 2, which
    ``conv_transpose2d``'s symmetric ``padding`` cannot give at k = 3: it
    runs at the smaller of the two crops from the full (k − 1, k − 1) and
    crops the rest from the high side."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.crops = []
        for k, s in zip(self.kernel_size, self.stride):
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
            self.crops.append((k - 1 - pad_a, k - 1 - (pad_len - pad_a)))
        self.crop_pad = tuple(min(c) for c in self.crops)

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            x, w, b = (None if t is None else t.to(self.compute_dtype)
                       for t in (x, w, b))
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               w.flip(2, 3).transpose(0, 1), b, self.stride,
                               self.crop_pad)
        (lh, hh), (lw, hw) = ((lo - p, hi - p) for (lo, hi), p in
                              zip(self.crops, self.crop_pad))
        y = y[:, :, lh:y.shape[2] - hh, lw:y.shape[3] - hw]
        return y.permute(0, 2, 3, 1)


class _ConvBNAct(nn.Module):
    """Stride-2 'SAME' conv (or transposed conv) → BatchNorm → leaky ReLU
    (0.01); the output is fp32."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 2, transpose: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if transpose:
            self.conv = ConvTranspose2d(in_channels, features, kernel,
                                        stride=stride,
                                        compute_dtype=compute_dtype)
        else:
            self.conv = Conv2d(in_channels, features, kernel, stride=stride,
                               same=True, compute_dtype=compute_dtype)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.01)


def _compute(dtype):
    return None if dtype == torch.float32 else dtype


class VanillaVAE(nn.Module):
    def __init__(self, in_channels: int = 3, image_size: int = 64,
                 latent_dim: int = 128,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % 32:
            raise ValueError(f"image_size {image_size} is not a multiple "
                             "of 32")
        dims, dt = list(hidden_dims), _compute(dtype)
        self.dtype, self.latent_dim = dtype, latent_dim
        self.hidden_dims, self.scale = dims, image_size // 32
        cin = in_channels
        for i, hd in enumerate(dims):
            self.add_module(f"enc{i}", _ConvBNAct(cin, hd, compute_dtype=dt))
            cin = hd
        flat = dims[-1] * self.scale ** 2
        self.fc_mu = Linear(flat, latent_dim, compute_dtype=dt)
        self.fc_var = Linear(flat, latent_dim, compute_dtype=dt)
        rdims = dims[::-1]
        self.decoder_input = Linear(latent_dim, flat, compute_dtype=dt)
        for i in range(len(rdims) - 1):
            self.add_module(f"dec{i}", _ConvBNAct(
                rdims[i], rdims[i + 1], transpose=True, compute_dtype=dt))
        self.final_up = _ConvBNAct(rdims[-1], rdims[-1], transpose=True,
                                   compute_dtype=dt)
        self.final_conv = Conv2d(rdims[-1], in_channels, 3, padding=1,
                                 compute_dtype=dt)

    def forward(self, x, eps=None, generator: Optional[torch.Generator] = None):
        """(recon, mu, log_var) of images (B, H, W, C) in [−1, 1]."""
        z, mu, log_var = self.encode(x, eps, generator)
        return self.decode(z), mu, log_var

    def encode(self, x, eps=None, generator: Optional[torch.Generator] = None):
        """(z, mu, log_var), z = eps · exp(log_var / 2) + mu with eps (B,
        latent_dim) given or drawn from ``generator``."""
        h = x.to(self.dtype)
        for i in range(len(self.hidden_dims)):
            h = getattr(self, f"enc{i}")(h)
        h = h.reshape(h.shape[0], -1)
        mu = self.fc_mu(h).float()
        log_var = self.fc_var(h).float()
        std = torch.exp(0.5 * log_var)
        eps = _normal(std.shape, eps, generator, std.device)
        return (eps * std + mu).to(self.dtype), mu, log_var

    def decode(self, z):
        rdims = self.hidden_dims[::-1]
        h = self.decoder_input(z.to(self.dtype))
        h = h.reshape(-1, self.scale, self.scale, rdims[0])
        for i in range(len(rdims) - 1):
            h = getattr(self, f"dec{i}")(h)
        h = self.final_conv(self.final_up(h))
        return torch.tanh(h.float())

    def sample(self, num_samples: int, noise=None,
               generator: Optional[torch.Generator] = None):
        """Decodes ``num_samples`` draws of the N(0, I) latent prior
        (``noise``, or drawn from ``generator``)."""
        z = _normal((num_samples, self.latent_dim), noise, generator,
                    self.fc_mu.weight.device)
        return self.decode(z.to(self.dtype))

    def generate(self, x, eps=None,
                 generator: Optional[torch.Generator] = None):
        """The reconstruction of ``x``: ``forward()[0]``."""
        return self(x, eps, generator)[0]

    @staticmethod
    def loss(recon, x, mu, log_var, kld_weight: float):
        """MSE + kld_weight-weighted KLD."""
        recon_loss = torch.mean((recon - x) ** 2)
        kld = torch.mean(-0.5 * torch.sum(
            1 + log_var - mu ** 2 - torch.exp(log_var), dim=1))
        return {"loss": recon_loss + kld_weight * kld,
                "recon_loss": recon_loss, "kld": -kld}


class VectorQuantizer(nn.Module):
    """L2-nearest codebook entry with straight-through gradients. The
    distance is the expanded ‖z‖² + ‖e‖² − 2 z·eᵀ in fp32 (one (BHW, K)
    product) and ties go to the first index, as the JAX module computes
    them, so both pick the same entries."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 beta: float = 0.25):
        super().__init__()
        self.embedding_dim, self.beta = embedding_dim, beta
        bound = 1.0 / num_embeddings
        self.codebook = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim).uniform_(-bound,
                                                                bound))

    def forward(self, latents):
        """latents (B, H, W, D) -> (quantized, vq_loss, indices (B, H, W))."""
        flat = latents.reshape(-1, self.embedding_dim).float()
        cb = self.codebook.float()
        dist = (torch.sum(flat ** 2, dim=1, keepdim=True)
                + torch.sum(cb ** 2, dim=1)[None, :] - 2.0 * flat @ cb.T)
        idx = torch.argmin(dist, dim=1)
        quantized = cb[idx].reshape(latents.shape)
        lat32 = latents.float()
        commitment = torch.mean((quantized.detach() - lat32) ** 2)
        embedding = torch.mean((quantized - lat32.detach()) ** 2)
        vq_loss = self.beta * commitment + embedding
        quantized = lat32 + (quantized - lat32).detach()
        return (quantized.to(latents.dtype), vq_loss,
                idx.reshape(latents.shape[:-1]))


class _ResidualLayer(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = Conv2d(in_channels, features, 3, padding=1, bias=False,
                            compute_dtype=dt)
        self.conv2 = Conv2d(features, features, 1, bias=False,
                            compute_dtype=dt)
        self.skip = (Conv2d(in_channels, features, 1, compute_dtype=dt)
                     if in_channels != features else None)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        return h + (x if self.skip is None else self.skip(x))


class _VQEncoder(nn.Module):
    def __init__(self, hidden_dims: Sequence[int], embedding_dim: int,
                 in_channels: int = 3,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt, dims = compute_dtype, list(hidden_dims)
        self.n_down = len(dims)
        cin = in_channels
        for i, hd in enumerate(dims):
            self.add_module(f"down{i}", Conv2d(cin, hd, 4, stride=2,
                                               same=True, compute_dtype=dt))
            cin = hd
        self.conv = Conv2d(cin, cin, 3, padding=1, compute_dtype=dt)
        for i in range(6):
            self.add_module(f"res{i}", _ResidualLayer(cin, cin, dt))
        self.out = Conv2d(cin, embedding_dim, 1, compute_dtype=dt)

    def forward(self, x):
        h = x
        for i in range(self.n_down):
            h = F.leaky_relu(getattr(self, f"down{i}")(h), 0.01)
        h = F.leaky_relu(self.conv(h), 0.01)
        for i in range(6):
            h = getattr(self, f"res{i}")(h)
        h = self.out(F.leaky_relu(h, 0.01))
        return F.leaky_relu(h, 0.01)


class _VQDecoder(nn.Module):
    def __init__(self, hidden_dims: Sequence[int], out_channels: int,
                 embedding_dim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt, rdims = compute_dtype, list(hidden_dims)[::-1]
        self.n_up = len(rdims) - 1
        # "in" is the Flax name, a Python keyword: reached by getattr
        self.add_module("in", Conv2d(embedding_dim, rdims[0], 3, padding=1,
                                     compute_dtype=dt))
        for i in range(6):
            self.add_module(f"res{i}", _ResidualLayer(rdims[0], rdims[0], dt))
        for i in range(self.n_up):
            self.add_module(f"up{i}", ConvTranspose2d(
                rdims[i], rdims[i + 1], 4, stride=2, compute_dtype=dt))
        self.out = ConvTranspose2d(rdims[-1], out_channels, 4, stride=2,
                                   compute_dtype=dt)

    def forward(self, z):
        h = F.leaky_relu(getattr(self, "in")(z), 0.01)
        for i in range(6):
            h = getattr(self, f"res{i}")(h)
        h = F.leaky_relu(h, 0.01)
        for i in range(self.n_up):
            h = F.leaky_relu(getattr(self, f"up{i}")(h), 0.01)
        return torch.tanh(self.out(h).float())


class VQVAE(nn.Module):
    def __init__(self, in_channels: int = 3, embedding_dim: int = 4,
                 num_embeddings: int = 128,
                 hidden_dims: Sequence[int] = (64, 128, 256),
                 beta: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = _compute(dtype)
        self.dtype = dtype
        self.encoder = _VQEncoder(hidden_dims, embedding_dim, in_channels,
                                  dt)
        self.vq = VectorQuantizer(num_embeddings, embedding_dim, beta)
        self.decoder = _VQDecoder(hidden_dims, in_channels, embedding_dim,
                                  dt)

    def forward(self, x):
        """(recon, vq_loss, code indices) of images (B, H, W, C) in [−1, 1]."""
        quantized, vq_loss, idx = self.vq(self.encode(x))
        return self.decoder(quantized), vq_loss, idx

    def sample(self, num_samples: int, noise=None,
               generator: Optional[torch.Generator] = None):
        """There is no prior over the code indices, so there is nothing to
        sample from (the JAX module and the reference raise too)."""
        raise NotImplementedError("VQVAE sampler is not implemented")

    def generate(self, x):
        """The reconstruction of ``x``: ``forward()[0]``."""
        return self(x)[0]

    def encode(self, x):
        """Continuous (pre-quantization) latents (B, H/8, W/8, D)."""
        return self.encoder(x.to(self.dtype))

    def quantize(self, z):
        return self.vq(z)

    def decode(self, z):
        return self.decoder(z.to(self.dtype))

    @staticmethod
    def loss(recon, x, vq_loss):
        recon_loss = torch.mean((recon - x) ** 2)
        return {"loss": recon_loss + vq_loss, "recon_loss": recon_loss,
                "vq_loss": vq_loss}
