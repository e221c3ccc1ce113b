"""K2's launch plan, on the CPU.

The GroupNorm kernel (``csrc/groupnorm.cu``) runs one cooperative launch
whose grid, rows per block, pieces and shared-memory slots the host decides
(``ops/groupnorm.py: group_norm_plan``). Here the plan is walked the way the
kernel walks it, for every GroupNorm that the port's models reach at their
operating points (found by running them on the meta device, where nothing
is computed): every row is visited exactly once, a block's shared memory
stays within the H100's 227 KB, one block per SM holds the whole grid at
once (the cooperative launch's condition), and the SD1 UNet's GroupNorms at
512^2 with CFG batch 2 keep their rows in shared memory, reading x once.
The kernel itself is tested on the card (``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.models.sd1 import (
    SD1UNet, VAEDecoder, VAEEncoder)
from from_ddpm_to_stable_diffusion_tpu_torch.models.sd3_vae import (
    SD3VAEDecoder, SD3VAEEncoder)
from from_ddpm_to_stable_diffusion_tpu_torch.models.sd3_vae_tiled import (
    tiled_decode)
from from_ddpm_to_stable_diffusion_tpu_torch.models.tiny_unet import TinyUNet
from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as tgn
from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import TinySDConfig

H100_SMS = 132


def check_group_norm_plan(plan, b, hw, c, groups, itemsize, n_sm=H100_SMS):
    """The plan's conditions, with the kernel's piece walk replayed: block
    ``blk`` owns units blk, blk + grid, ... of (batch, chunk), each loaded in
    pieces of ``rows_per_piece`` rows."""
    vec = 16 // itemsize
    assert plan.threads % (c // vec) == 0 and plan.threads % 32 == 0
    assert plan.threads <= 1024
    rows_par = plan.threads // (c // vec)
    assert 1 <= plan.grid <= n_sm
    rpc, rpp = plan.rows_per_chunk, plan.rows_per_piece
    assert rpp % rows_par == 0
    ppu = -(-rpc // rpp)
    units = b * plan.chunks
    assert plan.chunks * rpc >= hw > (plan.chunks - 1) * rpc
    assert (plan.units_per_block - 1) * plan.grid < units \
        <= plan.units_per_block * plan.grid
    # the slots: every piece of a block has its own when resident
    if plan.resident:
        assert plan.stages == plan.units_per_block * ppu <= 32
    else:
        assert 1 <= plan.stages <= 6 and plan.stages < (
            plan.units_per_block * ppu)
    up16 = lambda n: (n + 15) & ~15
    assert plan.smem == (up16(8 * plan.stages) + up16(8 * groups)
                         + 2 * up16(8 * c) + 2 * up16(4 * plan.threads * vec)
                         + plan.stages * rpp * c * itemsize)
    assert plan.smem <= tgn.GN_SMEM == 232448
    seen = np.zeros((b, hw), np.int64)
    for blk in range(plan.grid):
        owned = [u for u in range(blk, units, plan.grid)]
        assert 1 <= len(owned) <= plan.units_per_block
        for u in owned:
            bb, chunk = divmod(u, plan.chunks)
            for j in range(ppu):
                first = chunk * rpc + j * rpp
                end = min(hw, (chunk + 1) * rpc, first + rpp)
                if end > first:
                    seen[bb, first:end] += 1
    assert (seen == 1).all()


def _group_norms(build, *shapes):
    """The input shape of each GroupNorm one forward of ``build()`` runs, on
    the meta device, on inputs of ``shapes``: (shape, dtype) pairs."""
    seen = []

    def record(x, num_groups, scale, bias, eps=1e-5, act=None):
        assert num_groups == 32
        seen.append(tuple(x.shape))
        return torch.empty_like(x)

    saved = tgn.group_norm_forward
    tgn.group_norm_forward = record
    try:
        with torch.device("meta"), torch.no_grad():
            build()(*(torch.empty(s, dtype=dt) for s, dt in shapes))
    finally:
        tgn.group_norm_forward = saved
    return seen


def _models(dtype):
    """name -> the input shapes of the GroupNorms of one forward at the
    operating points: the SD1 UNet at 512^2 with CFG batch 2 (64^2 latents), the SD1
    VAE at 512^2, the SD3 VAE decoder at 1024^2, the SD3 VAE encoder on a
    1024^2 image, the tiled decode's head at batch 2 (1024^2; its ladder
    runs no GroupNorm kernel), the tiny-SD UNet at ``TinySDConfig()``."""
    cfg = TinySDConfig()
    meta = lambda *s, dt=dtype: (s, dt)
    return {
        "SD1 UNet": _group_norms(lambda: SD1UNet().to(dtype),
                                 meta(2, 64, 64, 4), meta(2, 77, 768),
                                 meta(2, 320)),
        "SD1 VAE decoder": _group_norms(lambda: VAEDecoder().to(dtype),
                                        meta(1, 64, 64, 4)),
        "SD1 VAE encoder": _group_norms(lambda: VAEEncoder().to(dtype),
                                        meta(1, 512, 512, 3),
                                        meta(1, 64, 64, 4)),
        "SD3 VAE decoder": _group_norms(lambda: SD3VAEDecoder().to(dtype),
                                        meta(1, 128, 128, 16)),
        "SD3 VAE encoder": _group_norms(lambda: SD3VAEEncoder().to(dtype),
                                        meta(1, 1024, 1024, 3)),
        "SD3 tiled head": _group_norms(
            lambda: lambda z: tiled_decode(SD3VAEDecoder().to(dtype), z),
            meta(2, 128, 128, 16)),
        "tiny-SD UNet": _group_norms(
            lambda: TinyUNet(out_channels=cfg.img_channel,
                             base_channels=cfg.channel,
                             channel_mult=tuple(cfg.channel_multy),
                             num_classes=cfg.num_class, dtype=dtype),
            meta(cfg.batch_size, cfg.img_size, cfg.img_size,
                 cfg.img_channel),
            meta(cfg.batch_size, dt=torch.long),
            meta(cfg.batch_size, dt=torch.long)),
    }


# GroupNorms per forward: chip_smoke.py counts K2's launches with these
WANT_COUNTS = {"SD1 UNet": 61, "SD1 VAE decoder": 30, "SD1 VAE encoder": 22,
               "SD3 VAE decoder": 30, "SD3 VAE encoder": 22,
               "SD3 tiled head": 5, "tiny-SD UNet": 39}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_group_norm_plan_covers_every_model_group_norm(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    for name, seen in _models(dtype).items():
        assert len(seen) == WANT_COUNTS[name], name
        for shape in sorted(set(seen)):
            b, c = shape[0], shape[-1]
            hw = int(np.prod(shape[1:-1]))
            plan = tgn.group_norm_plan(b, hw, c, 32, itemsize, H100_SMS)
            check_group_norm_plan(plan, b, hw, c, 32, itemsize)
            if name == "SD1 UNet" and dtype == torch.bfloat16:
                assert plan.resident, (name, shape)


@pytest.mark.parametrize("n_sm", [114, 132, 144])
def test_group_norm_plan_follows_the_sm_count(n_sm):
    """One block per SM at most, whatever the card's SM count."""
    for b, hw, c in ((1, 4096, 320), (2, 4096, 320), (3, 1000, 640),
                     (200, 64, 128), (1000, 64, 128), (1, 262144, 128)):
        for itemsize in (2, 4):
            plan = tgn.group_norm_plan(b, hw, c, 32, itemsize, n_sm)
            check_group_norm_plan(plan, b, hw, c, 32, itemsize, n_sm)


@pytest.mark.parametrize("c,itemsize", [(324, 2), (322, 4), (7, 2)])
def test_group_norm_plan_refuses_channels_off_the_vector(c, itemsize):
    with pytest.raises(ValueError, match="multiple"):
        tgn.group_norm_plan(2, 64, c, 1, itemsize)


def test_group_norm_plan_refuses_rows_wider_than_a_block():
    # 16384 bf16 channels: 2048 vectors a row, more than 1024 threads
    with pytest.raises(ValueError, match="threads"):
        tgn.group_norm_plan(1, 64, 16384, 32, 2)
    # 1000 vectors a row: a block of lcm(1000, 32) = 4000 threads
    with pytest.raises(ValueError, match="threads"):
        tgn.group_norm_plan(1, 64, 8000, 32, 2)
