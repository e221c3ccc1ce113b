"""The ranks of the port's process-group tests (mesh form (b)): each runs a
case on its shard over gloo and saves what it computed, for
``tests/test_torch_parallel_dist.py`` to hold against the one-process mesh
(form (a)). Imports no ``jax``: the children start with the port alone."""

import os

import numpy as np
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    build_mesh, init_multihost)

SEQ = 2   # ranks of the first case


def inputs(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def ring_inputs():
    """q, k, v (1, 4, 32, 16) and a cotangent, whole."""
    return [inputs(s, 1, 4, 32, 16) for s in range(4)]


RING_CASES = {"ring_flash_ragged": dict(impl="flash", kv_valid_len=27),
              "ring_flash_causal": dict(impl="flash", causal=True),
              "ring_xla_causal": dict(impl="xla", causal=True)}


def switch_inputs():
    x = inputs(7, 2, 8, 16)
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.expert import (
        SwitchFFN)
    ffn = SwitchFFN(16, 4, hidden_mult=2, capacity_factor=1.0)
    with torch.no_grad():
        for i, p in enumerate(ffn.parameters()):
            p.copy_(inputs(20 + i, *p.shape) * 0.3)
    return ffn, x


def pipeline_inputs():
    w, b = inputs(30, SEQ, 8, 8) * 0.3, inputs(31, SEQ, 8) * 0.1
    return (w, b), inputs(32, 8, 8), inputs(33, 8, 8)


def stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _primitives(rank):
    """Ring (flash and xla, forward and backward), Ulysses, SwitchFFN over
    an expert axis and both pipeline schedules on a 2-rank mesh."""
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_value_and_grad)
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.ring_attention \
        import ring_attention, ulysses_attention

    out = {}
    mesh = build_mesh({"seq": SEQ})
    assert mesh.distributed and mesh.comm("seq").index == [rank]
    q, k, v, cot = ring_inputs()
    local = lambda t: t.chunk(SEQ, 2)[rank].clone()
    for name, kw in list(RING_CASES.items()) + [("ulysses", None)]:
        xs = [local(t).requires_grad_() for t in (q, k, v)]
        if kw is None:
            o = ulysses_attention(*xs, mesh, kv_valid_len=27)
        else:
            o = ring_attention(*xs, mesh, **kw)
        (o * local(cot)).sum().backward()
        out[name] = [o.detach()] + [x.grad for x in xs]
    ffn, x = switch_inputs()
    y, aux = ffn(x, mesh=build_mesh({"expert": SEQ}))
    ((y ** 2).sum() + 0.01 * aux).backward()
    out["switch"] = [y.detach(), aux.detach()] + [
        p.grad for p in ffn.parameters()]
    params, x, tgt = pipeline_inputs()
    stage = build_mesh({"stage": SEQ})
    mine = tuple(p[rank:rank + 1] for p in params)
    out["pipeline_apply"] = [pipeline_apply(stage_fn, mine, x, stage, 4)]
    loss, grads = pipeline_value_and_grad(
        stage_fn, mine, x, tgt, lambda y, t: torch.mean((y - t) ** 2), stage,
        4)
    out["pipeline_grad"] = [loss, *grads]
    return out


TRAINER_SHAPES = {"ring": {"data": 2, "seq": 2},
                  "moe": {"data": 2, "expert": 2}}


def trainer_setup(kind, mesh, device="cpu", fsdp=False):
    """A tiny MMDiTTrainer (ring over seq, 4 experts, or for ``kind`` None
    the flash MMDiT) on ``mesh``, its state from seed 0, a batch of 4 and
    the draws of one step."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import (
        MMDiTConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer \
        import MMDiTTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)

    extra = {"ring": dict(attention_impl="ring"),
             "moe": dict(moe_experts=4)}.get(kind, {})
    mc = MMDiTConfig(patch_size=2, in_channels=4, depth=2, adm_in_channels=8,
                     context_dim=16, pos_embed_max_size=8, **extra)
    cfg = FlowTrainConfig(epoch=1, batch_size=4, img_size=8, context_len=4,
                          lr=1e-4, max_lr=1e-3, warmup_epochs=1,
                          train_rand=0.3, dtype="fp32", seed=0)
    trainer = MMDiTTrainer(mc, cfg, device=device, mesh=mesh, fsdp=fsdp)
    state = trainer.create_state(steps_per_epoch=2)
    batch = [inputs(40, 4, 8, 8, 4), inputs(41, 4, 4, 16), inputs(42, 4, 8)]
    draws = dict(t_lin=torch.sigmoid(inputs(43, 4)),
                 noise=inputs(44, 4, 8, 8, 4),
                 drop=torch.tensor([False, True, False, False]))
    return trainer, state, batch, draws


def _trainers(rank):
    out = {}
    for kind, shape in TRAINER_SHAPES.items():
        trainer, state, batch, draws = trainer_setup(kind, build_mesh(shape))
        state, loss = trainer.train_step(state, *batch, **draws)
        out[kind] = dict(loss=loss, params={
            n: p.detach().clone() for n, p in state.params.items()})
    return out


TP = 2   # ranks of the tensor-parallel case


def tp_models():
    """A depth-2 MMDiT (2 heads) and an SD1UNet (64 channels: two a
    GroupNorm group, so that no gradient is only rounding noise; 4 heads),
    fp32, filled
    from seeds, each with an input set and an output cotangent."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import (
        MMDiT, MMDiTConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd1 import SD1UNet

    mmdit = MMDiT(MMDiTConfig(patch_size=2, in_channels=4, depth=2,
                              adm_in_channels=8, context_dim=16,
                              pos_embed_max_size=8))
    unet = SD1UNet(model_channels=64, context_dim=16, num_heads=4)
    out = {}
    for name, m, args, out_shape in (
            ("mmdit", mmdit, [inputs(50, 2, 8, 8, 4),
                              torch.tensor([100.0, 700.0]),
                              inputs(51, 2, 8), inputs(52, 2, 5, 16)],
             (2, 8, 8, 4)),
            ("unet", unet, [inputs(53, 2, 8, 8, 4), inputs(54, 2, 7, 16),
                            inputs(55, 2, 320)], (2, 8, 8, 4))):
        with torch.no_grad():
            for i, p in enumerate(m.parameters()):
                p.copy_(inputs(100 + i, *p.shape) * 0.2)
        out[name] = (m, args, inputs(60, *out_shape))
    return out


def tp_step(model, args, cot, mesh):
    """The TP forward over ``mesh``'s model axis and the backward of
    (out * cot).sum(): the output and each parameter's gradient (the
    rank's slice in form (b))."""
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.sharding import (
        apply_tp)

    apply_tp(model, mesh)
    out = model(*args)
    (out * cot).sum().backward()
    return dict(out=out.detach(), grads={
        n: p.grad.clone() for n, p in model.named_parameters()})


def _tp(rank):
    mesh = build_mesh({"model": TP})
    return {name: tp_step(m, args, cot, mesh)
            for name, (m, args, cot) in tp_models().items()}


FSDP_SHAPES = {"ddpm": {"data": 4}, "hybrid": {"data": 2, "model": 2}}


def fsdp_setup(kind, mesh, device="cpu"):
    """An FSDP DDPMTrainer (TinyUNet at 16^2, batch 8) or a hybrid FSDP x
    TP MMDiTTrainer (depth 2, batch 4) on ``mesh``, its state from seed 0,
    a batch and the draws of one step."""
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer \
        import DDPMTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    if kind == "hybrid":
        trainer, state, batch, draws = trainer_setup(None, mesh, device,
                                                     fsdp=True)
        return trainer, state, batch, draws
    cfg = TinySDConfig(epoch=2, batch_size=8, img_size=16, img_channel=3,
                       num_class=3, T=10, channel=32,
                       channel_multy=[1, 2, 2, 2], dropout=0.0, lr=1e-4,
                       max_lr=1e-3, warmup_epochs=1, train_rand=0.1,
                       dtype="fp32", seed=0)
    trainer = DDPMTrainer(cfg, device=device, mesh=mesh, fsdp=True)
    state = trainer.create_state(steps_per_epoch=4)
    batch = [inputs(70, 8, 16, 16, 3).clamp(-1, 1),
             torch.arange(8) % 3]
    draws = dict(drop=torch.tensor([False, True] + [False] * 6),
                 t=torch.arange(8) % 10, noise=inputs(71, 8, 16, 16, 3))
    return trainer, state, batch, draws


def _fsdp(rank):
    out = {}
    for kind, shape in FSDP_SHAPES.items():
        trainer, state, batch, draws = fsdp_setup(kind, build_mesh(shape))
        state, loss = trainer.train_step(state, *batch, **draws)
        out[kind] = dict(loss=loss, params={
            n: p.detach().clone() for n, p in state.params.items()})
    return out


TP_SP_SHAPE = {"seq": 2, "model": 2}   # the ring over seq on a head shard


def _tp_sp(rank):
    """One ring MMDiT step with TP on {"seq": 2, "model": 2}: each rank holds
    one head of two and runs its ring over its seq group; the axes'
    process groups come back too."""
    mesh = build_mesh(TP_SP_SHAPE)
    trainer, state, batch, draws = trainer_setup("ring", mesh)
    state, loss = trainer.train_step(state, *batch, **draws)
    return dict(loss=loss, params={n: p.detach().clone()
                                   for n, p in state.params.items()},
                ranks={a: mesh.comm(a).ranks for a in TP_SP_SHAPE})


DP = 2   # ranks of the data-mesh and process-group checkpoint cases


def dp_setups(mesh, device="cpu"):
    """The VAE, ViT, CLIP and VLM trainers on ``mesh`` (states from their
    seeds) with a loader of one whole batch each and ``fit``'s keywords. The
    batches make a per-rank shortcut fail: the VAE's halves have different
    BatchNorm means, CLIP's halves different features, the VLM's halves
    different numbers of unpadded targets, and the ViT draws dropout."""
    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset, VLM_VOCAB)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.clip import CLIP
    from from_ddpm_to_stable_diffusion_tpu_torch.models.siglip import (
        SiglipVisionConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer \
        import CLIPTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vae_trainer \
        import VAETrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vit_trainer \
        import ViTTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vlm_trainer \
        import VLMTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        VAETrainConfig, ViTTrainConfig)

    vae_x = inputs(80, 4, 32, 32, 3) * 0.5
    vae_x[2:] += 1.0
    vit = ViTTrainConfig(epoch=1, batch_size=4, img_size=32, patch_size=8,
                         dim=64, depth=2, heads=4, mlp_dim=128, num_class=3,
                         dropout=0.1, emb_dropout=0.1, lr=1e-3, seed=0)
    clip = CLIP(embed_dim=16, image_resolution=28, vision_layers=2,
                vision_width=32, vision_patch_size=14, context_length=10,
                vocab_size=50, transformer_width=16, transformer_heads=2,
                transformer_layers=2)
    tokens = torch.randint(1, 49, (4, 10),
                           generator=torch.Generator().manual_seed(81))
    tokens[:, 6] = 49                       # the EOS, the highest id
    ds = CaptionedShapesDataset(64, img_size=32, seed=0)
    images, caps = zip(*(ds.load(i) for i in range(4)))
    caps = torch.as_tensor(np.stack(caps)).long()
    caps[2:, 4:] = 0                        # rank 1 holds fewer targets
    vision = SiglipVisionConfig(hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=2,
                                image_size=32, patch_size=8)
    return {
        "vae": (VAETrainer(VAETrainConfig(model="vanilla", batch_size=4,
                                          img_size=32, latent_dim=16,
                                          lr=1e-3), device=device, mesh=mesh),
                [vae_x], {}),
        "vit": (ViTTrainer(vit, device=device, mesh=mesh),
                [(inputs(82, 4, 32, 32, 3), torch.tensor([0, 1, 2, 0]))],
                {}),
        "clip": (CLIPTrainer(clip, lr=1e-3, mesh=mesh, device=device),
                 [(inputs(83, 4, 28, 28, 3), tokens)],
                 dict(image_shape=(28, 28, 3), text_len=10)),
        "vlm": (VLMTrainer(len(VLM_VOCAB), dim=64, depth=2, num_heads=2,
                           max_text_len=8, vision_cfg=vision, lr=1e-3,
                           warmup_steps=0, total_steps=6, device=device,
                           mesh=mesh),
                [(torch.as_tensor(np.stack(images)), caps)],
                dict(image_size=32)),
    }


def dp_fit(name, trainer, loader, kw, ckpt_dir):
    """One ``fit`` epoch of one step with ``checkpoint_dir``: the state's
    parameters, buffers and the epoch's loss."""
    torch.manual_seed(0)          # the ViT's dropout draws
    state = trainer.fit(loader, epochs=1, checkpoint_dir=ckpt_dir, **kw)
    return dict(loss=trainer.history[-1]["loss"],
                params={n: p.detach().clone()
                        for n, p in state.params.items()},
                buffers={n: b.clone()
                         for n, b in state.model.named_buffers()})


def _dp(rank, out_dir):
    return {name: dp_fit(name, *setup, os.path.join(out_dir, f"dp_{name}"))
            for name, setup in dp_setups(build_mesh({"data": DP})).items()}


def pg_ddpm(mesh, fsdp=True, lora_rank=None, device="cpu"):
    """An FSDP DDPMTrainer (TinyUNet at 16^2, batch 8) on ``mesh``, its state
    from seed 0, and a loader of two batches with their draws."""
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer \
        import DDPMTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    cfg = TinySDConfig(epoch=1, batch_size=8, img_size=16, img_channel=3,
                       num_class=3, T=10, channel=32,
                       channel_multy=[1, 2, 2, 2], dropout=0.0, lr=1e-4,
                       max_lr=1e-3, warmup_epochs=1, train_rand=0.1,
                       dtype="fp32", seed=0)
    trainer = DDPMTrainer(cfg, device=device, mesh=mesh, fsdp=fsdp,
                          lora_rank=lora_rank)
    loader = [(inputs(90 + i, 8, 16, 16, 3).clamp(-1, 1), torch.arange(8) % 3)
              for i in range(2)]
    return trainer, trainer.create_state(steps_per_epoch=2), loader


def pg_mmdit(mesh, lora_rank=None, device="cpu"):
    """The tiny MMDiTTrainer of :func:`trainer_setup` on ``mesh``, with
    ``lora_rank`` adapters."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import (
        MMDiTConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer \
        import MMDiTTrainer
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)

    mc = MMDiTConfig(patch_size=2, in_channels=4, depth=2, adm_in_channels=8,
                     context_dim=16, pos_embed_max_size=8)
    cfg = FlowTrainConfig(epoch=1, batch_size=4, img_size=8, context_len=4,
                          lr=1e-4, max_lr=1e-3, warmup_epochs=1,
                          train_rand=0.3, dtype="fp32", seed=0)
    trainer = MMDiTTrainer(mc, cfg, device=device, mesh=mesh,
                           lora_rank=lora_rank)
    return trainer, trainer.create_state(steps_per_epoch=1)


def mmdit_batch():
    return [inputs(40, 4, 8, 8, 4), inputs(41, 4, 4, 16), inputs(42, 4, 8)]


def _trained(trainer, state):
    """What trains (the adapters under LoRA), flat and detached."""
    return {n: p.detach().clone() for n, p in state.trainable().items()}


def _pg(rank, out_dir):
    """Process-group checkpoints and LoRA: an FSDP DDPM ``fit`` that saves,
    then a DDPM trainer with another layout (replicated) resuming it
    through ``fit`` for one step; a TP MMDiT ``fit`` that saves; one LoRA step under TP
    (MMDiT on {"model": 2}) and one under FSDP (DDPM on {"data": 2})."""
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer \
        import DDPMTrainer

    out = {}
    data, model = build_mesh({"data": DP}), build_mesh({"model": DP})
    ddpm_dir = os.path.join(out_dir, "pg_ddpm")
    trainer, state, loader = pg_ddpm(data)
    state = trainer.fit(loader, state, epochs=1, checkpoint_dir=ddpm_dir)
    out["ddpm_fsdp"] = _trained(trainer, state)
    trainer = DDPMTrainer(trainer.cfg, device="cpu", mesh=data, fsdp=False)
    state = trainer.fit(loader[:1], trainer.create_state(2), epochs=1,
                        checkpoint_dir=ddpm_dir)
    out["ddpm_resumed"] = _trained(trainer, state)
    out["ddpm_resumed_loss"] = trainer.history[-1]["loss"]
    trainer, state = pg_mmdit(model)
    state = trainer.fit([mmdit_batch()], state, epochs=1,
                        checkpoint_dir=os.path.join(out_dir, "pg_mmdit"))
    out["mmdit_tp"] = _trained(trainer, state)
    trainer, state = pg_mmdit(model, lora_rank=4)
    state, loss = trainer.train_step(state, *mmdit_batch(), **MMDIT_DRAWS)
    out["lora_tp"] = dict(loss=loss, params=_trained(trainer, state))
    trainer, state, loader = pg_ddpm(data, lora_rank=4)
    state, loss = trainer.train_step(state, *loader[0], **DDPM_DRAWS)
    out["lora_fsdp"] = dict(loss=loss, params=_trained(trainer, state))
    return out


MMDIT_DRAWS = dict(t_lin=torch.sigmoid(inputs(43, 4)),
                   noise=inputs(44, 4, 8, 8, 4),
                   drop=torch.tensor([False, True, False, False]))
DDPM_DRAWS = dict(drop=torch.tensor([False, True] + [False] * 6),
                  t=torch.arange(8) % 10, noise=inputs(71, 8, 16, 16, 3))


CASES = {"primitives": (SEQ, _primitives), "trainers": (4, _trainers),
         "tp": (TP, _tp), "fsdp": (4, _fsdp), "dp": (DP, _dp),
         "pg": (DP, _pg), "tp_sp": (4, _tp_sp)}


def run(rank: int, case: str, store_path: str, out_dir: str) -> None:
    """One rank of ``case``: joins the group through a FileStore, runs the
    case, saves its results as ``{case}_{rank}.pt`` in ``out_dir``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    world, fn = CASES[case]
    store = dist.FileStore(store_path, world)
    init_multihost(num_processes=world, process_id=rank, backend="gloo",
                   store=store)
    try:
        got = fn(rank, out_dir) if case in ("dp", "pg") else fn(rank)
        torch.save(got, os.path.join(out_dir, f"{case}_{rank}.pt"))
    finally:
        dist.destroy_process_group()
