"""Mesh form (b), one shard per rank of a ``torch.distributed`` gloo group,
held against form (a), the one-process mesh of the host device repeated:
two spawns of CPU processes (``tests/torch_dist_worker.py``, which imports
no ``jax``), each rank on one torch thread, rendezvous through a FileStore
under ``tmp_path`` (no port), each spawn joined with its own timeout.

- 2 ranks: the flash ring (ragged, causal zig-zag) and the xla ring, forward
  and backward, Ulysses with ``kv_valid_len``, SwitchFFN over an ``expert``
  axis (output, aux, gradients), ``pipeline_apply`` and
  ``pipeline_value_and_grad`` over a ``stage`` axis: within 1e-5 of form
  (a) (the same operations per shard; the sums over shards may associate
  differently).
- 4 ranks: one ``MMDiTTrainer`` step of the ring MMDiT on {"data": 2,
  "seq": 2} and of the MoE MMDiT on {"data": 2, "expert": 2}: each rank's
  loss is its batch shard's, the gradients averaged over the data group, so
  the updated parameters equal form (a)'s step on the whole batch within
  the AdamW tolerance of ``torch_trainer_parity.assert_adamw_close`` and
  the loss within rtol 1e-5.
- 2 ranks, tensor parallelism (Megatron's conjugate pair: identity forward
  and all-reduce backward into a column layer, all-reduce forward and
  identity backward out of a row layer): the TP forward and backward of a
  depth-2 MMDiT and of an SD1UNet; the output within 1e-5 of form (a) on
  every rank, each rank's parameter gradients within 1e-5 x max(largest
  |gradient|, 0.1) of its slice of form (a)'s (the floor for the biases
  before a GroupNorm, whose gradients are rounding noise; replicated leaves
  whole: without the pair their gradients would be partial).
- 4 ranks, FSDP: one ``DDPMTrainer(fsdp=True)`` step on {"data": 4} and one
  hybrid FSDP x TP ``MMDiTTrainer`` step on {"data": 2, "model": 2}, each
  rank's stored slices against its slices of form (a)'s step (AdamW
  tolerance), the loss within rtol 1e-5.
- 2 ranks, data meshes: one ``fit`` step with ``checkpoint_dir`` of the
  VAE, ViT, CLIP and VLM trainers on {"data": 2}, on batches that make a
  per-rank shortcut fail (BatchNorm halves with different means, dropout,
  CLIP's global logits, the VLM's global token count); loss within rtol
  1e-5, parameters within the AdamW tolerance of form (a)'s, the BatchNorm
  running statistics within 1e-5; the first rank's checkpoint holds the
  ranks' state bit for bit.
- 4 ranks, TP x SP: one ring MMDiT step on {"seq": 2, "model": 2}, each
  rank one head shard whose ring runs over its seq group; the groups are
  the grid's columns and rows, each rank's slices of form (a)'s step within
  the AdamW tolerance, the loss within rtol 1e-5.
- 2 ranks, process-group checkpoints and LoRA: an FSDP DDPM ``fit`` whose
  checkpoint holds the ranks' slices joined, resumed through ``fit`` by a
  replicated data-parallel trainer against the meshless resume; a TP
  MMDiT ``fit`` whose checkpoint each rank's slices are cut from, restored
  meshless; one LoRA step under TP and one under FSDP against form (a).
"""

import multiprocessing as mp

import numpy as np
import torch

import torch_dist_worker as worker
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_value_and_grad)
from from_ddpm_to_stable_diffusion_tpu_torch.parallel.ring_attention import (
    ring_attention, ulysses_attention)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import assert_adamw_close, lr_bound, port_flat
from from_ddpm_to_stable_diffusion_tpu_torch.parallel.sharding import (
    tp_roles, tp_slice)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    restore_tree)
from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
    CheckpointManager)

JOIN_TIMEOUT_S = 120


def _spawn(case, tmp_path):
    """Run ``case`` on its ranks; their saved results, by rank."""
    world = worker.CASES[case][0]
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"{case}.store")
    procs = [ctx.Process(target=worker.run,
                         args=(r, case, store, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"{case} ranks exited {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(tmp_path / f"{case}_{r}.pt") for r in range(world)]


def _cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [torch.device("cpu")] * n)


def _one_process_primitives():
    """Form (a) of the worker's primitives case."""
    out = {}
    mesh = _cpu_mesh({"seq": worker.SEQ})
    q, k, v, cot = worker.ring_inputs()
    for name, kw in list(worker.RING_CASES.items()) + [("ulysses", None)]:
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        if kw is None:
            o = ulysses_attention(*xs, mesh, kv_valid_len=27)
        else:
            o = ring_attention(*xs, mesh, **kw)
        (o * cot).sum().backward()
        out[name] = [o.detach()] + [x.grad for x in xs]
    ffn, x = worker.switch_inputs()
    y, aux = ffn(x, mesh=_cpu_mesh({"expert": worker.SEQ}))
    ((y ** 2).sum() + 0.01 * aux).backward()
    out["switch"] = [y.detach(), aux.detach()] + [
        p.grad for p in ffn.parameters()]
    params, x, tgt = worker.pipeline_inputs()
    stage = _cpu_mesh({"stage": worker.SEQ})
    out["pipeline_apply"] = [pipeline_apply(worker.stage_fn, params, x,
                                            stage, 4)]
    loss, grads = pipeline_value_and_grad(
        worker.stage_fn, params, x, tgt,
        lambda y, t: torch.mean((y - t) ** 2), stage, 4)
    out["pipeline_grad"] = [loss, *grads]
    return out


# the dim each result is sharded on across ranks (None: whole on each)
SHARDED = {"ring_flash_ragged": 2, "ring_flash_causal": 2,
           "ring_xla_causal": 2, "ulysses": 2, "switch": None,
           "pipeline_apply": None, "pipeline_grad": "stage"}


def test_process_group_primitives_match_one_process(tmp_path):
    ranks = _spawn("primitives", tmp_path)
    want = _one_process_primitives()
    for name, dim in SHARDED.items():
        for j, w in enumerate(want[name]):
            parts = [r[name][j] for r in ranks]
            if dim == "stage":      # loss whole, grads one stage a rank
                got = parts[0] if j == 0 else torch.cat(parts, 0)
            elif dim is None:
                got = parts[0]
                for p in parts[1:]:
                    torch.testing.assert_close(p, got, rtol=0, atol=0)
            else:
                got = torch.cat(parts, dim)
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5,
                                       err_msg=f"{name}[{j}]")


def test_process_group_trainer_steps_match_one_process(tmp_path):
    ranks = _spawn("trainers", tmp_path)
    for kind, shape in worker.TRAINER_SHAPES.items():
        trainer, state, batch, draws = worker.trainer_setup(
            kind, _cpu_mesh(shape))
        state, loss = trainer.train_step(state, *batch, **draws)
        want = {n: p.detach().numpy() for n, p in state.params.items()}
        for r in ranks:
            np.testing.assert_allclose(r[kind]["loss"].item(), loss.item(),
                                       rtol=1e-5, err_msg=kind)
            assert_adamw_close({n: p.numpy() for n, p in
                                r[kind]["params"].items()}, want,
                               lr_bound(state.schedule, 1), kind)


def test_process_group_tp_forward_backward_match_one_process(tmp_path):
    ranks = _spawn("tp", tmp_path)
    mesh = _cpu_mesh({"model": worker.TP})
    for name, (model, args, cot) in worker.tp_models().items():
        roles = tp_roles(model, worker.TP)
        want = worker.tp_step(model, args, cot, mesh)
        for j, r in enumerate(ranks):
            got = r[name]
            np.testing.assert_allclose(got["out"].numpy(),
                                       want["out"].numpy(), atol=1e-5,
                                       err_msg=name)
            for n, g in want["grads"].items():
                if n in roles:
                    g = tp_slice(g, roles[n], j, worker.TP)
                np.testing.assert_allclose(
                    got["grads"][n].numpy(), g.numpy(),
                    atol=1e-5 * max(float(g.abs().max()), 0.1),
                    err_msg=f"{name} {n} rank {j}")


def test_process_group_fsdp_steps_match_one_process(tmp_path):
    ranks = _spawn("fsdp", tmp_path)
    for kind, shape in worker.FSDP_SHAPES.items():
        trainer, state, batch, draws = worker.fsdp_setup(kind,
                                                         _cpu_mesh(shape))
        roles = tp_roles(state.model, shape["model"]) if "model" in shape \
            else {}
        dims = state.layout.fsdp_dims
        assert any(d is not None for d in dims.values()), kind
        state, loss = trainer.train_step(state, *batch, **draws)
        for rank, r in enumerate(ranks):
            d, m = (list(np.unravel_index(rank, tuple(shape.values())))
                    + [0])[:2]
            want = {}
            for n, p in state.params.items():
                p = p.detach()
                if n in roles:
                    p = tp_slice(p, roles[n], m, shape["model"])
                if dims.get(n) is not None:
                    p = p.chunk(shape["data"], dims[n])[d]
                want[n] = p.numpy()
            np.testing.assert_allclose(r[kind]["loss"].item(), loss.item(),
                                       rtol=1e-5, err_msg=kind)
            assert_adamw_close({n: p.numpy() for n, p in
                                r[kind]["params"].items()}, want,
                               lr_bound(state.schedule, 1), kind)


def test_process_group_tp_sp_step_matches_one_process(tmp_path):
    """4 ranks on {"seq": 2, "model": 2}: the seq and model groups are the
    columns and rows of the 2 x 2 grid of ranks, and one ring MMDiT step
    under TP (each rank one head, its ring over its seq group) gives each
    rank its slices of form (a)'s step."""
    ranks = _spawn("tp_sp", tmp_path)
    shape = worker.TP_SP_SHAPE
    trainer, state, batch, draws = worker.trainer_setup("ring",
                                                        _cpu_mesh(shape))
    roles = tp_roles(state.model, shape["model"])
    state, loss = trainer.train_step(state, *batch, **draws)
    for rank, r in enumerate(ranks):
        s, m = np.unravel_index(rank, tuple(shape.values()))
        assert r["ranks"] == {"seq": [m, 2 + m], "model": [2 * s, 2 * s + 1]}
        want = {n: (tp_slice(p.detach(), roles[n], m, shape["model"])
                    if n in roles else p.detach()).numpy()
                for n, p in state.params.items()}
        np.testing.assert_allclose(r["loss"].item(), loss.item(), rtol=1e-5)
        assert_adamw_close({n: p.numpy() for n, p in r["params"].items()},
                           want, lr_bound(state.schedule, 1),
                           f"tp_sp rank {rank}")


def _numpy(tree):
    return {n: t.numpy() for n, t in tree.items()}


def _live(params):
    """The parameters without the key third of each fused qkv bias: it adds
    one constant to a query's every logit, so its gradient is analytically
    zero and rounding noise, which AdamW's first update turns into ±lr
    (held to that bound alone)."""
    out = {}
    for n, a in params.items():
        a = a.numpy()
        if n.endswith("qkv.bias"):
            c = a.shape[0] // 3
            a = np.concatenate([a[:c], a[2 * c:]])
        out[n] = a
    return out


def _first_moments(saved):
    return torch.cat([st["exp_avg"].flatten()
                      for st in saved["optimizer"]["state"].values()])


def test_process_group_data_meshes_match_one_process(tmp_path):
    """Each rank's loss, BatchNorm running statistics and parameters, and
    the whole gradient (the first AdamW moment in the checkpoints) against
    form (a)'s. The ViT and the VAE at their random init amplify rounding:
    the same batch of 4 split into halves in one process moves their
    gradients by 2.3e-3 and 1.2e-2 (rel L2), and AdamW's first update turns
    any sign a rounding flips into ±lr; so their parameters are held to the
    2 lr bound and their gradients to 3e-2, where a per-rank shortcut
    (per-rank statistics, masks or logits) moves them by far more. CLIP
    and the VLM agree to 1e-6 and are held to the AdamW tolerance (the key
    biases, see ``_live``, to the bound)."""
    ranks = _spawn("dp", tmp_path)
    setups = worker.dp_setups(_cpu_mesh({"data": worker.DP}))
    for name, (trainer, loader, kw) in setups.items():
        want = worker.dp_fit(name, trainer, loader, kw,
                             str(tmp_path / f"a_{name}"))
        saved, step = CheckpointManager(str(tmp_path / f"dp_{name}")
                                        ).restore()
        own, _ = CheckpointManager(str(tmp_path / f"a_{name}")).restore()
        assert step == 0, name
        g, g_want = _first_moments(saved), _first_moments(own)
        rel = float((g - g_want).norm() / g_want.norm())
        assert rel <= (3e-2 if name in ("vit", "vae") else 1e-6), (name, rel)
        for r in ranks:
            got = r[name]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                       err_msg=name)
            for n, w in want["params"].items():
                assert (got["params"][n] - w).abs().max() <= 2e-3 + 1e-6
            if name not in ("vit", "vae"):
                assert_adamw_close(_live(got["params"]),
                                   _live(want["params"]), 2e-3 + 1e-6, name)
            for n, b in want["buffers"].items():
                np.testing.assert_allclose(got["buffers"][n].numpy(),
                                           b.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {n}")
            for n, t in saved["params"].items():
                assert torch.equal(t, got["params"][n]), (name, n)
        if name == "vae":
            assert want["buffers"], name     # the running statistics


def test_process_group_checkpoints_and_lora_match_one_process(tmp_path):
    ranks = _spawn("pg", tmp_path)
    # the FSDP DDPM fit: its checkpoint is the ranks' slices joined, and
    # the form (a) fit within the AdamW tolerance
    trainer, state, loader = worker.pg_ddpm(_cpu_mesh({"data": worker.DP}))
    dims = state.layout.fsdp_dims
    assert any(d is not None for d in dims.values())
    state = trainer.fit(loader, state, epochs=1,
                        checkpoint_dir=str(tmp_path / "a_ddpm"))
    saved, step = CheckpointManager(str(tmp_path / "pg_ddpm")).restore()
    assert step == 0
    for n, t in saved["params"].items():
        parts = [r["ddpm_fsdp"][n] for r in ranks]
        whole = parts[0] if dims[n] is None else torch.cat(parts, dims[n])
        assert torch.equal(t, whole), n
    bound = lr_bound(state.schedule, 2)
    assert_adamw_close(_numpy(saved["params"]), port_flat(state.params),
                       bound, "ddpm fsdp")
    # resumed through fit by a replicated data-parallel trainer (form (b))
    # and by a meshless one, from the same file
    trainer, state, loader = worker.pg_ddpm(None, fsdp=False)
    state = trainer.fit(loader[:1], state, epochs=1,
                        checkpoint_dir=str(tmp_path / "pg_ddpm"))
    assert CheckpointManager(str(tmp_path / "pg_ddpm")).all_steps() == [0]
    assert state.updates == 3
    for r in ranks:
        np.testing.assert_allclose(r["ddpm_resumed_loss"],
                                   trainer.history[-1]["loss"], rtol=1e-5)
        assert_adamw_close(_numpy(r["ddpm_resumed"]),
                           port_flat(state.params),
                           lr_bound(state.schedule, 3), "ddpm resumed")
    # the TP MMDiT fit: each rank's slices cut from its checkpoint, which
    # restores meshless bit for bit and matches form (a)'s fit
    mesh = _cpu_mesh({"model": worker.DP})
    trainer, state = worker.pg_mmdit(mesh)
    roles = tp_roles(state.model, worker.DP)
    assert roles
    state = trainer.fit([worker.mmdit_batch()], state, epochs=1,
                        checkpoint_dir=str(tmp_path / "a_mmdit"))
    saved, step = CheckpointManager(str(tmp_path / "pg_mmdit")).restore()
    assert step == 0
    for j, r in enumerate(ranks):
        for n, t in saved["params"].items():
            part = tp_slice(t, roles[n], j, worker.DP) if n in roles else t
            assert torch.equal(part, r["mmdit_tp"][n]), (j, n)
    assert_adamw_close(_numpy(saved["params"]), port_flat(state.params),
                       lr_bound(state.schedule, 1), "mmdit tp")
    trainer, state = worker.pg_mmdit(None)
    restore_tree(state, trainer.generator, saved)
    for n, p in state.params.items():
        assert torch.equal(p.detach(), saved["params"][n]), n
    assert state.updates == 1 and len(state.optimizer.state) == len(
        saved["params"])
    # LoRA under TP and under FSDP, one step each against form (a)
    ddpm_trainer, ddpm_state, ddpm_loader = worker.pg_ddpm(
        _cpu_mesh({"data": worker.DP}), lora_rank=4)
    for key, (trainer, state), batch, draws in (
            ("lora_tp", worker.pg_mmdit(mesh, lora_rank=4),
             worker.mmdit_batch(), worker.MMDIT_DRAWS),
            ("lora_fsdp", (ddpm_trainer, ddpm_state), ddpm_loader[0],
             worker.DDPM_DRAWS)):
        assert state.lora is not None
        state, loss = trainer.train_step(state, *batch, **draws)
        for r in ranks:
            np.testing.assert_allclose(r[key]["loss"].item(), loss.item(),
                                       rtol=1e-5, err_msg=key)
            assert_adamw_close(_numpy(r[key]["params"]),
                               port_flat(state.params),
                               lr_bound(state.schedule, 1), key)
