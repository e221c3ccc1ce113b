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
from torch_trainer_parity import assert_adamw_close, lr_bound
from from_ddpm_to_stable_diffusion_tpu_torch.parallel.sharding import (
    tp_roles, tp_slice)

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
