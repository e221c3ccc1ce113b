"""``SD1Generator(loop="trajectory")`` of the port against the JAX
generator's trajectory loop (one jitted ``lax.scan`` over the denoise loop)
and against the port's own step loop, on the CPU.

On the CPU the port's trajectory runs the loop of its ``Trajectory`` on
static buffers without a graph (the capture is the card's), so it must equal
the step loop bit for bit: the same operations on the same values. Against
JAX it is held as ``tests/test_sd1.py::test_sd1_generator_trajectory_loop``
holds the JAX trajectory against the JAX step loop: 64x64, 4 steps, uint8
within 1 level, the JAX draws fed through ``noise=`` / ``step_noise=``.
"""

import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.pipelines import sd1 as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe
from tests.test_torch_sd1_full import (H, STEPS, W, _images,  # noqa: F401
                                       _jax_draws, bundle)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

KW = dict(n_inference_steps=STEPS, height=H, width=W)


@pytest.mark.parametrize("sampler", ["k_lms", "k_euler_ancestral"])
def test_trajectory_matches_the_jax_trajectory(bundle, sampler):
    seed, prompts = 3, ["a cat"]
    want = jpipe.SD1Generator(bundle.jax, sampler=sampler,
                              loop="trajectory", **KW)(prompts, seed=seed)
    gen = tpipe.SD1Generator(bundle.torch, sampler=sampler,
                             loop="trajectory", **KW)
    got = gen(prompts, **_jax_draws(seed, 1))
    assert got.shape == want.shape == (1, H, W, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert want.std() > 0


@pytest.mark.parametrize("sampler", ["k_lms", "k_euler_ancestral",
                                     "dpmpp_2m"])
def test_trajectory_equals_the_step_loop(bundle, sampler):
    """Bit for bit, with the port's own draws (the ancestral step noise
    staged from the generator in the step loop's order), at batch 1 and 2,
    and for img2img (a second key: start_step 2); a key's buffers are
    reused by the next request."""
    steps = tpipe.SD1Generator(bundle.torch, sampler=sampler, **KW)
    traj = tpipe.SD1Generator(bundle.torch, sampler=sampler,
                              loop="trajectory", **KW)
    calls = [(["a"], dict(seed=7)), (["a", "b"], dict(seed=8)),
             (["a"], dict(seed=9)),
             (["a"], dict(seed=7, input_images=_images(60, 1),
                          strength=0.5))]
    for prompts, call in calls:
        want = steps._run(prompts, None, call.get("seed"),
                          call.get("input_images"), call.get("strength", 0.8),
                          None, None, None, None, True)
        got = traj._run(prompts, None, call.get("seed"),
                        call.get("input_images"), call.get("strength", 0.8),
                        None, None, None, None, True)
        assert torch.equal(got, want), (sampler, call)
    assert set(traj.trajectories) == {(1, 0), (2, 0), (1, 2)}


def test_trajectory_over_a_model_mesh_equals_its_step_loop(bundle):
    """TP over {"model": 2} of the host device repeated (form (a)): the
    trajectory runs the sharded UNet as the step loop does."""
    mesh = build_mesh({"model": 2}, [torch.device("cpu")] * 2)
    models = tpipe.SD1Models.from_jax(bundle.jax.params, device="cpu",
                                      clip_heads=4, unet_heads=4)
    steps = tpipe.SD1Generator(models, mesh=mesh, **KW)
    traj = tpipe.SD1Generator(models, mesh=mesh, loop="trajectory", **KW)
    np.testing.assert_array_equal(traj(["a"], seed=2), steps(["a"], seed=2))


def test_capture_collects_first_and_keeps_the_collector_off(monkeypatch):
    """A CUDAGraph that the collector frees during another capture (an
    earlier generator's, held in a reference cycle) invalidates that
    capture: ``Trajectory._capture`` collects the cycles first and keeps the
    collector off until the capture has ended. Checked with the capture
    API stubbed (no card here): the cycle is gone before the capture
    begins, the collector is off inside it and on again after, also when
    the capture raises."""
    import gc
    import weakref
    from contextlib import contextmanager

    class Cycle:
        def __init__(self):
            self.me = self

    seen = {}

    @contextmanager
    def graph(g, stream=None):
        seen["enabled"] = gc.isenabled()
        seen["cycle"] = ref()
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", graph)
    traj = tpipe.Trajectory.__new__(tpipe.Trajectory)
    traj._loop = lambda: "out"
    assert gc.isenabled()
    for fails in (False, True):
        cycle = Cycle()
        ref = weakref.ref(cycle)
        del cycle
        if fails:
            def boom():
                raise RuntimeError("capture failed")
            traj._loop = boom
            with pytest.raises(RuntimeError, match="capture failed"):
                traj._capture(None)
        else:
            traj._capture(None)
            assert traj.graph == "graph" and traj.out == "out"
        assert seen == {"enabled": False, "cycle": None}
        assert gc.isenabled()
