"""The parts of the SD1 generator beside its k-LMS core, each against the JAX
package on the CPU: the three samplers beside k-LMS, the VAE encoder, the
tokenizer and the prompt-weight syntax. ``tests/test_torch_sd1_full.py``
holds the generator as a whole.

Inputs come from a numpy seed and go to both packages; the ancestral
sampler gets JAX's own ``normal(fold_in(rng, t))`` draws through its
``step_noise=`` hook. Tolerances: sampler trajectories on a toy denoiser
1e-5 (fp32, the same host tables); the encoder 1e-4 (fp32 convolutions
summed in another order); tokenizer ids and prompt weights exactly equal.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import prompt_weights as jpw
from from_ddpm_to_stable_diffusion_tpu.io import tokenizer as jtok
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.samplers import k_samplers as jks
from from_ddpm_to_stable_diffusion_tpu_torch.io import prompt_weights as tpw
from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import load_jax_params
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.samplers import k_samplers as tks
from tests.test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------------ samplers
@pytest.mark.parametrize("strength", [1.0, 0.5])
@pytest.mark.parametrize("method", ["k_euler", "dpmpp_2m",
                                    "k_euler_ancestral", "k_lms"])
def test_sampler_matches_jax_scan(method, strength):
    """A shared toy denoiser through ``k_sampler_scan`` of both packages;
    the ancestral sampler gets JAX's ``normal(fold_in(rng, t))`` draws."""
    x0 = _rand((2, 4, 4, 4), 1, 3.0)
    rng = jax.random.key(5)
    kw = dict(method=method, n_inference_steps=10, strength=strength)
    want = jks.k_sampler_scan(
        lambda x, t: 0.1 * x + 0.01 * jnp.sin(t), jnp.asarray(x0),
        jks.KSamplerConfig(**kw), rng=rng)
    draw = lambda t: np.asarray(jax.random.normal(jax.random.fold_in(rng, t),
                                                  x0.shape))
    got = tks.k_sampler_scan(
        lambda x, t: 0.1 * x + 0.01 * torch.sin(t), torch.from_numpy(x0),
        tks.KSamplerConfig(**kw), step_noise=draw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert tks.sigma_tables(tks.KSamplerConfig(**kw))["start_step"] == (
        0 if strength == 1.0 else 5)


def test_ancestral_sampler_draws_from_its_generator():
    x0 = torch.from_numpy(_rand((1, 4, 4, 4), 2))
    cfg = tks.KSamplerConfig(method="k_euler_ancestral", n_inference_steps=5)
    run = lambda seed: tks.k_sampler_scan(
        lambda x, t: 0.1 * x, x0, cfg,
        generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert (run(3) - run(4)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generator or step_noise"):
        tks.k_sampler_scan(lambda x, t: x, x0, cfg)


# --------------------------------------------------------------- VAE encoder
@pytest.fixture(scope="module")
def encoder_params():
    return jax_random_params(jsd1.VAEEncoder(), jnp.zeros((1, 64, 64, 3)),
                             jnp.zeros((1, 8, 8, 4)), seed=4)


@pytest.mark.parametrize("size", [64, 72])
def test_vae_encoder_matches_jax(encoder_params, size):
    """72 -> 36 -> 18 -> 9: the (0, 1, 0, 1) pad meets an even size at every
    stride-2 conv and the one-head attention an odd number of tokens (81)."""
    x = np.tanh(_rand((2, size, size, 3), 10))
    noise = _rand((2, size // 8, size // 8, 4), 11)
    want = jax.jit(jsd1.VAEEncoder().apply)({"params": encoder_params},
                                            jnp.asarray(x), jnp.asarray(noise))
    enc = load_jax_params(tsd1.VAEEncoder(), encoder_params).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.shape == (2, size // 8, size // 8, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert np.asarray(want).std() > 0.01


def test_vae_encoder_downsample_pads_right_and_bottom_only():
    """Not Flax SAME, not ``padding=1`` (both give 9 -> 5): one row and one
    column of zeros at the bottom and the right and no other padding, so
    9 -> 4 and 8 -> 4; and the log-variance, not the mean, is clamped."""
    down = tsd1._Downsample(1)
    with torch.no_grad():
        down.weight.fill_(1.0)
        down.bias.zero_()
        assert down(torch.zeros(1, 9, 9, 1)).shape == (1, 4, 4, 1)
        x = torch.arange(64.0).reshape(1, 8, 8, 1)
        got = down(x)
        assert got.shape == (1, 4, 4, 1)
        assert got[0, 0, 0, 0] == x[0, :3, :3, 0].sum()     # no top/left pad
        assert got[0, 3, 3, 0] == x[0, 6:, 6:, 0].sum()     # zeros beyond
    enc = tsd1.VAEEncoder()
    with torch.no_grad():
        for p in enc.parameters():
            p.zero_()
        enc.conv_quant.bias.copy_(torch.tensor([100.0] * 4 + [50.0] * 4))
        z = enc(torch.zeros(1, 8, 8, 3), torch.ones(1, 1, 1, 4))
    want = (100.0 + np.exp(0.5 * 20.0)) * tsd1.SD1_LATENT_SCALE
    np.testing.assert_allclose(z.numpy(), np.full((1, 1, 1, 4), want),
                               rtol=1e-6)


# ---------------------------------------------------------------- tokenizer
WORDS = ["a", "cat", "dog", "photo", "of", "the", "café", "naïve", "東京",
         "привет", "it", "don", "blurry", "red", "we"]
CORPUS = [
    "a photo of a cat", "A  Photo\tof THE dog\n", "café naïve Ünïcödé",
    "東京 привет мир", "it's don't we're I've I'm we'll she'd",
    "12 cats, 3.5 dogs; ½ ² ٣ Ⅷ ⑤", "hello!!! ... (wow) [ok] #tag @you",
    "<|startoftext|>a cat<|endoftext|>", "!<|endoftext|>?", "",
    "   ", "école", "ẛ̣", "ﬁne ǅ 'S 'LL IT'S",
    "a b c\x1cd\x85e", "emoji 🙂 ok", "x" * 200,
    " ".join(["cat dog"] * 60), "tabͅle 'ſ",
]


@pytest.fixture(scope="module")
def tokenizers():
    want_vocab, want_merges = jtok.build_simple_vocab(WORDS)
    vocab, merges = ttok.build_simple_vocab(WORDS)
    assert vocab == want_vocab and merges == want_merges
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    return (jtok.CLIPTokenizer(want_vocab, want_merges),
            ttok.CLIPTokenizer(vocab, merges))


@pytest.mark.parametrize("text", CORPUS)
def test_tokenizer_ids_match_jax(tokenizers, text):
    """Accented and non-Latin letters, digits and other Unicode numerics,
    punctuation, contractions, special tokens, odd whitespace, over-long
    prompts: the same ids from the scanner as from the ``regex`` pattern."""
    want, got = tokenizers
    assert got.encode(text) == want.encode(text)
    assert got.encode_fragment(text) == want.encode_fragment(text)
    assert got.encode(text, pad=False) == want.encode(text, pad=False)
    assert len(got.encode(text)) == 77
    assert got.decode(got.encode(text)) == want.decode(want.encode(text))


def test_tokenizer_batch_and_weights_api_match_jax(tokenizers):
    want, got = tokenizers
    assert got.encode_batch(CORPUS) == want.encode_batch(CORPUS)
    text = "a (red:1.4) cat [blurry]"
    assert (got.tokenize_with_weights(text, parse_weights=True)
            == want.tokenize_with_weights(text, parse_weights=True))
    assert got.tokenize_with_weights(text) == want.tokenize_with_weights(text)
    assert (got.bos_id, got.eos_id, got.pad_id, got.max_length) == (
        want.bos_id, want.eos_id, want.pad_id, want.max_length)


def test_tokenizer_needs_only_the_standard_library():
    import sys

    src = open(ttok.__file__).read()
    assert "import regex" not in src
    first = {line.split()[1].split(".")[0] for line in src.splitlines()
             if line.startswith(("import ", "from ")) and "__future__"
             not in line and not line.startswith("from .")}
    assert first <= set(sys.stdlib_module_names), first


# ----------------------------------------------------------- prompt weights
WEIGHTED = ["a (red) cat", "a ((red)) [blurry] cat", "(photo of:1.3) the dog",
            "escaped \\(paren\\) and \\\\", "unbalanced (red cat",
            "stray :1.2) close ] here", "plain prompt", "", "(a:0.5)(cat:2)",
            "[the [dog]] (it's:1.1)"]


@pytest.mark.parametrize("text", WEIGHTED)
def test_prompt_weight_parsing_and_encoding_match_jax(tokenizers, text):
    want_tok, got_tok = tokenizers
    assert tpw.parse_weighted_segments(text) == jpw.parse_weighted_segments(
        text)
    for parse in (True, False):
        assert (tpw.encode_with_weights(got_tok, text, parse)
                == jpw.encode_with_weights(want_tok, text, parse))
    assert (tpw.batch_encode_with_weights(got_tok, WEIGHTED)
            == jpw.batch_encode_with_weights(want_tok, WEIGHTED))


def test_apply_token_weights_matches_jax():
    z = _rand((3, 77, 16), 20) + 0.3
    w = np.ones((3, 77), np.float32)
    w[0, 2:5], w[1, 1:9], w[2, 7] = 1.3, 1 / 1.1, 0.0
    want = jpw.apply_token_weights(jnp.asarray(z), w)
    got = tpw.apply_token_weights(torch.from_numpy(z), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy().mean((1, 2)), z.mean((1, 2)),
                               rtol=1e-5)                  # mean preserved
    same = tpw.apply_token_weights(torch.from_numpy(z), np.ones((3, 77)))
    np.testing.assert_array_equal(same.numpy(), z)         # the identity
    half = tpw.apply_token_weights(torch.from_numpy(z).bfloat16(), w)
    assert half.dtype == torch.bfloat16                    # fp32 inside
    np.testing.assert_allclose(half.float().numpy(), np.asarray(want),
                               atol=3e-2)
