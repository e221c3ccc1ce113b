"""Generation-quality metrics: Fréchet distance (FID), KID and CLIP score
(port of ``utils/metrics.py``).

The statistics and distance are featurizer-agnostic: canonical FID takes
the pool3 features of the FID InceptionV3 (``models/inception.py``, weights
from ``io/weights_inception.import_inception_fid``); without its weights
the port's own CLIP vision tower serves as the featurizer (CLIP-FID, a
standard variant). With a pretrained ViT-L/14 checkpoint,
``io.weights_clip.import_openai_clip`` gives the ``state_dict`` and the
arguments of ``models.clip.CLIP`` for the real CLIP score / CLIP-FID:
preprocess images with ``ops.image.clip_preprocess``, tokenize with the SD1
``CLIPTokenizer`` (the same BPE vocabulary).

The models carry their weights (the JAX functions' ``params``), and the
entry points that run a model take ``device`` (default the card) for the
images they are given; the CLIP model must lie there. Features come back
as host numpy arrays, as in the JAX package. The statistics are fp32 and
the matrix square roots symmetric eigendecompositions
(``torch.linalg.eigh``, a library call as XLA's ``eigh`` is in JAX, taken
in fp64: see :func:`frechet_distance`) on ``device`` too, the card unless
the caller asks for the CPU, as in every other entry point. fp32
convolutions on the card use TF32 unless ``torch.backends.cudnn.allow_tf32``
is off (torch's default is on); the matrix products here run in full fp32
unless ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def feature_statistics(features, device="cuda"):
    """(N, D) features -> (mu (D,), cov (D, D)) in fp32, on ``device``."""
    f = torch.as_tensor(features, dtype=torch.float32, device=device)
    mu = f.mean(dim=0)
    centered = f - mu
    cov = centered.T @ centered / (f.shape[0] - 1)
    return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6,
                     device="cuda") -> float:
    """FID = |μ₁−μ₂|² + tr(Σ₁ + Σ₂ − 2·(Σ₁^{1/2} Σ₂ Σ₁^{1/2})^{1/2}).

    The matrix square roots use symmetric eigendecompositions, clamping
    tiny negative eigenvalues from numerical noise at 0. Each square root is
    taken in fp64 and rounded to fp32 (the JAX package's is fp32 throughout):
    cuSOLVER's fp32 ``syevd`` does not converge on the near-singular inner
    matrix of a few images' covariances (64 samples of 2048-d features);
    with many samples the two agree to ~1e-5 relative, with 64 to ~6e-4."""
    mu1, cov1, mu2, cov2 = (torch.as_tensor(a, dtype=torch.float32,
                                            device=device)
                            for a in (mu1, cov1, mu2, cov2))

    def sqrtm_psd(m):
        w, v = torch.linalg.eigh(m.double())
        w = w.clamp(min=0.0)
        return ((v * w.sqrt()[None, :]) @ v.T).float()

    eye = torch.eye(cov1.shape[0], device=cov1.device)
    s1 = sqrtm_psd(cov1 + eps * eye)
    inner = s1 @ cov2 @ s1
    s_inner = sqrtm_psd((inner + inner.T) / 2.0)
    diff = mu1 - mu2
    fid = (torch.dot(diff, diff) + torch.trace(cov1) + torch.trace(cov2)
           - 2.0 * torch.trace(s_inner))
    return float(fid)


def fid_from_features(feats_a, feats_b, device="cuda") -> float:
    mu1, c1 = feature_statistics(feats_a, device)
    mu2, c2 = feature_statistics(feats_b, device)
    return frechet_distance(mu1, c1, mu2, c2, device=device)


def _normalized(f: torch.Tensor) -> torch.Tensor:
    f = f.float()
    return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)


@torch.inference_mode()
def clip_image_features(images, clip_model, batch_size: int = 32,
                        device="cuda") -> np.ndarray:
    """Normalized image features from the CLIP vision tower, batch by
    batch. images: (N, H, W, 3) float in [−1, 1] at the tower's
    resolution."""
    feats = []
    for s in range(0, len(images), batch_size):
        x = torch.as_tensor(images[s:s + batch_size], dtype=torch.float32,
                            device=device)
        feats.append(_normalized(clip_model.encode_image(x)).cpu().numpy())
    return np.concatenate(feats)


def clip_fid(images_a, images_b, clip_model, device="cuda") -> float:
    """Fréchet distance in the CLIP vision tower's feature space."""
    return fid_from_features(
        clip_image_features(images_a, clip_model, device=device),
        clip_image_features(images_b, clip_model, device=device), device)


@torch.inference_mode()
def clip_score(images, token_ids, clip_model, device="cuda") -> float:
    """Mean 100·cos(image, caption) over matched pairs (CLIPScore)."""
    img = clip_model.encode_image(torch.as_tensor(
        images, dtype=torch.float32, device=device))
    txt = clip_model.encode_text(torch.as_tensor(
        token_ids, dtype=torch.long, device=device))
    return float(100.0 * (_normalized(img) * _normalized(txt)).sum(
        dim=1).mean())


def inception_model(params: Mapping[str, torch.Tensor], device="cuda"):
    """The FID InceptionV3 on ``device`` from its ``state_dict`` (every
    parameter, nothing left over), in eval mode."""
    from ..io.from_jax import load_state_checked
    from ..models.inception import InceptionV3FID

    with torch.device("meta"):
        model = InceptionV3FID()
    model = load_state_checked(model.to_empty(device=device), params)
    return model.to(memory_format=torch.channels_last).eval()


@torch.inference_mode()
def inception_features(images, params: Mapping[str, torch.Tensor],
                       batch_size: int = 32, device="cuda") -> np.ndarray:
    """Canonical FID features: pool3 of the FID InceptionV3.

    images: (N, H, W, 3) float in [0, 1], any resolution, resized to 299²
    batch by batch (``resize_for_fid``); ``params``: the model's
    ``state_dict`` (``io.weights_inception.import_inception_fid``)."""
    from ..models.inception import resize_for_fid

    model = inception_model(params, device)
    feats = []
    for s in range(0, len(images), batch_size):
        x = torch.as_tensor(images[s:s + batch_size], dtype=torch.float32,
                            device=device)
        feats.append(model(resize_for_fid(x)).cpu().numpy())
    return np.concatenate(feats)


def inception_fid(images_a, images_b, params: Mapping[str, torch.Tensor],
                  device="cuda") -> float:
    """Canonical FID (InceptionV3 pool3 Fréchet distance); images in
    [0, 1]. CLIP-FID (:func:`clip_fid`) remains the weights-free
    fallback."""
    return fid_from_features(inception_features(images_a, params,
                                                device=device),
                             inception_features(images_b, params,
                                                device=device), device)


def kid_from_features(feats_a, feats_b, n_subsets: int = 10,
                      subset_size: Optional[int] = None,
                      seed: int = 0) -> float:
    """Kernel Inception Distance: unbiased MMD² with the polynomial kernel
    k(x, y) = (xᵀy/d + 1)³ (Bińkowski et al. 2018), averaged over random
    subsets. Unlike FID it is unbiased at small sample counts. Works with
    ANY featurizer (inception_features / clip_image_features). Host numpy
    in float64, as in the JAX package."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    d = a.shape[1]
    # clamp to the available rows; the unbiased estimator needs m >= 2
    m = min(subset_size or 1000, len(a), len(b))
    if m < 2:
        raise ValueError(f"KID needs >= 2 samples per side, got m={m}")
    rng = np.random.default_rng(seed)

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for _ in range(n_subsets):
        xa = a[rng.choice(len(a), m, replace=False)]
        xb = b[rng.choice(len(b), m, replace=False)]
        kaa = poly(xa, xa)
        kbb = poly(xb, xb)
        kab = poly(xa, xb)
        # unbiased MMD²: drop the diagonals of the within-set terms
        term_a = (kaa.sum() - np.trace(kaa)) / (m * (m - 1))
        term_b = (kbb.sum() - np.trace(kbb)) / (m * (m - 1))
        vals.append(term_a + term_b - 2.0 * kab.mean())
    return float(np.mean(vals))
