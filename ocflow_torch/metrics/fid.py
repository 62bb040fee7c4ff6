"""Fréchet Inception Distance and Inception Score (port of
``ocflow_tpu/metrics/fid.py`` and ``calculate_fid`` of
``ocflow_tpu/metrics/__init__.py``).

The features come from the network on its device in batches; their mean
and covariance and the matrix square root run on the host in numpy and
scipy (``scipy.linalg.sqrtm``), as the JAX package (and the reference's
pytorch-fid) computes them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ocflow_torch.metrics.image_metrics import completed_images


def activation_statistics(features: np.ndarray):
    """``(mu, sigma)`` of ``[N, D]`` activations."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """``|mu1 - mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))``; a non-finite square
    root is taken again with ``eps`` on the diagonals, and an imaginary
    part above 1e-3 on the diagonal raises."""
    from scipy import linalg

    diff = mu1 - mu2
    # the square root alone (SciPy 1.18 dropped ``disp``; the JAX package's
    # ``disp=False`` returns the same matrix beside an error estimate it
    # does not read)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component in matrix sqrt")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def get_activations(extract_fn: Callable, imgs, batch_size: int = 64,
                    device=None) -> np.ndarray:
    """``extract_fn(batch) -> [B, D]`` over ``[N, H, W, 3]`` images in
    batches (each moved to ``device`` alone, when given), as one fp32
    ``[N, D]`` array on the host."""
    def chunk(i):
        part = imgs[i:i + batch_size]
        return part if device is None else part.to(device)

    return np.concatenate([_host(extract_fn(chunk(i))) for i in range(0, len(imgs), batch_size)],
                          axis=0)


def calculate_fid_given_imgs(imgs1, imgs2, extract_fn: Callable, batch_size: int = 64,
                             device=None) -> float:
    """FID between two sets of ``[N, H, W, 3]`` images in [-1, 1]
    (``get_activations``)."""
    m1, s1 = activation_statistics(get_activations(extract_fn, imgs1, batch_size, device))
    m2, s2 = activation_statistics(get_activations(extract_fn, imgs2, batch_size, device))
    return frechet_distance(m1, s1, m2, s2)


def inception_score(imgs, logits_fn: Callable, batch_size: int = 32, splits: int = 10):
    """``(mean, std)`` over ``splits`` chunks of ``exp(E[KL(p(y|x) ||
    p(y))])``, ``logits_fn(batch) -> [B, C]``; empty chunks are skipped."""
    import scipy.special

    preds = np.concatenate([scipy.special.softmax(_host(logits_fn(imgs[i:i + batch_size])),
                                                  axis=-1)
                            for i in range(0, len(imgs), batch_size)], axis=0)
    n = len(preds)
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        if len(part) == 0:
            continue
        py = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def calculate_fid(inpaint_fn, batches, extract_fn: Callable, batch_size: int = 64,
                  device=None) -> float:
    """FID between the real and the completed images of a loader's batches
    (``completed_images``, each batch on ``device``). The two image stacks
    are kept on the host, as the JAX package keeps them in numpy; with
    ``device``, Inception's chunks of ``batch_size`` go there one at a
    time."""
    completes, reals = [], []
    for complete, imgs in completed_images(inpaint_fn, batches, device):
        completes.append(complete.cpu())
        reals.append(imgs.cpu())
    return calculate_fid_given_imgs(torch.cat(reals), torch.cat(completes), extract_fn,
                                    batch_size, device)
