"""The GANs' scores, the twins of ``evaluate.py``'s ``cmd_gan`` measures.

- :func:`inversion_score` (CycleGAN): the synthetic domains
  (``data/gan.synthetic_unpaired``) are related by colour inversion, so
  the unpaired-trained generators are scored paired on held-out images:
  ``1 - mean(mse(G_ab(a), -a), mse(G_ba(b), -b)) / baseline``, where the
  baseline ``(E[a²] + E[b²]) / 2`` is the zero predictor's error (a
  fresh tanh generator scores about 0, the true inversion 1).
- :func:`inception_score` (DCGAN): ``exp(E KL(p(y|x) || p(y)))`` of a
  judge classifier's probabilities; confident and diverse samples score
  high. The CLI divides the samples' score by the held-out reals'.
"""

from __future__ import annotations

import numpy as np

__all__ = ["inversion_score", "inception_score", "embed_samples"]

# the synthetic digits' background (0.1) on the [-1, 1] scale
BACKGROUND = -0.8


def inversion_score(fake_b: np.ndarray, fake_a: np.ndarray, a: np.ndarray,
                    b: np.ndarray) -> dict:
    """``mse_a2b``, ``mse_b2a``, ``mse_baseline`` and ``score`` of the
    translations ``fake_b = G_ab(a)`` and ``fake_a = G_ba(b)``."""
    mse_a2b = float(np.mean((fake_b - (-a)) ** 2))
    mse_b2a = float(np.mean((fake_a - (-b)) ** 2))
    base = float(np.mean(a ** 2) + np.mean(b ** 2)) / 2.0
    return {"mse_a2b": mse_a2b, "mse_b2a": mse_b2a, "mse_baseline": base,
            "score": 1.0 - 0.5 * (mse_a2b + mse_b2a) / base}


def inception_score(p: np.ndarray) -> float:
    """``exp(mean KL(p(y|x) || p(y)))`` of ``(N, classes)``
    probabilities."""
    marg = p.mean(0, keepdims=True)
    kl = (p * (np.log(p + 1e-10) - np.log(marg + 1e-10))).sum(1)
    return float(np.exp(kl.mean()))


def embed_samples(samples: np.ndarray) -> np.ndarray:
    """28x28 samples re-embedded at the DCGAN training crop's offset
    (``[2:30, 2:30]``) of a 32x32 canvas of the background's value, the
    judge's geometry."""
    canvas = np.full((len(samples), 32, 32, 1), BACKGROUND, np.float32)
    canvas[:, 2:30, 2:30, :] = samples.astype(np.float32)
    return canvas
