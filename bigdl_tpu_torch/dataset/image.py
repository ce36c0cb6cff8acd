"""Host-side image stages and synthetic MNIST (counterpart of
``GreyImgNormalizer`` and ``synthetic_mnist`` in
``bigdl_tpu/dataset/image.py``; numpy, run before the device copy).  The
other loaders are not ported yet (ROADMAP.md queue 1, item 13)."""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.dataset import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["GreyImgNormalizer", "synthetic_mnist"]


class GreyImgNormalizer(Transformer):
    """(x − mean) / std on grey images, in float32."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def apply(self, it):
        for s in it:
            yield Sample((np.asarray(s.feature, np.float32) - self.mean)
                         / self.std, s.label)


def synthetic_mnist(n: int = 2048, seed: int = 0):
    """Deterministic MNIST-shaped digits [28, 28, 1] with labels 1..10: a
    class-dependent bright square on noise, learnable by LeNet (the
    reference's, sample for sample)."""
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        label = i % 10
        img = rng.normal(16.0, 8.0, size=(28, 28, 1)).astype(np.float32)
        r, c = divmod(label, 4)
        img[4 + r * 8:10 + r * 8, 4 + c * 6:10 + c * 6] += 200.0
        samples.append(Sample(np.clip(img, 0, 255), label + 1))
    rng.shuffle(samples)
    return samples
