"""MNIST idx-format reader (counterpart of ``bigdl_tpu/dataset/mnist.py``;
numpy only, on the host).  It reads local files only, as the reference
does: ``train-images-idx3-ubyte`` / ``train-labels-idx1-ubyte`` and the
``t10k-*`` pair, optionally ``.gz``-compressed.  Its ``synthetic_mnist``
(class prototypes plus noise, [28, 28] features) is the autoencoder
example's, not ``dataset.image.synthetic_mnist`` (bright squares).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import Sample

__all__ = ["load_mnist", "mnist_samples", "synthetic_mnist",
           "TRAIN_MEAN", "TRAIN_STD", "TEST_MEAN", "TEST_STD"]

# reference models/lenet/Utils.scala trainMean/trainStd (on [0,255] scale)
TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, = struct.unpack(">i", f.read(4))
        ndim = magic % 256
        dims = struct.unpack(">" + "i" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def load_mnist(folder: str, train: bool = True) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [n, 28, 28] uint8, labels [n] uint8)."""
    prefix = "train" if train else "t10k"
    images = _read_idx(os.path.join(folder, f"{prefix}-images-idx3-ubyte"))
    labels = _read_idx(os.path.join(folder, f"{prefix}-labels-idx1-ubyte"))
    if len(images) != len(labels):
        raise ValueError(
            f"MNIST {prefix}: {len(images)} images vs {len(labels)} labels")
    return images, labels


def mnist_samples(folder: str, train: bool = True) -> List[Sample]:
    """Normalized Samples with 1-based labels (≙ BytesToGreyImg →
    GreyImgNormalizer → GreyImgToBatch, models/lenet/Train.scala:62-67)."""
    images, labels = load_mnist(folder, train)
    mean, std = (TRAIN_MEAN, TRAIN_STD) if train else (TEST_MEAN, TEST_STD)
    feats = (images.astype(np.float32) - mean) / std
    return [Sample(f, int(l) + 1) for f, l in zip(feats, labels)]


def synthetic_mnist(n: int = 512, seed: int = 0) -> List[Sample]:
    """Class-separable fake digits so the e2e path can run (and learn)
    without the dataset files."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    protos = rng.normal(size=(10, 28, 28)).astype(np.float32)
    feats = protos[labels] + 0.3 * rng.normal(size=(n, 28, 28))
    return [Sample(f.astype(np.float32), int(l) + 1)
            for f, l in zip(feats, labels)]
