"""Inference: Predictor, Evaluator, PredictionService (counterpart of
``bigdl_tpu/optim/predictor.py``; the reference's optim/Predictor.scala,
Evaluator.scala and PredictionService.scala).

The reference clones the model to eval mode and jit-compiles its forward
once; ragged last batches are padded to the compiled batch shape by
repeating the last sample, and the padding rows are dropped on the host.
The port keeps that contract, with one eval-mode clone on the device and
its forward under ``torch.inference_mode()``; nothing is compiled.  The
PredictionService lets ``concurrency`` threads call the one clone at
once: an eval-mode forward of the port writes no module state.

Every entry point runs on ``device`` (default ``cuda``) and refuses a
model whose tensors lie elsewhere rather than moving it.
"""

from __future__ import annotations

import io
import queue
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device, same_device
from bigdl_tpu_torch.core.module import clone
from bigdl_tpu_torch.optim.validation import ValidationMethod, \
    ValidationResult

__all__ = ["Predictor", "Evaluator", "PredictionService", "jit_forward",
           "npy_call_bytes"]


def _as_dataset(data, batch_size: int):
    from bigdl_tpu_torch.dataset.dataset import LocalDataSet, Sample
    from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
    if hasattr(data, "data") and callable(data.data):
        return data  # already a (possibly transformed) DataSet
    if isinstance(data, (list, tuple)):
        if (isinstance(data, tuple) and len(data) == 2
                and isinstance(data[0], np.ndarray)
                and isinstance(data[1], np.ndarray)
                and data[0].shape[0] == data[1].shape[0]
                and data[1].ndim < data[0].ndim):
            # (features, labels) array pair → one Sample per row; the ndim
            # test keeps a 2-tuple of equally-shaped feature arrays on the
            # unlabeled path below
            data = [Sample(f, l) for f, l in zip(data[0], data[1])]
        elif data and isinstance(data[0], np.ndarray):
            data = [Sample(f) for f in data]
        return LocalDataSet(list(data), shuffle=False).transform(
            SampleToMiniBatch(batch_size, drop_last=False))
    raise TypeError(f"cannot build a dataset from {type(data)}")


def _check_device(model: nn.Module, device: torch.device) -> None:
    """Raise unless every tensor of ``model`` lies on ``device``."""
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if not same_device(t.device, device):
            raise ValueError(
                f"the model's {name} lies on {t.device}, the entry point "
                f"runs on {device}: move the model (or pass device=) "
                f"yourself")


def _to_device(x, device: torch.device):
    """Host arrays (or a tuple of them) to tensors on ``device``; float64
    becomes float32, as ``jnp.asarray`` makes it."""
    if isinstance(x, (tuple, list)):
        return tuple(_to_device(a, device) for a in x)
    t = torch.as_tensor(x)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _to_host(y):
    """The forward's output (a tensor or a tuple of them) as numpy."""
    if isinstance(y, (tuple, list)):
        return tuple(_to_host(a) for a in y)
    return y.detach().cpu().numpy()


def jit_forward(model: nn.Module, device=None):
    """The one maker of the inference forward, shared by Predictor,
    PredictionService and serving's Module backend so that the forward
    cannot drift between them.  It keeps the reference's name and compiles nothing:
    it returns ``(clone of model in eval mode on device, fn)``, where
    ``fn(m, x)`` runs ``m`` on ``x`` (host arrays or tensors) under
    ``torch.inference_mode()`` and returns the output on the device.
    The model must lie on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    _check_device(model, dev)
    model = clone(model).eval()

    def fn(m, x):
        with torch.inference_mode():
            return m(_to_device(x, dev))
    return model, fn


def npy_call_bytes(fn, payload: bytes) -> bytes:
    """The npy wire codec (array in → ``fn`` → array out), shared by
    ``PredictionService.predict_bytes`` and the HTTP front ends."""
    x = np.load(io.BytesIO(payload), allow_pickle=False)
    y = fn(x)
    buf = io.BytesIO()
    np.save(buf, y, allow_pickle=False)
    return buf.getvalue()


def _pad_batch(x, target: int):
    """Pad the leading axis to ``target`` rows (repeat-last padding)."""
    def pad(a):
        a = np.asarray(a)
        if a.shape[0] == target:
            return a
        reps = np.repeat(a[-1:], target - a.shape[0], axis=0)
        return np.concatenate([a, reps], axis=0)
    if isinstance(x, (tuple, list)):
        return type(x)(pad(a) for a in x)
    return pad(x)


class Predictor:
    """Batched inference over a dataset (Predictor.scala:152 ``predict``,
    :119 ``predictClass``)."""

    def __init__(self, model: nn.Module, batch_size: int = 32,
                 device=None):
        self.model, self._fn = jit_forward(model, device)
        self.batch_size = batch_size

    def _iter_batches(self, data):
        ds = _as_dataset(data, self.batch_size)
        for batch in ds.data(train=False):
            n = batch.size()
            x = batch.get_input()
            if n < self.batch_size:
                x = _pad_batch(x, self.batch_size)
            yield n, x

    def predict(self, data) -> List[np.ndarray]:
        """Per-sample outputs (AbstractModule.predict:660)."""
        out: List[np.ndarray] = []
        for n, x in self._iter_batches(data):
            y = _to_host(self._fn(self.model, x))
            out.extend([tuple(c[i] for c in y) for i in range(n)]
                       if isinstance(y, tuple) else y[:n])
        return out

    def predict_class(self, data) -> np.ndarray:
        """Argmax class per sample, 1-based as the reference's Torch-style
        labels (Predictor.scala:119 predictClass)."""
        preds = self.predict(data)
        return np.asarray([int(np.argmax(p)) + 1 for p in preds])


class Evaluator:
    """Evaluate over a dataset (Evaluator.scala:111): the
    ValidationResults of every batch, summed.  Every batch runs at its
    own size, the ragged tail unpadded, so the counts are exact."""

    def __init__(self, model: nn.Module, batch_size: int = 32,
                 device=None):
        self.model, self._fn = jit_forward(model, device)
        self.device = resolve_device(device)
        self.batch_size = batch_size

    def evaluate(self, data, methods: Sequence[ValidationMethod]) \
            -> List[Tuple[ValidationResult, ValidationMethod]]:
        methods = list(methods)
        ds = _as_dataset(data, self.batch_size)
        totals: Optional[List[ValidationResult]] = None
        for batch in ds.data(train=False):
            out = self._fn(self.model, batch.get_input())
            y = _to_device(batch.get_target(), self.device)
            with torch.inference_mode():
                results = [m.to_result(*m.batch_stats(out, y))
                           for m in methods]
            totals = results if totals is None else [
                t + r for t, r in zip(totals, results)]
        if totals is None:
            raise ValueError("evaluate: empty dataset")
        return list(zip(totals, methods))


class PredictionService:
    """Thread-safe concurrent inference (PredictionService.scala:56-129,
    a pool of model instances): ``concurrency`` tickets bound the
    requests in flight, all on one eval-mode clone."""

    def __init__(self, model: nn.Module, concurrency: int = 4,
                 device=None):
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        self.device = resolve_device(device)
        self.model, self._fn = jit_forward(model, self.device)
        self._tickets: "queue.Queue[int]" = queue.Queue()
        for i in range(concurrency):
            self._tickets.put(i)

    def predict(self, activity):
        """One request: an array or a tuple of arrays in, an array (or a
        tuple, for a multi-head model) out; errors are raised, not the
        reference's error-tensor encoding."""
        ticket = self._tickets.get()
        try:
            return _to_host(self._fn(self.model, activity))
        finally:
            self._tickets.put(ticket)

    def serve(self, **kwargs):
        """A dynamic batcher in front of this service: a
        ``ModelServer`` whose backend is this ticketed ``predict``
        (kwargs: ``max_batch``, ``batch_timeout_ms``, ``queue_capacity``,
        ``admission``, ``metrics``), on this service's device."""
        from bigdl_tpu_torch.serving.server import ModelServer
        kwargs.setdefault("device", self.device)
        return ModelServer(self, **kwargs)

    def predict_bytes(self, payload: bytes) -> bytes:
        """npy bytes in, npy bytes out (PredictionService.scala:129)."""
        return npy_call_bytes(self.predict, payload)
