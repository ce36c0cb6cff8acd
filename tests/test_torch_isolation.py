"""The port stands alone: ``bigdl_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``bigdl_tpu``, its entry points refuse to
carry on quietly on the CPU, and ``chip_smoke.py`` fails without a card.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bigdl_tpu_torch
from bigdl_tpu_torch.models import (LeNet5, TransformerLM, lenet5_graph,
                                    resnet50, resnet_cifar, wide_and_deep)
from bigdl_tpu_torch.nn import (PReLU, SpatialBatchNormalization,
                                SpatialConvolution)
from bigdl_tpu_torch.serving import (DisaggregatedEngine,
                                     GenerationScheduler, ModelServer)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
print(len(names), leaked)
"""


def _run(args, cwd, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_and_chip_smoke_import_no_jax():
    proc = _run(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    n, leaked = proc.stdout.strip().split(" ", 1)
    expected = len(list(pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                              "bigdl_tpu_torch.")))
    assert int(n) == expected and expected >= 42
    for name in ("bigdl_tpu_torch.core.init", "bigdl_tpu_torch.nn.conv",
                 "bigdl_tpu_torch.nn.pooling", "bigdl_tpu_torch.models.resnet",
                 "bigdl_tpu_torch.ops.conv_bn_kernels",
                 "bigdl_tpu_torch.nn.activation",
                 "bigdl_tpu_torch.nn.shape_ops",
                 "bigdl_tpu_torch.nn.containers",
                 "bigdl_tpu_torch.models.lenet",
                 "bigdl_tpu_torch.dataset.transformer",
                 "bigdl_tpu_torch.dataset.image",
                 "bigdl_tpu_torch.optim.validation",
                 "bigdl_tpu_torch.optim.metrics",
                 "bigdl_tpu_torch.optim.regularizer",
                 "bigdl_tpu_torch.utils.file", "bigdl_tpu_torch.utils.chaos",
                 "bigdl_tpu_torch.data.pipeline",
                 "bigdl_tpu_torch.data.device_prefetch",
                 "bigdl_tpu_torch.dataset.prefetch",
                 "bigdl_tpu_torch.serving.prefix_cache",
                 "bigdl_tpu_torch.serving.replica",
                 "bigdl_tpu_torch.optim.methods",
                 "bigdl_tpu_torch.optim.profiling",
                 "bigdl_tpu_torch.nn.criterion",
                 "bigdl_tpu_torch.models.ncf",
                 "bigdl_tpu_torch.dataset.movielens",
                 "bigdl_tpu_torch.dataset.mnist",
                 "bigdl_tpu_torch.examples.common",
                 "bigdl_tpu_torch.examples.ncf",
                 "bigdl_tpu_torch.examples.autoencoder",
                 "bigdl_tpu_torch.nn.sparse",
                 "bigdl_tpu_torch.embedding.sharded_table",
                 "bigdl_tpu_torch.embedding.hybrid",
                 "bigdl_tpu_torch.embedding.eval",
                 "bigdl_tpu_torch.embedding.serving",
                 "bigdl_tpu_torch.models.dlrm",
                 "bigdl_tpu_torch.ops.feature_columns",
                 "bigdl_tpu_torch.ops.operations",
                 "bigdl_tpu_torch.ops.control"):
        assert name in {m.name for m in pkgutil.walk_packages(
            bigdl_tpu_torch.__path__, "bigdl_tpu_torch.")}
    assert leaked == "[]", leaked


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    cfg = dict(vocab_size=16, hidden_size=16, num_layers=1, num_heads=2,
               filter_size=32, max_len=16, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(**cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(**cfg, device="cuda")
    lm = TransformerLM(**cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationScheduler(lm, slots=1, start=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServer(generator=lm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedEngine(lm)
    with pytest.raises(ValueError, match="unsupported device"):
        TransformerLM(**cfg, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50(generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet_cifar(8, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpatialConvolution(3, 4, 3, 3, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpatialBatchNormalization(4, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet5(10, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lenet5_graph(10, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PReLU(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wide_and_deep(generator=gen)
    assert resnet_cifar(8, generator=gen, device="cpu").head.weight \
        .device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            (tmp_path / "chip_smoke.py").write_text(
                (ROOT / "chip_smoke.py").read_text())
        proc = _run(["chip_smoke.py"], cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
