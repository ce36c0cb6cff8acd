"""The ``Optimizer``'s dispatch windows on the card: a window of k steps
replays a captured CUDA graph of the whole step, and must train to the
weights and losses of the eager k=1 run bit for bit -- on an MLP with
and without train-mode dropout (the generator registered with the graph
and reseeded before each replay), and through each kernel family (the
LM's #1-#3, the sequence-parallel LM's #5-#7, the fused ResNet-50's
#8-#11).  The wrappers count what their Python launched (in a graph run
the warm-up step and the capture); torch.profiler's device events show
each kernel once per eager launch and a step's worth per replay.
Deterministic algorithms are on for both runs (the embedding's backward otherwise sums
with atomics).  Every test needs an NVIDIA GPU and skips without one;
the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph.py
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.core.module import dropout
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models import resnet as presnet
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.ops import conv_bn_kernels as ck
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.regularizer import L2Regularizer

pytestmark = pytest.mark.cuda

_WRAPPERS = (ak.flash_attention_fwd, ak.flash_attention_dq,
             ak.flash_attention_dkv, ak.flash_attention_partial,
             ak.flash_attention_dq_partial, ak.flash_attention_dkv_partial,
             ck.matmul_bn_fwd, ck.matmul_bn_bwd, ck.conv3x3_bn_fwd,
             ck.conv3x3_bn_bwd)
# the device kernel each launch of a wrapper runs once on these bf16
# paths (its tensor-core route), by parts of its demangled name
_KERNEL = {
    "flash_attention_fwd": ("flash_fwd_tc_kernel<false",),
    "flash_attention_dq": ("flash_dq_tc_kernel<", ", false>"),
    "flash_attention_dkv": ("flash_dkv_tc_kernel<",),
    "flash_attention_partial": ("flash_fwd_tc_kernel<true",),
    "flash_attention_dq_partial": ("flash_dq_tc_kernel<", ", true>"),
    "flash_attention_dkv_partial": ("flash_dkv_partial_tc_kernel<",),
    "matmul_bn_fwd": ("tcconv::fprop<1>",),
    "matmul_bn_bwd": ("tcconv::wgrad<1>",),
    "conv3x3_bn_fwd": ("tcconv::fprop<9>",),
    "conv3x3_bn_bwd": ("tcconv::wgrad<9>",),
}


def _counts():
    return {w.__name__: (w.launches, dict(getattr(w, "routes", {})))
            for w in _WRAPPERS}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(was)


class _Dropout(pnn.Module):
    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p) if self.training else x


def _train(make_model, batches, k, dtype=None, epochs=2, **setters):
    """Train a fresh model (``make_model()``, the same weights each
    call) over ``batches`` cached on the card; returns the model, the
    Optimizer, the wrappers' counts of the run ({wrapper: (launches,
    {route: launches})}) and its device launches by wrapper (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model = make_model()
    data = DataSet.array([MiniBatch(x, y) for x, y in batches],
                         shuffle=False).cache_on_device("cuda")
    opt = (Optimizer(model, data, setters.pop("criterion"), seed=3)
           .set_optim_method(SGD(0.05, momentum=0.9, dampening=0.0,
                                 learning_rate_decay=0.01))
           .set_end_when(Trigger.max_epoch(epochs))
           .set_compute_dtype(dtype)
           .set_iterations_per_dispatch(k))
    for name, args in setters.items():
        getattr(opt, name)(*args)
    before = _counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.optimize()
        torch.cuda.synchronize()
    counts = {name: (n - before[name][0],
                     {r: c - before[name][1][r] for r, c in routes.items()})
              for name, (n, routes) in _counts().items()}
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    device = {w: sum(all(part in n for part in parts) for n in names)
              for w, parts in _KERNEL.items()}
    return model, opt, counts, device


def _assert_same_run(eager, graph, n_steps, k):
    (m1, o1, l1, d1), (mk, ok, lk, dk) = eager, graph
    assert [x for _, x in ok.loss_history] == [x for _, x in o1.loss_history]
    for (name, p), q in zip(m1.named_parameters(), mk.parameters()):
        assert torch.equal(p, q), name
    for (name, b), c in zip(m1.named_buffers(), mk.buffers()):
        assert torch.equal(b, c), name
    assert ok.dispatch_stats["captures"] == 1
    assert ok.dispatch_stats["replays"] == n_steps
    assert o1.dispatch_stats["replays"] == 0
    # the wrappers count the graph run's warm-up step and its capture;
    # on the device each eager launch runs its kernel once, and the graph
    # run the warm-up step's and a step's worth per replay
    for name, (n, routes) in l1.items():
        per_step = n // n_steps
        assert lk[name] == (per_step * 2, {r: c // n_steps * 2
                                           for r, c in routes.items()}), name
        assert d1[name] == n, name
        assert dk[name] == per_step * (n_steps + 1), name


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mlp_graph_step_equals_the_eager_step(cuda, p):
    def make():
        gen = torch.Generator().manual_seed(0)
        layers = [pnn.Flatten(),
                  pnn.Linear(64, 48, w_regularizer=L2Regularizer(1e-3),
                             generator=gen, device=cuda), pnn.Tanh()]
        if p:
            layers.append(_Dropout(p))
        layers += [pnn.Linear(48, 10, generator=gen, device=cuda),
                   pnn.LogSoftMax()]
        return pnn.Sequential(*layers)
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(16, 8, 8)).astype(np.float32),
                rng.integers(1, 11, (16,))) for _ in range(4)]
    kw = dict(criterion=pnn.ClassNLLCriterion(),
              set_gradient_clipping_by_l2_norm=(0.5,))
    eager = _train(make, batches, 1, **kw)
    graph = _train(make, batches, 4, **dict(
        kw, criterion=pnn.ClassNLLCriterion()))
    _assert_same_run(eager, graph, 8, 4)
    if p:
        # the dropout stream differs from step to step
        assert len({x for _, x in graph[1].loss_history}) == 8


def _lm(device, seq_parallel=False):
    def make():
        lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                           filter_size=128, max_len=128,
                           padded_inputs=False,
                           generator=torch.Generator().manual_seed(0),
                           device=device)
        if seq_parallel:
            from bigdl_tpu_torch.parallel import make_mesh
            lm.set_sequence_parallel(make_mesh({"seq": 4}, ["cuda"] * 4))
        return FlatLM(lm)
    return make


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_lm_graph_step_replays_the_attention_kernels(cuda, seq_parallel):
    rng = np.random.default_rng(2)
    batches = [(rng.integers(1, 65, (2, 128)), rng.integers(1, 65, (256,)))
               for _ in range(3)]
    kw = dict(criterion=pnn.CrossEntropyCriterion(), dtype=torch.bfloat16)
    eager = _train(_lm(cuda, seq_parallel), batches, 1, **kw)
    graph = _train(_lm(cuda, seq_parallel), batches, 3, **kw)
    _assert_same_run(eager, graph, 6, 3)
    names = (("flash_attention_partial", "flash_attention_dq_partial",
              "flash_attention_dkv_partial") if seq_parallel else
             ("flash_attention_fwd", "flash_attention_dq",
              "flash_attention_dkv"))
    per_step = 2 * 10 if seq_parallel else 2   # layers x chunk pairs
    for name in names:
        n, routes = eager[2][name]
        assert n == per_step * 6 and routes["tensor_core"] == n, name


def test_fused_resnet_graph_step_replays_the_conv_kernels(cuda):
    def make():
        return presnet.resnet50(10, fused=True,
                                generator=torch.Generator().manual_seed(0),
                                device=cuda)
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
                rng.integers(1, 11, (2,))) for _ in range(2)]
    kw = dict(criterion=pnn.CrossEntropyCriterion(), dtype=torch.bfloat16)
    eager = _train(make, batches, 1, **kw)
    graph = _train(make, batches, 2, **kw)
    _assert_same_run(eager, graph, 4, 2)
    for name, per_step in (("matmul_bn_fwd", 32), ("matmul_bn_bwd", 32),
                           ("conv3x3_bn_fwd", 13), ("conv3x3_bn_bwd", 13)):
        n, routes = eager[2][name]
        assert n == per_step * 4 and routes["tensor_core"] == n, name


def test_a_capture_that_fails_raises(cuda):
    """No quiet fallback to eager steps: a step that reads a device value
    on the host cannot be captured, and the run raises."""

    class HostRead(pnn.Module):
        def forward(self, x):
            if float(x.sum()) > 1e30:
                return x * 2
            return x

    def make():
        gen = torch.Generator().manual_seed(0)
        return pnn.Sequential(pnn.Flatten(), HostRead(),
                              pnn.Linear(64, 10, generator=gen, device=cuda),
                              pnn.LogSoftMax())
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=(4, 8, 8)).astype(np.float32),
                rng.integers(1, 11, (4,))) for _ in range(2)]
    with pytest.raises(RuntimeError):
        _train(make, batches, 2, criterion=pnn.ClassNLLCriterion())
