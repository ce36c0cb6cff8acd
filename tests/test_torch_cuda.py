"""The port's CUDA flash-attention kernels on the card (the forward and
the dQ, dK/dV and dBias backward kernels), against their plain PyTorch
versions, and a training step on the card against the CPU.  Every test
here needs an NVIDIA GPU and skips without one; the file imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-4, atol 2e-5 (the kernel sums in another
order than cuBLAS; 1e-4 for the backward's longer sums); the bfloat16
forward 2e-2 (one bf16 ulp near 1).  The bfloat16 backward must equal its
plain version bit for bit: both round P and dS to bf16 at the same points
and sum in f32, and a missing cast moves a sum by less than an ulp.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BWD_F32_TOL = dict(rtol=1e-4, atol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rnd(*shape, seed=0, device="cpu", dtype=torch.float32):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("b,h,tq,tk,d,causal,bias_shape,dtype", [
    (1, 8, 128, 512, 64, False, (1, 1, 128, 512), torch.float32),
    (16, 8, 1, 512, 64, False, (16, 1, 1, 512), torch.float32),
    (4, 8, 127, 127, 64, False, (4, 1, 127, 127), torch.float32),
    (2, 4, 100, 300, 32, True, None, torch.float32),
    (2, 8, 256, 256, 64, True, None, torch.bfloat16),
    (1, 2, 33, 70, 128, True, (70,), torch.float32),
    (3, 2, 5, 1, 8, False, None, torch.float32),
])
def test_kernel_matches_plain(cuda, b, h, tq, tk, d, causal, bias_shape,
                              dtype):
    q = rnd(b, h, tq, d, seed=1, device=cuda, dtype=dtype)
    k = rnd(b, h, tk, d, seed=2, device=cuda, dtype=dtype)
    v = rnd(b, h, tk, d, seed=3, device=cuda, dtype=dtype)
    bias = (None if bias_shape is None
            else rnd(*bias_shape, seed=4, device=cuda))
    before = ak.flash_attention_fwd.launches
    got = ak.dot_product_attention(q, k, v, bias, causal=causal)
    want = ak.plain_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert ak.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, tq, d)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_reads_strided_heads_and_writes_lse(cuda):
    """q/k/v as _split_heads makes them ([B, T, H, D] viewed as BHTD), a
    masked row, and the log-sum-exp the backward will read."""
    q = rnd(2, 40, 4, 32, seed=5, device=cuda).transpose(1, 2)
    k = rnd(2, 90, 4, 32, seed=6, device=cuda).transpose(1, 2)
    v = rnd(2, 90, 4, 32, seed=7, device=cuda).transpose(1, 2)
    bias = torch.zeros((2, 1, 40, 90), device=cuda)
    bias[:, :, 7] = -1e9
    out, lse = ak.flash_attention_fwd(q, k, v, bias, scale=32 ** -0.5)
    want = ak.plain_attention(q, k, v, bias)
    logits = torch.matmul(q, k.transpose(-1, -2)) * 32 ** -0.5 + bias
    torch.testing.assert_close(out, want, **F32_TOL)
    torch.testing.assert_close(
        lse, torch.logsumexp(logits, -1).reshape(8, 40), **F32_TOL)


def test_flash_attention_start_aligned_causal(cuda):
    q, k, v = (rnd(1, 2, 64, 16, seed=s, device=cuda) for s in (8, 9, 10))
    torch.testing.assert_close(ak.flash_attention(q, k, v, causal=True),
                               ak.plain_attention(q, k, v, causal=True),
                               **F32_TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = rnd(1, 1, 8, 16, seed=11, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        big = rnd(1, 1, 8, 160, seed=12, device=cuda)
        ak.flash_attention_fwd(big, big, big, scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        ak.flash_attention_fwd(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous head dim"):
        ak.flash_attention_fwd(q.transpose(2, 3), q.transpose(2, 3),
                               q.transpose(2, 3), scale=1.0)
    with pytest.raises(ValueError, match="bias"):
        ak.flash_attention_fwd(q, q, q, torch.zeros(8, 8), scale=1.0)


def test_lm_on_the_card_matches_the_cpu_and_launches_per_layer(cuda):
    gen = torch.Generator().manual_seed(0)
    lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=64, generator=gen,
                       device=cuda).eval()
    tokens = np.random.default_rng(0).integers(1, 65, (2, 24))
    tokens[1, 20:] = 0
    before = ak.flash_attention_fwd.launches
    with torch.no_grad():
        on_card = lm(tokens).cpu()
    assert ak.flash_attention_fwd.launches == before + 2
    lm_cpu = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                           filter_size=128, max_len=64,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu").eval()
    with torch.no_grad():
        torch.testing.assert_close(on_card, lm_cpu(tokens), rtol=1e-4,
                                   atol=1e-4)
        prompt = tokens[:1, :10]
        np.testing.assert_array_equal(
            lm.generate(prompt, 12).cpu().numpy(),
            lm_cpu.generate(prompt, 12).numpy())


@pytest.mark.parametrize("b,h,tq,tk,d,causal,bias_shape,dtype", [
    (2, 8, 256, 256, 64, True, None, torch.bfloat16),
    (2, 8, 512, 512, 64, True, None, torch.float32),
    (2, 8, 256, 256, 64, False, (2, 1, 256, 256), torch.float32),
    (2, 8, 256, 256, 64, False, (256, 256), torch.float32),
    (2, 4, 100, 300, 32, True, None, torch.float32),
    (2, 4, 300, 100, 32, True, (1, 1, 300, 100), torch.float32),
    (1, 2, 33, 70, 128, False, (70,), torch.float32),
    (3, 2, 5, 1, 8, True, None, torch.float32),
])
def test_backward_kernels_match_plain_and_repeat(cuda, b, h, tq, tk, d,
                                                 causal, bias_shape, dtype):
    q = rnd(b, h, tq, d, seed=21, device=cuda, dtype=dtype)
    k = rnd(b, h, tk, d, seed=22, device=cuda, dtype=dtype)
    v = rnd(b, h, tk, d, seed=23, device=cuda, dtype=dtype)
    bias = (None if bias_shape is None
            else rnd(*bias_shape, seed=24, device=cuda))
    _check_backward(q, k, v, bias, causal)


def test_backward_on_a_fully_bias_masked_row_matches_plain(cuda):
    """Row 5 is masked on every key by an additive -1e9 (an all-padding
    row): lse rounds to -1e9, so the kernels recompute P = 1 there, as
    the plain versions and the Pallas kernels do
    (tests/test_torch_attention_grad.py pins those two together)."""
    q, k, v = (rnd(2, 4, 64, 32, seed=s, device=cuda) for s in (26, 27, 28))
    bias = rnd(2, 1, 64, 64, seed=29, device=cuda)
    bias[:, :, 5] = ak.NEG_INF
    _check_backward(q, k, v, bias, False)


def _check_backward(q, k, v, bias, causal):
    """Each backward kernel against its plain version on the forward
    kernel's lse, launched twice for the same bits."""
    b, h, tq, d = q.shape
    tk, dtype = k.shape[2], q.dtype
    cfg = dict(scale=d ** -0.5, causal=causal, causal_offset=tk - tq)
    out, lse = ak.flash_attention_fwd(q, k, v, bias, **cfg)
    do = rnd(b, h, tq, d, seed=25, device=q.device, dtype=dtype)
    args = (q, k, v, bias, do, lse, ak.attention_delta(out, do))
    pairs = [(ak.flash_attention_dq, ak.plain_attention_dq),
             (ak.flash_attention_dkv, ak.plain_attention_dkv)]
    if bias is not None:
        pairs.append((ak.flash_attention_dbias, ak.plain_attention_dbias))
    for kernel, plain in pairs:
        before = kernel.launches
        got, again = kernel(*args, **cfg), kernel(*args, **cfg)
        want = plain(*args, **cfg)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        got, again, want = ((x,) if torch.is_tensor(x) else x
                            for x in (got, again, want))
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a), kernel.__name__   # no atomics
            assert g.dtype == w.dtype and g.shape == w.shape
            if dtype == torch.bfloat16:
                assert torch.equal(g, w), kernel.__name__
            else:
                torch.testing.assert_close(g.float(), w.float(),
                                           **BWD_F32_TOL)


@pytest.mark.parametrize("bias_grad", [False, True])
def test_autograd_through_the_kernels_matches_cpu(cuda, bias_grad):
    """dot_product_attention under autograd on the card: forward #1,
    backward #2 and #3, and #4 only when the bias needs a gradient;
    the gradients equal autograd of plain_attention on the CPU."""
    shapes = [(2, 4, 48, 16), (2, 4, 80, 16), (2, 4, 80, 16),
              (2, 1, 48, 80)]
    host = [rnd(*s, seed=30 + i) for i, s in enumerate(shapes)]
    dout = rnd(2, 4, 48, 16, seed=35)
    wrappers = (ak.flash_attention_fwd, ak.flash_attention_dq,
                ak.flash_attention_dkv, ak.flash_attention_dbias)
    grads = {}
    for dev in ("cpu", cuda):
        ins = [x.detach().clone().to(dev).requires_grad_(i < 3 or bias_grad)
               for i, x in enumerate(host)]
        before = [w.launches for w in wrappers]
        out = ak.dot_product_attention(*ins[:3], ins[3], causal=True)
        (out * dout.to(dev)).sum().backward()
        torch.cuda.synchronize()
        used = [w.launches - n for w, n in zip(wrappers, before)]
        if dev == cuda:
            assert used == [1, 1, 1, int(bias_grad)]
        else:
            assert used == [0, 0, 0, 0]
        grads[str(dev)] = [x.grad.cpu() for x in ins if x.grad is not None]
    assert len(grads["cpu"]) == 3 + int(bias_grad)
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(g, w, **BWD_F32_TOL)


def test_training_steps_on_the_card_match_the_cpu(cuda):
    """Three f32 Optimizer steps of a small LM, card against CPU."""
    def run(dev):
        lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                           filter_size=128, max_len=64, padded_inputs=False,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
        rng = np.random.default_rng(1)
        batches = [MiniBatch(rng.integers(1, 65, (4, 64)),
                             rng.integers(1, 65, (256,)))
                   for _ in range(3)]
        opt = (Optimizer(FlatLM(lm), DataSet.array(batches, shuffle=False),
                         CrossEntropyCriterion())
               .set_optim_method(SGD(0.1, momentum=0.9, dampening=0.0))
               .set_end_when(Trigger.max_epoch(1)))
        before = ak.flash_attention_dkv.launches
        opt.optimize()
        return lm, opt, ak.flash_attention_dkv.launches - before

    lm_card, opt_card, launched = run(cuda)
    lm_cpu, opt_cpu, _ = run("cpu")
    assert launched == 2 * 3
    np.testing.assert_allclose(opt_card.state["loss"],
                               opt_cpu.state["loss"], rtol=1e-4)
    for (name, a), (_, b) in zip(lm_card.named_parameters(),
                                 lm_cpu.named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(),
                                   rtol=1e-3, atol=1e-4, msg=name)
