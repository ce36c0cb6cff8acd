"""The port's CUDA flash-attention kernel on the card, against its plain
PyTorch version.  Every test here needs an NVIDIA GPU and skips without
one; the file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-4, atol 2e-5 (the kernel sums in another
order than cuBLAS); bfloat16 2e-2 (one bf16 ulp near 1).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import attention_kernels as ak

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

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
