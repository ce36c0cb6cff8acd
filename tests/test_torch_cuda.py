"""The port's CUDA kernels on the card (the flash-attention forward and
its dQ, dK/dV and dBias backward kernels; the ring-attention kernels
#5-#7; the fused conv+BN kernels #8-#11), against their plain PyTorch
versions, and training steps on the card against the CPU (and, for the
sequence-parallel LM, against the dense one).  Every test here needs an NVIDIA GPU and skips
without one; the file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-4, atol 2e-5 (the kernel sums in another
order than cuBLAS; 1e-4 for the backward's longer sums); the bfloat16
forward 2e-2 (one bf16 ulp near 1).
The bfloat16 dQ and dK/dV run on the tensor cores, which sum s and dP in
another order, so a P or dS now and then rounds to the neighbouring bf16
value: each entry within one bf16 ulp of the plain version's or of its
largest entry (or within the f32 rounding of the sums that feed it, where
dP - Delta cancels), at most 1% of the entries, or one query (dQ) or key
(dK, dV) row a head, differing (chip_smoke.bwd_held,
chip_smoke.bwd_floors); two launches bit for bit.
The bfloat16 forward (#1) runs on the tensor cores where its rows start
on 16 bytes and is held besides by the bias of its error
(chip_smoke.fwd_held), two launches bit for bit.
The ring kernels: #5's merged state as the forward (acc / l at the
dtype's tolerance, m and l at float32's); in bf16 #5 runs on the tensor
cores, and its state is held besides by the bias of its error
(chip_smoke.partial_state_held); #6 and #7 write float32, held to the
backward's float32 tolerance with f32 inputs; in bf16 both run on the
tensor cores with dO (and #7's P) split into bf16 pieces: #6's dQ and
#7's dK within one bf16 ulp, at most 1% (or one row a head) differing in
bf16 (chip_smoke.partial_ulp_held), #7's dV within 4x the plain
version's own error against an f64 sum (chip_smoke.dkv_partial_held).
The conv+BN kernels sum their products in another order than cuBLAS and
cuDNN: float32 outputs within 1e-4 of the plain output's largest entry;
bfloat16 outputs within one bf16 ulp of the plain version's entry (or
1e-5 of the largest entry, where a long sum cancels to near zero, below
both f32 sums' own rounding), with at most 1% of the entries differing;
the statistics within 1e-5 of sum |y - K| and of sum (y - K)^2, summed
from the kernel's own y.
"""

import numpy as np
import pytest
import torch

import chip_smoke

from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.examples.perf import FlatLM
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models import resnet as presnet
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.ops import attention_kernels as ak
from bigdl_tpu_torch.ops import conv_bn_kernels as ck
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
    # bf16 #1 on the tensor cores: causal offsets tk - tq of either sign,
    # D 32, 64 (padded from 40) and 128, Tq not a multiple of 64, biases
    # broadcast by strides (key stride 1 and not)
    (2, 4, 100, 300, 32, True, None, torch.bfloat16),
    (2, 4, 300, 100, 40, True, None, torch.bfloat16),
    (1, 2, 200, 250, 128, True, None, torch.bfloat16),
    (2, 8, 256, 256, 64, False, (2, 1, 256, 256), torch.bfloat16),
    (1, 2, 33, 70, 128, True, (70,), torch.bfloat16),
    (16, 8, 1, 512, 64, False, (16, 1, 1, 512), torch.bfloat16),
    (3, 2, 5, 1, 8, False, None, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, b, h, tq, tk, d, causal, bias_shape,
                              dtype):
    q = rnd(b, h, tq, d, seed=1, device=cuda, dtype=dtype)
    k = rnd(b, h, tk, d, seed=2, device=cuda, dtype=dtype)
    v = rnd(b, h, tk, d, seed=3, device=cuda, dtype=dtype)
    bias = (None if bias_shape is None
            else rnd(*bias_shape, seed=4, device=cuda))
    before = ak.flash_attention_fwd.launches
    routes = dict(ak.flash_attention_fwd.routes)
    got = ak.dot_product_attention(q, k, v, bias, causal=causal)
    want = ak.plain_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert ak.flash_attention_fwd.launches == before + 1
    routes["tensor_core" if dtype == torch.bfloat16 else "scalar"] += 1
    assert ak.flash_attention_fwd.routes == routes
    assert got.dtype == dtype and got.shape == (b, h, tq, d)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # bf16: besides, no bias in the error (chip_smoke.fwd_held)
    assert chip_smoke.fwd_held(got, want,
                               chip_smoke.seen_rows(tq, tk, causal))[2]
    again = ak.dot_product_attention(q, k, v, bias, causal=causal)
    assert torch.equal(got, again)


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


BF = torch.bfloat16


@pytest.mark.parametrize("b,h,tq,tk,d,causal,bias_shape,dtype", [
    (2, 8, 256, 256, 64, True, None, BF),
    # bf16 dK/dV (#3) at the edges of its tensor-core route
    (2, 8, 256, 256, 64, False, (2, 1, 256, 256), BF),  # a bias
    (2, 4, 100, 300, 32, True, None, BF),             # ragged causal, D 32
    (2, 4, 300, 100, 32, True, None, BF),             # rows that see no key
    (2, 4, 200, 250, 128, True, None, BF),            # D 128
    (1, 2, 70, 33, 36, False, None, BF),              # D 36: element loads
    (2, 8, 512, 512, 8, True, None, BF),              # D 8
    (2, 8, 384, 512, 16, True, None, BF),             # D 16, ragged
    (3, 2, 5, 1, 8, True, None, BF),                  # one key, 48 entries
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
    kernel's lse, launched twice for the same bits; dK/dV by the route of
    its dtype."""
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
    all_floors = chip_smoke.bwd_floors(*args, **cfg)
    routes = [dict(w.routes) for w in (ak.flash_attention_dq,
                                       ak.flash_attention_dkv)]
    for kernel, plain in pairs:
        before = kernel.launches
        got, again = kernel(*args, **cfg), kernel(*args, **cfg)
        want = plain(*args, **cfg)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        got, again, want = ((x,) if torch.is_tensor(x) else x
                            for x in (got, again, want))
        name = kernel.__name__.replace("flash_attention_", "")
        floors = {"dq": all_floors[:1], "dkv": all_floors[1:]}.get(
            name, (None,) * len(got))
        for g, a, w, f in zip(got, again, want, floors):
            assert torch.equal(g, a), kernel.__name__   # no atomics
            assert g.dtype == w.dtype and g.shape == w.shape
            if dtype == torch.bfloat16:
                assert chip_smoke.bwd_held(name, g, w, f)[2], kernel.__name__
            else:
                torch.testing.assert_close(g.float(), w.float(),
                                           **BWD_F32_TOL)
    # both dQ and both dK/dV launches took the route of the dtype
    for was, route, wrapper in zip(routes, (ak.dq_route, ak.dkv_route),
                                   (ak.flash_attention_dq,
                                    ak.flash_attention_dkv)):
        was[route(dtype)] += 2
        assert wrapper.routes == was, wrapper.__name__


def test_bf16_backward_holds_at_one_key_over_seeds(cuda):
    """Tk 1, causal: the one row that sees the key has P = 1 and dP = Δ
    in exact arithmetic, so its dS, dQ and dK are the rounding noise of
    dP − Δ; 30 seeds all hold under the rules with their rounding
    floor."""
    bf = torch.bfloat16
    for seed in range(30):
        q, k, v = (rnd(3, 2, t, 8, seed=1000 + 3 * seed + i, device=cuda,
                       dtype=bf) for i, t in enumerate((5, 1, 1)))
        _check_backward(q, k, v, None, True)


def _one_step(model, x, y, dtype):
    opt = (Optimizer(model, DataSet.array([MiniBatch(x, y)], shuffle=False),
                     CrossEntropyCriterion())
           .set_optim_method(SGD(0.01, momentum=0.9, dampening=0.0))
           .set_end_when(Trigger.max_iteration(1))
           .set_compute_dtype(dtype))
    opt.optimize()


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_lm_step_takes_one_dkv_route(cuda, dtype, route):
    """A bf16 LM step launches only the tensor-core forward (#1) and dK/dV
    (#3), an f32 step only the scalar ones: one launch each per layer."""
    lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=64, padded_inputs=False,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda)
    rng = np.random.default_rng(1)
    wrappers = (ak.flash_attention_fwd, ak.flash_attention_dkv)
    before = [dict(w.routes) for w in wrappers]
    _one_step(FlatLM(lm), rng.integers(1, 65, (4, 64)),
              rng.integers(1, 65, (256,)), dtype)
    torch.cuda.synchronize()
    for w, was in zip(wrappers, before):
        used = {r: w.routes[r] - was[r] for r in was}
        assert used == {"tensor_core": 0, "scalar": 0, route: 2}, \
            w.__name__


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_lm_step_takes_one_dq_route(cuda, dtype, route):
    """A bf16 LM step launches only the tensor-core dQ (#2), an f32 step
    only the scalar one: one launch per layer."""
    lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=64, padded_inputs=False,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda)
    rng = np.random.default_rng(1)
    was = dict(ak.flash_attention_dq.routes)
    _one_step(FlatLM(lm), rng.integers(1, 65, (4, 64)),
              rng.integers(1, 65, (256,)), dtype)
    torch.cuda.synchronize()
    used = {r: ak.flash_attention_dq.routes[r] - was[r] for r in was}
    assert used == {"tensor_core": 0, "scalar": 0, route: 2}


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_fused_resnet_step_takes_one_matmul_bwd_route(cuda, dtype, route):
    """A fused ResNet-50 step launches #9 32 times, all by the route of its
    dtype."""
    model = presnet.resnet50(10, fused=True,
                             generator=torch.Generator().manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(2)
    was = dict(ck.matmul_bn_bwd.routes)
    _one_step(model, rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
              rng.integers(1, 11, (2,)), dtype)
    torch.cuda.synchronize()
    used = {r: ck.matmul_bn_bwd.routes[r] - was[r] for r in was}
    assert used == {"tensor_core": 0, "scalar": 0, route: 32}


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_fused_resnet_step_takes_one_matmul_fwd_route(cuda, dtype, route):
    """A fused ResNet-50 step launches #8 32 times, all by the route of its
    dtype."""
    model = presnet.resnet50(10, fused=True,
                             generator=torch.Generator().manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(2)
    was = dict(ck.matmul_bn_fwd.routes)
    _one_step(model, rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
              rng.integers(1, 11, (2,)), dtype)
    torch.cuda.synchronize()
    used = {r: ck.matmul_bn_fwd.routes[r] - was[r] for r in was}
    assert used == {"tensor_core": 0, "scalar": 0, route: 32}


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_fused_resnet_step_takes_one_conv3x3_route(cuda, dtype, route):
    """A fused ResNet-50 step launches #10 and #11 13 times each, all by
    the route of its dtype."""
    model = presnet.resnet50(10, fused=True,
                             generator=torch.Generator().manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(2)
    wrappers = (ck.conv3x3_bn_fwd, ck.conv3x3_bn_bwd)
    before = [dict(w.routes) for w in wrappers]
    _one_step(model, rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
              rng.integers(1, 11, (2,)), dtype)
    torch.cuda.synchronize()
    for w, was in zip(wrappers, before):
        used = {r: w.routes[r] - was[r] for r in was}
        assert used == {"tensor_core": 0, "scalar": 0, route: 13}, \
            w.__name__


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "scalar")])
def test_ring_lm_step_takes_one_partial_route(cuda, dtype, route):
    """A step of an LM through ring attention over 4 shards launches #5,
    #6 and #7 once per layer and visible chunk pair (2 x 10), all by the
    route of its dtype."""
    from bigdl_tpu_torch.parallel import make_mesh
    lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=128, padded_inputs=False,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda)
    lm.set_sequence_parallel(make_mesh({"seq": 4}, ["cuda"] * 4))
    rng = np.random.default_rng(1)
    wrappers = (ak.flash_attention_partial, ak.flash_attention_dq_partial,
                ak.flash_attention_dkv_partial)
    before = [dict(w.routes) for w in wrappers]
    _one_step(FlatLM(lm), rng.integers(1, 65, (2, 128)),
              rng.integers(1, 65, (256,)), dtype)
    torch.cuda.synchronize()
    for w, was in zip(wrappers, before):
        used = {r: w.routes[r] - was[r] for r in was}
        assert used == {"tensor_core": 0, "scalar": 0, route: 20}, \
            w.__name__


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


# ---- the ring-attention kernels #5-#7 ----------------------------------------

@pytest.mark.parametrize("b,h,tq,tk,d,q_off,k_off,causal,dtype", [
    (2, 8, 256, 256, 64, 512, 256, True, torch.bfloat16),
    (2, 8, 256, 256, 64, 256, 256, True, torch.float32),
    (2, 4, 200, 200, 40, 200, 0, True, torch.float32),
    (1, 2, 70, 33, 16, 0, 100, False, torch.bfloat16),
    # bf16 #7 on the tensor cores: ragged D40, D128, a diagonal pair, a
    # pair whose first rows see no key
    (2, 4, 200, 200, 40, 200, 0, True, torch.bfloat16),
    (1, 4, 128, 128, 128, 256, 256, True, torch.bfloat16),
    (2, 2, 96, 160, 32, 0, 40, True, torch.bfloat16),
])
def test_ring_kernels_match_plain_and_repeat(cuda, b, h, tq, tk, d, q_off,
                                             k_off, causal, dtype):
    q = rnd(b, h, tq, d, seed=61, device=cuda, dtype=dtype)
    k = rnd(b, h, tk, d, seed=62, device=cuda, dtype=dtype)
    v = rnd(b, h, tk, d, seed=63, device=cuda, dtype=dtype)
    cfg = dict(q_offset=q_off, k_offset=k_off, scale=d ** -0.5,
               causal=causal)
    fresh = (torch.zeros(b, h, tq, d, device=cuda),
             torch.full((b, h, tq), ak.NEG_INF, device=cuda),
             torch.zeros(b, h, tq, device=cuda))
    # a carried state: a first merge of the diagonal chunk of these rows
    state = ak.plain_attention_partial(
        q, rnd(b, h, tq, d, seed=64, device=cuda, dtype=dtype),
        rnd(b, h, tq, d, seed=65, device=cuda, dtype=dtype), *fresh,
        q_offset=q_off, k_offset=q_off, scale=d ** -0.5, causal=causal)
    before = ak.flash_attention_partial.launches
    got, again = (ak.flash_attention_partial(q, k, v, *state, **cfg)
                  for _ in range(2))
    want = ak.plain_attention_partial(q, k, v, *state, **cfg)
    torch.cuda.synchronize()
    assert ak.flash_attention_partial.launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    acc, m, l = got
    torch.testing.assert_close(m, want[1], **F32_TOL)
    torch.testing.assert_close(l, want[2], **F32_TOL)
    torch.testing.assert_close(
        acc / l[..., None], want[0] / want[2][..., None],
        **(BF16_TOL if dtype == torch.bfloat16 else F32_TOL))

    do = rnd(b, h, tq, d, seed=66, device=cuda)
    lse = m + torch.log(l)
    delta = (do * (acc / l[..., None]).to(dtype).float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    bf16 = dtype == torch.bfloat16
    ring_bwd = (ak.flash_attention_dq_partial, ak.flash_attention_dkv_partial)
    routes = [dict(w.routes) for w in ring_bwd]
    for kernel, plain in ((ak.flash_attention_dq_partial,
                           ak.plain_attention_dq_partial),
                          (ak.flash_attention_dkv_partial,
                           ak.plain_attention_dkv_partial)):
        got, again = kernel(*args, **cfg), kernel(*args, **cfg)
        want = plain(*args, **cfg)
        torch.cuda.synchronize()
        got, again, want = ((x,) if torch.is_tensor(x) else x
                            for x in (got, again, want))
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a), kernel.__name__
            assert g.dtype == torch.float32 == w.dtype
        if bf16 and kernel is ak.flash_attention_dkv_partial:
            # #7 on the tensor cores: chip_smoke's dK and dV rules
            exact = chip_smoke.dkv_partial_exact_dv(*args, **cfg)
            checks, readings = chip_smoke.dkv_partial_held(got, want, exact)
            assert all(ok for _, _, ok in checks), (checks, readings)
            continue
        for g, w in zip(got, want):
            if bf16:     # #6 on the tensor cores: chip_smoke's dQ rule
                assert chip_smoke.partial_ulp_held(g, w)[2], kernel.__name__
            else:
                torch.testing.assert_close(g, w, **BWD_F32_TOL)
    for w, was, route in zip(ring_bwd, routes,
                             (ak.dq_partial_route(dtype),
                              ak.dkv_partial_route(dtype))):
        was[route] += 2
        assert w.routes == was, w.__name__


def _bf16_partial_problems():
    """chip_smoke's bf16 chunk pairs, and a pair whose first 100 rows see
    no key (q_offset < k_offset, overlapping), fresh state"""
    rows = [p for p in chip_smoke._partial_problems()
            if p[6] == torch.bfloat16]
    rows.append(("nokey_bf16", "B2 H4 Tc256 D64 bf16 0/100 causal",
                 (2, 4, 256, 256, 64), 0, 100, True, torch.bfloat16, False))
    return rows


def _bf16_ring_dq_problems():
    """chip_smoke's bf16 chunk pairs, and a pair whose first 100 rows see
    no key of the chunk, with the state carried from the rows' own
    diagonal chunk: lse is then a whole sequence's, finite, as the ring
    passes it (a fresh state's lse of a row that sees no key is -1e9 +
    log Tk, where P = exp(-1e9 - lse) is 1, not 0)"""
    rows = [p for p in chip_smoke._partial_problems()
            if p[6] == torch.bfloat16]
    rows.append(("nokey_carried_bf16", "B2 H4 Tc256 D64 bf16 0/100 causal",
                 (2, 4, 256, 256, 64), 0, 100, True, torch.bfloat16, True))
    return rows


@pytest.mark.parametrize("problem", _bf16_ring_dq_problems(),
                         ids=lambda p: p[0])
def test_bf16_ring_dq_on_the_tensor_cores_holds(cuda, problem):
    """#6 in bf16 takes the tensor-core route and holds against its plain
    version by chip_smoke's rule (partial_ulp_held); two launches give the
    same bits."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    calls = chip_smoke.partial_calls(*chip_smoke.partial_inputs(problem,
                                                                gen))
    before = dict(ak.flash_attention_dq_partial.routes)
    checks, same, _ = chip_smoke.check_partial("dq_partial", calls, problem)
    used = {r: ak.flash_attention_dq_partial.routes[r] - before[r]
            for r in before}
    assert used == {"tensor_core": 2, "scalar": 0}
    assert same
    assert all(ok for _, _, ok in checks), checks


@pytest.mark.parametrize("problem", _bf16_partial_problems(),
                         ids=lambda p: p[0])
def test_bf16_partial_merge_on_the_tensor_cores_holds(cuda, problem):
    """#5 in bf16 takes the tensor-core route and holds against its plain
    version by chip_smoke's rule (acc / l within BF16_TOL and without
    bias, m and l at float32's tolerance); two launches give the same
    bits."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    calls = chip_smoke.partial_calls(*chip_smoke.partial_inputs(problem,
                                                                gen))
    before = dict(ak.flash_attention_partial.routes)
    checks, same, extra = chip_smoke.check_partial("partial", calls, problem)
    used = {r: ak.flash_attention_partial.routes[r] - before[r]
            for r in before}
    assert used == {"tensor_core": 2, "scalar": 0}
    assert same
    assert all(ok for _, _, ok in checks), (checks, extra)


def test_bf16_partial_merge_of_unaligned_rows_takes_the_scalar_kernel(cuda):
    """bf16 rows that do not start on 16 bytes (D 20) cannot take the
    tensor cores' 16-byte copies: the wrapper launches the scalar kernel
    and counts it, and the state holds against the plain version."""
    b, h, tq, tk, d = 2, 4, 70, 33, 20
    q, k, v = (rnd(b, h, t, d, seed=s, device=cuda, dtype=torch.bfloat16)
               for s, t in ((81, tq), (82, tk), (83, tk)))
    state = (torch.zeros(b, h, tq, d, device=cuda),
             torch.full((b, h, tq), ak.NEG_INF, device=cuda),
             torch.zeros(b, h, tq, device=cuda))
    cfg = dict(q_offset=40, k_offset=10, scale=d ** -0.5, causal=True)
    assert not ak.rows_aligned(q, k, v)
    before = dict(ak.flash_attention_partial.routes)
    acc, m, l = ak.flash_attention_partial(q, k, v, *state, **cfg)
    want = ak.plain_attention_partial(q, k, v, *state, **cfg)
    torch.cuda.synchronize()
    used = {r: ak.flash_attention_partial.routes[r] - before[r]
            for r in before}
    assert used == {"tensor_core": 0, "scalar": 1}
    torch.testing.assert_close(m, want[1], **F32_TOL)
    torch.testing.assert_close(l, want[2], **F32_TOL)
    torch.testing.assert_close(acc / l[..., None],
                               want[0] / want[2][..., None], **BF16_TOL)


def test_unaligned_bf16_calls_take_the_scalar_route(cuda):
    """bf16 rows that do not start on 16 bytes (D 36) cannot take the
    tensor cores' 16-byte copies: #1, #6 and #7 launch their scalar
    templates and count them, and hold against the plain versions."""
    bf = torch.bfloat16
    q, k, v = (rnd(2, 4, t, 36, seed=s, device=cuda, dtype=bf)
               for s, t in ((84, 70), (85, 90), (86, 90)))
    assert not ak.rows_aligned(q, k, v)
    before = dict(ak.flash_attention_fwd.routes)
    got = ak.dot_product_attention(q, k, v, causal=True)
    want = ak.plain_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert {r: ak.flash_attention_fwd.routes[r] - before[r]
            for r in before} == {"tensor_core": 0, "scalar": 1}
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    qc = q[:, :, :64]
    do = rnd(2, 4, 64, 36, seed=87, device=cuda)
    lse = rnd(2, 4, 64, seed=88, device=cuda).abs() + 4.0
    delta = rnd(2, 4, 64, seed=89, device=cuda) * 0.1
    cfg = dict(q_offset=64, k_offset=0, scale=36 ** -0.5, causal=True)
    before = dict(ak.flash_attention_dkv_partial.routes)
    dk, dv = ak.flash_attention_dkv_partial(qc, k, v, do, lse, delta, **cfg)
    want = ak.plain_attention_dkv_partial(qc, k, v, do, lse, delta, **cfg)
    torch.cuda.synchronize()
    assert {r: ak.flash_attention_dkv_partial.routes[r] - before[r]
            for r in before} == {"tensor_core": 0, "scalar": 1}
    for g, w in zip((dk, dv), want):
        torch.testing.assert_close(g, w, **BWD_F32_TOL)
    before = dict(ak.flash_attention_dq_partial.routes)
    dq = ak.flash_attention_dq_partial(qc, k, v, do, lse, delta, **cfg)
    want = ak.plain_attention_dq_partial(qc, k, v, do, lse, delta, **cfg)
    torch.cuda.synchronize()
    assert {r: ak.flash_attention_dq_partial.routes[r] - before[r]
            for r in before} == {"tensor_core": 0, "scalar": 1}
    torch.testing.assert_close(dq, want, **BWD_F32_TOL)


def test_ring_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    x = rnd(1, 2, 32, 16, device=cuda)
    rows = torch.zeros(1, 2, 32, device=cuda)
    cfg = dict(q_offset=0, k_offset=0, scale=0.25)
    with pytest.raises(ValueError, match="acc must be"):
        ak.flash_attention_partial(x, x, x, x.half(), rows, rows, **cfg)
    with pytest.raises(ValueError, match="m must be"):
        ak.flash_attention_partial(x, x, x, x, rows[..., :5], rows, **cfg)
    with pytest.raises(ValueError, match="dO must be f32"):
        ak.flash_attention_dq_partial(x.bfloat16(), x.bfloat16(),
                                      x.bfloat16(), x.bfloat16(), rows,
                                      rows, **cfg)
    with pytest.raises(ValueError, match="q_offset"):
        ak.flash_attention_dkv_partial(x, x, x, x, rows, rows,
                                       q_offset=-1, k_offset=0, scale=0.25)


def test_ring_lm_step_on_the_card_matches_dense(cuda):
    """One f32 step of a small LM through ring attention over 4 shards on
    the card (#5-#7) against the same step through dense attention
    (#1-#3): loss within 1e-5, every gradient within 1e-3 in norm."""
    from bigdl_tpu_torch.parallel import make_mesh
    import copy
    lm = TransformerLM(64, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=128, padded_inputs=False,
                       generator=torch.Generator().manual_seed(3),
                       device=cuda)
    ring = copy.deepcopy(lm).set_sequence_parallel(
        make_mesh({"seq": 4}, ["cuda"] * 4))
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(1, 65, (2, 128)), device=cuda)
    y = torch.as_tensor(rng.integers(1, 65, (256,)), device=cuda)
    results = []
    for model in (ring, lm):
        before = (ak.flash_attention_partial.launches,
                  ak.flash_attention_dkv_partial.launches,
                  ak.flash_attention_fwd.launches)
        loss = CrossEntropyCriterion()(model(x).reshape(-1, 65), y)
        loss.backward()
        torch.cuda.synchronize()
        used = (ak.flash_attention_partial.launches - before[0],
                ak.flash_attention_dkv_partial.launches - before[1],
                ak.flash_attention_fwd.launches - before[2])
        results.append((float(loss), dict(model.named_parameters()), used))
    (loss_r, p_r, used_r), (loss_d, p_d, used_d) = results
    assert used_r == (2 * 10, 2 * 10, 0) and used_d == (0, 0, 2)
    assert abs(loss_r - loss_d) <= 1e-5 * abs(loss_d)
    for name, p in p_d.items():
        err = float((p_r[name].grad - p.grad).norm() / p.grad.norm())
        assert err <= 1e-3, name


# ---- the fused conv+BN kernels #8-#11 ---------------------------------------

def _held(got, want, what, exact=None):
    """The conv+BN check: f32 within 1e-4 of the plain output's largest
    entry; bf16 within one ulp of each entry (or 1e-5 of the largest,
    where a long sum cancels to near zero) and at most 1% differing.
    With ``exact``, the same function with its sums in f64, an entry also
    holds within that bound of the exact value: where a long f32 sum
    cancels, the plain version's own rounding (its library's summation
    order) can take it further from the exact value than the kernel's."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if want.dtype == torch.float32:
        assert float((g - w).abs().max()) <= 1e-4 * max(top, 1e-30), what
        return

    def near(ref):     # the ulp in f32, as chip_smoke reckons it
        ulp = chip_smoke._bf16_ulp(ref.float()).double()
        return (g.double() - ref).abs() <= ulp.clamp_min(1e-5 * top)

    held = near(w.double())
    if exact is not None:
        held |= near(exact.double())
    at = (~held).nonzero()[:4].tolist()
    assert not at, (what, [(i, float(g[tuple(i)]), float(w[tuple(i)]),
                            None if exact is None
                            else float(exact[tuple(i)])) for i in at])
    assert float((g != w).float().mean()) <= 0.01, what


def _exact_grads(x, w, vec, y, dy, gm, gs, fuse, stats):
    """dx and dW of the 1x1 (#9) or 3x3 (#11) backward with every sum in
    f64, rounded where the plain version rounds (z, the folded dy, dx)."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    mean, scale, beta, kshift = vec
    z = ck._z(x, ck._vectors(mean, scale, beta, fuse)).double()
    wd = w.double()
    if w.dim() == 2:
        dyl = ck._fold(dy, y, kshift, gm, gs, stats).double()
        dw, dz, dims = z.t() @ dyl, dyl @ wd.t(), (0,)
    else:
        dyl = ck._nchw(ck._fold(dy, y, kshift, gm, gs, stats).double())
        dz = conv2d_input(ck._nchw(x).shape, ck._oihw(wd), dyl, padding=1)
        dw = conv2d_weight(ck._nchw(z), ck._oihw(wd).shape, dyl, padding=1)
        dz, dw, dims = dz.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0), \
            (0, 1, 2)
    dx = ck._input_side(x, dz, mean, scale, beta, fuse, dims)[0]
    return {"dx": dx, "dw": dw}


def _stats_held(s1, s2, y, kshift):
    yk = y.float() - kshift
    dims = tuple(range(y.dim() - 1))
    assert bool(((s1 - yk.sum(dims)).abs()
                 <= 1e-5 * yk.abs().sum(dims) + 1e-6).all())
    s2_own = (yk * yk).sum(dims)
    assert bool(((s2 - s2_own).abs() <= 1e-5 * s2_own + 1e-6).all())


def _conv_inputs(shape_x, c, co, dtype, seed):
    x = rnd(*shape_x, seed=seed, device="cuda", dtype=dtype) * 1.5
    w_shape = (c, co) if len(shape_x) == 2 else (3, 3, c, co)
    w = (rnd(*w_shape, seed=seed + 1, device="cuda") * 0.2).to(dtype)
    vec = (rnd(c, seed=seed + 2, device="cuda") * 0.1,
           rnd(c, seed=seed + 3, device="cuda").abs() + 0.5,
           rnd(c, seed=seed + 4, device="cuda") * 0.2,
           rnd(co, seed=seed + 5, device="cuda") * 0.05)
    return x, w, vec


def _check_conv_kernels(fwd, bwd, pfwd, pbwd, x, w, vec, fuse, stats):
    flags = dict(fuse_input=fuse, emit_stats=stats)
    kshift = vec[3]
    launched = (fwd.launches, bwd.launches)
    fwd_routes = dict(fwd.routes)    # both launches take the dtype's route
    fwd_routes[(ck.matmul_fwd_route if w.dim() == 2
                else ck.conv3x3_fwd_route)(x.dtype)] += 2
    y, s1, s2 = fwd(x, w, *vec, **flags)
    again = fwd(x, w, *vec, **flags)
    want = pfwd(x, w, *vec, **flags)
    torch.cuda.synchronize()
    assert all(a is None or torch.equal(a, b) for a, b in
               zip((y, s1, s2), again))              # no atomics
    _held(y, want[0], "y")
    if stats:
        _stats_held(s1, s2, y, kshift)
    co = w.shape[-1]
    dy = rnd(*y.shape, seed=90, device="cuda", dtype=x.dtype)
    gm = rnd(co, seed=91, device="cuda") * 0.1
    gs = rnd(co, seed=92, device="cuda") * 0.1
    assert fwd.routes == fwd_routes
    routes = dict(bwd.routes)
    # both backwards fold the forward kernel's saved y
    got = bwd(x, w, *vec, y, dy, gm, gs, **flags)
    again = bwd(x, w, *vec, y, dy, gm, gs, **flags)
    want = pbwd(x, w, *vec, y, dy, gm, gs, **flags)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (launched[0] + 2,
                                            launched[1] + 2)
    # #9 and #11: both launches took the route of the dtype
    routes[(ck.matmul_bwd_route if w.dim() == 2
            else ck.conv3x3_bwd_route)(x.dtype)] += 2
    assert bwd.routes == routes
    exact = (_exact_grads(x, w, vec, y, dy, gm, gs, fuse, stats)
             if x.dtype == torch.bfloat16 else {})
    for g, a, p, what in zip(got, again, want, ("dx", "dw", "dsx", "dsu")):
        assert torch.equal(g, a), what
        if what in ("dsx", "dsu"):
            if fuse:
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-3)
        else:
            _held(g, p, what, exact.get(what))


@pytest.mark.parametrize("m,k,n", [(100, 24, 40), (100, 24, 72),
                                   (4096, 64, 256), (6272, 512, 2048),
                                   (25088, 1024, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse,stats", [(False, True), (True, True),
                                        (True, False)])
def test_matmul_bn_kernels_match_plain(cuda, m, k, n, dtype, fuse, stats):
    x, w, vec = _conv_inputs((m, k), k, n, dtype, seed=40)
    _check_conv_kernels(ck.matmul_bn_fwd, ck.matmul_bn_bwd,
                        ck.plain_matmul_bn_fwd, ck.plain_matmul_bn_bwd,
                        x, w, vec, fuse, stats)


@pytest.mark.parametrize("b,h,wd,c,co", [
    (2, 3, 7, 4, 8), (4, 14, 14, 64, 64), (8, 7, 7, 512, 512),
    (8, 56, 56, 64, 64), (8, 28, 28, 128, 128),
    (8, 14, 14, 256, 256),              # ResNet-50's 3x3s, batch cut
    (3, 3, 7, 20, 72), (1, 5, 3, 72, 20),   # ragged: C, Co, H, W and M
    (16, 5, 5, 64, 64)])  # each 128-row tile spans several images
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse,stats", [(False, False), (False, True),
                                        (True, True)])
def test_conv3x3_bn_kernels_match_plain(cuda, b, h, wd, c, co, dtype, fuse,
                                        stats):
    x, w, vec = _conv_inputs((b, h, wd, c), c, co, dtype, seed=60)
    _check_conv_kernels(ck.conv3x3_bn_fwd, ck.conv3x3_bn_bwd,
                        ck.plain_conv3x3_bn_fwd, ck.plain_conv3x3_bn_bwd,
                        x, w, vec, fuse, stats)


def test_conv_bn_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = rnd(8, 4, device=cuda)
    v = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ck.matmul_bn_fwd(x.half(), x.half()[:4], v, v, v, v,
                         fuse_input=False, emit_stats=False)
    with pytest.raises(ValueError, match="contiguous"):
        ck.matmul_bn_fwd(x.t().contiguous().t(), x[:4].t(), v, v, v, v,
                         fuse_input=False, emit_stats=False)
    with pytest.raises(ValueError, match="shape"):
        ck.matmul_bn_fwd(x, x[:4], v[:3], v, v, v, fuse_input=True,
                         emit_stats=False)


def test_fused_bottleneck_on_the_card_matches_the_cpu(cuda):
    """One f32 train-mode fused Bottleneck (conv1 and conv3 through #8/#9,
    conv2 through #10/#11) on the card against its CPU copy (the plain
    versions): output, running statistics and every gradient."""
    import copy
    blk = presnet.Bottleneck(64, 16, fused=True,
                             generator=torch.Generator().manual_seed(0),
                             device=cuda)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2, blk.bn3):
            bn.weight.uniform_(0.5, 1.5)
    cpu = copy.deepcopy(blk).to("cpu")
    x = rnd(4, 14, 14, 64, seed=70)
    r = rnd(4, 14, 14, 64, seed=71)
    wrappers = ck._KERNELS
    before = [k.launches for k in wrappers]
    outs = {}
    for dev, mod in ((cuda, blk), ("cpu", cpu)):
        xt = x.to(dev).requires_grad_()
        out = mod.train()(xt)
        (out * r.to(dev)).sum().backward()
        outs[str(dev)] = (out.detach().cpu(), xt.grad.cpu(),
                          {n: p.grad.cpu() for n, p in mod.named_parameters()},
                          {n: b.cpu() for n, b in mod.named_buffers()})
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(wrappers, before)] == [2, 2, 1, 1]
    card, host = outs[str(cuda)], outs["cpu"]
    torch.testing.assert_close(card[0], host[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card[1], host[1], rtol=1e-3, atol=1e-4)
    for name in host[2]:
        scale = float(host[2][name].abs().max())
        torch.testing.assert_close(card[2][name], host[2][name], rtol=0,
                                   atol=1e-3 * scale, msg=name)
    for name in host[3]:
        torch.testing.assert_close(card[3][name], host[3][name], rtol=1e-4,
                                   atol=1e-5, msg=name)
