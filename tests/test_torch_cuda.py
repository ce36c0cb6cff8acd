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
#1's mixed entry (f32 q, bf16 K/V: a bf16 KV cache) by chip_smoke's f32
rule (mixed_held: at most 1% of the entries beyond F32_TOL of the plain
version and of an f64 anchor, every entry within one bf16 ulp of its P's);
beam search on the card against a CPU copy by chip_smoke.beams_held
(every decision equal, or the first different one at a near-tie; scores
within F32_TOL of the largest logit they are summed from).
The conv+BN kernels sum their products in another order than cuBLAS and
cuDNN: float32 outputs within 1e-4 of the plain output's largest entry;
bfloat16 outputs within one bf16 ulp of the plain version's entry (or
1e-5 of the largest entry, where a long sum cancels to near zero, below
both f32 sums' own rounding), with at most 1% of the entries differing;
the statistics within 1e-5 of sum |y - K| and of sum (y - K)^2, summed
from the kernel's own y.
``DevicePrefetch`` copies batches on its producer's own stream; each batch
the step reads behind a long kernel holds what the host held, exactly.
The zoo models of the perf CLI (Inception-v1, Inception-v2, VGG-16, the
PTB LSTM LM), one f32 step on the card and on a CPU copy, TF32 off, at
chip_smoke's conditioned sizes and held by its bounds (``ZOO_PARITY``:
the loss within 1e-5, each gradient within 1e-2 in norm and 5e-2 of its
largest entry for the image models, 1e-3 and 1e-2 for the LM), no kernel
of #1-#11 launched.
Detection: the port's NMS on the card equal to its CPU path (indices and
validity), and chip_smoke's detection gate passing the port and refusing
each of chip_gate_controls.py's detection faults.
Optim methods: each method's CUDA-graph windows on LeNet-5 equal to its
eager run bit for bit, and chip_smoke's methods gate passing the port
and refusing each of chip_gate_controls.py's methods faults.
The recommender: dedup_gather's backward on the card against the CPU
(chip_smoke.dedup_held: bit for bit for runs of up to three rows, within
1e-6 of the largest update beyond), a Cond's host predicate refused in a
captured step, WideAndDeep's windows equal to its eager run bit for bit,
and chip_smoke's recommender and ops_9b checks passing the port and
refusing each of chip_gate_controls.py's recommender faults.
"""

import numpy as np
import pytest
import torch

import chip_smoke

from bigdl_tpu_torch.data import DevicePrefetch
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
    kernels = dict(ak.flash_attention_fwd.kernels)
    got = ak.dot_product_attention(q, k, v, bias, causal=causal)
    want = ak.plain_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert ak.flash_attention_fwd.launches == before + 1
    routes["tensor_core" if dtype == torch.bfloat16 else "scalar"] += 1
    assert ak.flash_attention_fwd.routes == routes
    kernels[ak.fwd_kernel(dtype, ak.rows_aligned(q, k, v), dtype, tq)] += 1
    assert ak.flash_attention_fwd.kernels == kernels
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
        # every route of the wrapper (#1 has a third, "mixed_kv") but one
        # taken no time
        want = dict.fromkeys(was, 0)
        want[route] = 2
        assert used == want, w.__name__


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
            for r in before} == {"tensor_core": 0, "scalar": 1,
                                 "mixed_kv": 0}
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


def test_device_prefetch_hands_over_what_the_step_reads(cuda):
    """The producer copies on a stream of its own; the step reads each
    batch behind a long kernel, after its reference is dropped.  Without
    the consumer's wait on the copy's event, or without ``record_stream``
    (the allocator would hand the block back to the copy stream for a
    later batch before the step read it), the sums would differ."""
    batches = [MiniBatch(np.full((512, 1024), i, np.float32),
                         np.arange(512)) for i in range(12)]
    it = DevicePrefetch(2, device=cuda).apply(iter(batches))
    sums, streams = [], set()
    for b in it:
        x = b.get_input()
        assert x.is_cuda and b.get_target().is_cuda
        torch.cuda._sleep(2_000_000)   # the step still runs
        sums.append(x.sum(dtype=torch.float64))
        streams.add(torch.cuda.current_stream().cuda_stream)
        del b, x
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [512 * 1024 * i for i in range(12)]
    assert it.staged_total == 12
    assert it.copy_stream is not None
    assert it.copy_stream.cuda_stream not in streams


def test_prefix_cache_round_trip_and_rows_on_the_card(cuda):
    """A kv_extract of a decoding slot, copied into a free slot after the
    source slot was reused, reproduces the slot's K/V and pad bit for
    bit; the shared-prefix harness serves cache on and off by the serving
    rule (equal, or a near-tie), with hits only with the cache."""
    from bigdl_tpu_torch.serving import run_shared_prefix_workload
    lm = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=512,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda).eval()
    equal, size = chip_smoke.kv_round_trip(lm, cuda)
    assert equal and size == 2 * 2 * 4 * 128 * 16 * 4 + 128
    out = run_shared_prefix_workload(
        lm, n_requests=8, prefix_len=128, tail=(4, 40), max_new=6,
        slots=4, prefix_granularity=64, prefill_chunk=64,
        oracle_sample=0, device=cuda)
    assert out["cache"]["prefix_cache"]["hits"] > 0
    assert out["nocache"]["prefix_chunks_copied"] == 0
    failed = []
    chip_smoke.rows_held(lm, out["prompts"], out["rows"]["cache"],
                         out["rows"]["nocache"], "cache on vs off", failed)
    chip_smoke.rows_held(
        lm, out["prompts"][:2], out["rows"]["cache"][:2],
        [lm.generate(p[None], 6)[0].cpu().numpy()
         for p in out["prompts"][:2]], "cache on vs solo", failed)
    assert not failed, failed


def test_lm_served_one_shot_on_the_card(cuda):
    """chip_smoke's oneshot phase at a small LM: every reply within
    F32_TOL of the row's solo forward on the card (argmax equal bar a
    near-tie), 83 requests counted, #1 at layers x (batches + 5 warm-up
    buckets) launches, all scalar."""
    lm = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=128,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda).eval()
    r = chip_smoke.oneshot_lm_reading(cuda, lm=lm, length=64)
    assert not r["failed"], r["failed"]
    assert r["metrics"]["requests"] == chip_smoke.ONESHOT_REQUESTS


def test_concurrent_predictions_count_every_launch(cuda):
    """A PredictionService over the LM from 4 threads at once: every
    forward launches #1 once a layer, and the counts hold all of them."""
    import threading
    from bigdl_tpu_torch.optim import PredictionService
    lm = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=128,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda).eval()
    svc = PredictionService(lm, concurrency=4, device=cuda)
    rows = np.random.default_rng(3).integers(1, 513, (20, 2, 32))
    outs = [None] * len(rows)
    chip_smoke._zero_counts()

    def work(t):
        for i in range(t, len(rows), 4):
            outs[i] = svc.predict(rows[i])
    workers = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert ak.flash_attention_fwd.launches == 2 * len(rows)
    assert ak.flash_attention_fwd.routes == {"tensor_core": 0,
                                             "scalar": 2 * len(rows),
                                             "mixed_kv": 0}
    with torch.inference_mode():
        for x, y in zip(rows, outs):
            torch.testing.assert_close(torch.from_numpy(y).to(cuda), lm(x),
                                       **F32_TOL)


# ---- #1's mixed entry and beam search ---------------------------------------

@pytest.mark.parametrize("b,tq,bias_shape", [
    (16, 1, (16, 1, 1, 512)),         # the pooled decode
    (1, 128, (1, 1, 128, 512)),       # a 128-wide chunk prefill
    (3, 5, None),                     # ragged, no bias
    (1, 1, (1, 1, 1, 512)),           # a one-request decode
    (32, 1, (32, 1, 1, 512)),         # a beam-wide decode
    (8, 128, (8, 1, 1, 512)),         # eight chunks: the tiles in one block
])
def test_mixed_kv_entry_matches_plain(cuda, b, tq, bias_shape):
    """f32 q with bf16 k and v takes the mixed entry, counted as
    "mixed_kv" and by the kernel that ran (decode at Tq 1, tile beyond),
    and holds against the plain version by chip_smoke's rule; two launches
    give the same bits."""
    q = rnd(b, 8, tq, 64, seed=91, device=cuda)
    k, v = (rnd(b, 8, 512, 64, seed=s, device=cuda, dtype=BF)
            for s in (92, 93))
    bias = None
    if bias_shape is not None:
        bias = torch.where(rnd(*bias_shape, seed=94, device=cuda) > 1.5,
                           -1e9, 0.0)
    before = dict(ak.flash_attention_fwd.routes)
    kernels = dict(ak.flash_attention_fwd.kernels)
    got = ak.dot_product_attention(q, k, v, bias)
    again = ak.dot_product_attention(q, k, v, bias)
    want = ak.plain_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert {r: ak.flash_attention_fwd.routes[r] - before[r]
            for r in before} == {"tensor_core": 0, "scalar": 0,
                                 "mixed_kv": 2}
    ran = "decode" if tq == 1 else "tile"
    assert {n: ak.flash_attention_fwd.kernels[n] - kernels[n]
            for n in kernels} == dict(dict.fromkeys(kernels, 0), **{ran: 2})
    assert got.dtype == torch.float32 and torch.equal(got, again)
    err, beyond, ok = chip_smoke.mixed_held(
        got, want, chip_smoke.mixed_anchor(q, k, v, bias))
    assert ok, (err, beyond)


def test_the_kernels_refuse_other_dtype_mixes(cuda):
    q = rnd(2, 2, 4, 16, seed=95, device=cuda)
    kb = q.to(BF)
    for args in ((kb, q, q), (q, kb, q), (q, q.half(), q.half()),
                 (q, kb, kb.half())):
        with pytest.raises(TypeError):
            ak.flash_attention_fwd(*args, scale=0.25)
    lse = torch.zeros(4, 4, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        ak.flash_attention_dq(q, kb, kb, None, q, lse, lse, scale=0.25)
    with pytest.raises(TypeError, match="one dtype"):
        ak.flash_attention_partial(
            q, kb, kb, torch.zeros(4, 4, 16, device=cuda), lse, lse,
            q_offset=0, k_offset=0, scale=0.25)
    with pytest.raises(TypeError, match="mixed dtypes"):
        ak.dot_product_attention(q.requires_grad_(), kb, kb)


def test_generate_beam_on_the_card_matches_a_cpu_copy(cuda):
    """A two-layer LM's generate_beam (no EOS, and an EOS it emits) on the
    card against a CPU copy, by chip_smoke.beams_held; #1 by its scalar
    route at batch x beam rows."""
    gen = torch.Generator().manual_seed(0)
    lm = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=64, generator=gen,
                       device=cuda).eval()
    cpu = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                        filter_size=128, max_len=64,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu").eval()
    prompts = np.random.default_rng(5).integers(1, 513, (3, 12))
    prompts[1, :4] = 0
    eos = int(lm.generate(prompts, 1)[0, -1])
    failed = []
    for eos_id in (-1, eos):
        chip_smoke._zero_counts()
        with chip_smoke.recorded_decisions() as card:
            got = lm.generate_beam(prompts, beam_size=3, max_new_tokens=10,
                                   eos_id=eos_id)
        assert ak.flash_attention_fwd.routes["scalar"] > 0
        assert ak.flash_attention_fwd.routes["tensor_core"] == 0
        with chip_smoke.recorded_decisions() as host, \
                chip_smoke.logit_peaks(cpu) as peaks:
            want = cpu.generate_beam(prompts, beam_size=3, max_new_tokens=10,
                                     eos_id=eos_id)
        chip_smoke.beams_held(got, want, card, host, f"eos {eos_id}", failed,
                              max(peaks))
    assert not failed, failed


def test_bf16_kv_cache_served_on_the_card_matches_the_cpu(cuda):
    """A bf16 KV cache under the f32 LM on the card (the mixed entry) and
    on the CPU (the plain version): the same rows bar a near-tie."""
    from bigdl_tpu_torch.serving import GenerationScheduler
    lm = TransformerLM(512, hidden_size=64, num_layers=2, num_heads=4,
                       filter_size=128, max_len=128,
                       generator=torch.Generator().manual_seed(0),
                       device=cuda).eval()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 513, n).astype(np.int32)
               for n in (5, 40, 70, 9)]
    rows = {}
    for dev in (cuda, "cpu"):
        engine = GenerationScheduler(lm, slots=4, prefill_chunk=32,
                                     dtype=torch.bfloat16, device=dev)
        try:
            rows[str(dev)] = [engine.submit(p, 12, timeout=300)
                              for p in prompts]
        finally:
            engine.shutdown()
    failed = []
    chip_smoke.rows_held(lm, prompts, rows["cuda"], rows["cpu"], "bf16 kv",
                         failed)
    assert not failed, failed


# ---- #1's decode (A) and tile (B) kernels for f32 q --------------------------

def _bias(kind, b, tq, tk, seed, lead=0):
    """A -1e9/0 bias of shape [B, 1, 1, Tk] ("keys") or [B, 1, Tq, Tk]
    ("rows"), or None; ``lead`` keys at the front masked on every row (a
    left-padded prompt)."""
    if kind is None:
        return None
    shape = (b, 1, 1, tk) if kind == "keys" else (b, 1, tq, tk)
    x = torch.from_numpy(np.random.RandomState(seed).rand(*shape)
                         .astype(np.float32))
    bias = torch.where(x > 0.85, -1e9, 0.0)
    bias[..., :lead] = -1e9
    if lead:
        bias[..., -1] = 0.0      # every row sees a key
    return bias


def _qkv(b, tq, tk, d, kv, strided, seed):
    """q f32 and k, v of dtype ``kv``, contiguous or as the model lays its
    heads out ([B, T, H, D] viewed as [B, H, T, D])."""
    h = 4
    if strided:
        return (rnd(b, tq, h, d, seed=seed, device="cuda").transpose(1, 2),
                *(rnd(b, tk, h, d, seed=seed + i, device="cuda", dtype=kv)
                  .transpose(1, 2) for i in (1, 2)))
    return (rnd(b, h, tq, d, seed=seed, device="cuda"),
            *(rnd(b, h, tk, d, seed=seed + i, device="cuda", dtype=kv)
              for i in (1, 2)))


# (b, tq, tk, d, bias, causal, strided, leading masked keys): B 1, 16 and
# 32; Tk below one split (50), not a multiple of 16 (300, 517); D 32, 64
# and 128; biases over keys and over rows; causal with an offset either
# way; the model's head layout; a fully masked leading split (128 keys)
# and tile (64 keys)
NEW_KERNEL_CASES = [
    (16, 1, 512, 64, "keys", False, False, 0),
    (1, 1, 512, 64, "keys", False, False, 0),
    (32, 1, 160, 64, "keys", False, True, 100),
    (32, 1, 50, 32, None, False, False, 0),
    (1, 1, 517, 128, "rows", True, False, 0),
    (16, 1, 300, 64, "keys", False, False, 128),
    (1, 128, 512, 64, "rows", False, False, 0),
    (4, 127, 127, 64, "rows", True, False, 0),
    (16, 33, 300, 32, "keys", False, True, 64),
    (2, 100, 300, 128, None, True, False, 0),
    (1, 70, 40, 64, None, True, False, 0),
    (32, 64, 128, 64, "keys", False, True, 0),
    (1, 2, 517, 64, "rows", False, False, 128),
]


@pytest.mark.parametrize("kv", [torch.float32, BF], ids=["f32", "mixed"])
@pytest.mark.parametrize("case", NEW_KERNEL_CASES,
                         ids=[f"b{c[0]}q{c[1]}k{c[2]}d{c[3]}"
                              for c in NEW_KERNEL_CASES])
def test_decode_and_tile_kernels_match_plain(cuda, case, kv):
    """f32 q (f32 or bf16 K/V, 16-byte rows) runs the decode kernel at
    Tq 1 and the tile kernel beyond, counted by kernel; each holds
    against the plain version (f32 by F32_TOL, the mixed entry by
    chip_smoke.mixed_held), writes the lse, and repeats bit for bit."""
    b, tq, tk, d, kind, causal, strided, lead = case
    q, k, v = _qkv(b, tq, tk, d, kv, strided, seed=200 + tk)
    bias = _bias(kind, b, tq, tk, seed=300 + tq, lead=lead)
    if bias is not None:
        bias = bias.to(cuda)
    assert ak.rows_aligned(q, k, v)
    ran = "decode" if tq == 1 else "tile"
    kernels = dict(ak.flash_attention_fwd.kernels)
    cfg = dict(scale=d ** -0.5, causal=causal, causal_offset=tk - tq)
    out, lse = ak.flash_attention_fwd(q, k, v, bias, **cfg)
    again, lse2 = ak.flash_attention_fwd(q, k, v, bias, **cfg)
    want, want_lse = ak.plain_attention_fwd(q, k, v, bias, **cfg)
    torch.cuda.synchronize()
    assert {n: ak.flash_attention_fwd.kernels[n] - kernels[n]
            for n in kernels} == dict(dict.fromkeys(kernels, 0), **{ran: 2})
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert torch.isfinite(out).all()
    if kv == BF:
        err, beyond, ok = chip_smoke.mixed_held(
            out, want, chip_smoke.mixed_anchor(q, k, v, bias))
        assert ok, (err, beyond)
    else:
        torch.testing.assert_close(out, want, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)


@pytest.mark.parametrize("kv", [torch.float32, BF], ids=["f32", "mixed"])
@pytest.mark.parametrize("tq", [1, 128])
def test_a_row_does_not_depend_on_its_neighbours_or_masked_keys(cuda, tq,
                                                                kv):
    """A row computed among others equals, bit for bit, the same row
    computed alone and over a Tk extended by keys the bias masks: the
    decode row among 16 slots, the chunk row among 9 requests (the tiles
    in one block: 9 x 4 heads x 4 row blocks fill an H100's 132 SMs) and
    alone (the tiles spread over blocks and merged)."""
    b, tk, d = (16, 512, 64) if tq == 1 else (9, 512, 64)
    q, k, v = _qkv(b, tq, tk, d, kv, False, seed=400 + tq)
    bias = _bias("rows", b, tq, tk, seed=401).to(cuda)
    scale = d ** -0.5
    many, lse = ak.flash_attention_fwd(q, k, v, bias, scale=scale)
    i = b // 2
    alone, lse1 = ak.flash_attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                         bias[i:i + 1], scale=scale)
    extra = 300
    k2, v2 = (torch.cat([t[i:i + 1], rnd(1, 4, extra, d, seed=402,
                                         device=cuda, dtype=kv)], 2)
              for t in (k, v))
    bias2 = torch.cat([bias[i:i + 1],
                       torch.full((1, 1, tq, extra), -1e9, device=cuda)], -1)
    longer, lse2 = ak.flash_attention_fwd(q[i:i + 1], k2, v2, bias2,
                                          scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(alone, many[i:i + 1])
    assert torch.equal(longer, many[i:i + 1])
    rows = lse.reshape(b, 4, tq)[i].reshape(4, tq)
    assert torch.equal(lse1, rows) and torch.equal(lse2, rows)


def test_the_new_kernels_refuse_rows_not_on_16_bytes(cuda):
    """Unaligned f32 rows (D 36 is 16 bytes a row, D 34 is not) take the
    scalar template by the routing rule, counted as such; the C entry
    refuses them for the new kernels (no fall-back)."""
    q, k, v = (rnd(2, 4, t, 34, seed=s, device=cuda)
               for s, t in ((501, 1), (502, 90), (503, 90)))
    assert not ak.rows_aligned(q, k, v)
    kernels = dict(ak.flash_attention_fwd.kernels)
    got = ak.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert ak.flash_attention_fwd.kernels["scalar_template"] == \
        kernels["scalar_template"] + 1
    torch.testing.assert_close(got, ak.plain_attention(q, k, v), **F32_TOL)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ak._launch_fwd(q, k, v, None, 34 ** -0.5, False, 0, "scalar",
                       "decode")


@pytest.mark.parametrize("model", sorted(chip_smoke.ZOO_PARITY))
def test_zoo_model_step_on_the_card_matches_the_cpu(cuda, model):
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = chip_smoke.zoo_parity(model)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert not any(r["launches"].values())
    assert r["ok"]


def test_nms_on_the_card_matches_its_cpu_path(cuda):
    """The port's batched NMS on the card equal to the same call on the
    CPU (indices and validity) on chip_smoke's planted rows and on
    random rows, with and without a pre-top-k cap."""
    from bigdl_tpu_torch.nn import nms
    rows = chip_smoke.planted_nms_rows("cpu")
    rng = np.random.RandomState(34)
    b = rng.rand(6, 300, 4).astype(np.float32) * 50
    b[..., 2:] += b[..., :2] + 1
    s = rng.rand(6, 300).astype(np.float32)
    rows += [("random", torch.from_numpy(b), torch.from_numpy(s), 0.5, 64,
              None),
             ("random_pre_topk", torch.from_numpy(b), torch.from_numpy(s),
              0.45, 40, 100)]
    for what, boxes, scores, thresh, m, pre in rows:
        want = nms(boxes, scores, thresh, m, pre)
        got = nms(boxes.to(cuda), scores.to(cuda), thresh, m, pre)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), what


@pytest.mark.parametrize("fault", [
    None, "nms_at_or_above_threshold", "nms_first_step_skipped",
    "topk_in_place_of_stable_sort", "transposed_conv_kernel_flipped"])
def test_detection_gate_refuses_each_fault(cuda, fault):
    """chip_smoke's detection gate passes the port as it stands and
    refuses an NMS at IoU >= the threshold, an NMS loop without its first
    step, torch.topk in place of the stable sort, and a transposed
    convolution over its flipped kernel (chip_gate_controls.py, 12)."""
    import chip_gate_controls
    refused_by = chip_gate_controls.detection_gate_under(fault)
    assert bool(refused_by) == (fault is not None), refused_by


@pytest.mark.parametrize("name", sorted(chip_smoke.method_cases()))
def test_method_windows_equal_eager_on_the_card(cuda, name):
    """Each optim method on LeNet-5 (b256, f32) in CUDA-graph windows of
    4 (two windows and a ragged tail) equal to its eager run bit for bit:
    losses, parameters and every state tensor (deterministic algorithms
    on)."""
    make = chip_smoke.method_cases()[name]
    model, criterion, batches = chip_smoke.lenet_setup()
    with chip_smoke.deterministic():
        eager, e_opt, _ = chip_smoke.lenet_method_run(
            model, criterion, batches, make(), 1, cuda)
        graph, g_opt, _ = chip_smoke.lenet_method_run(
            model, criterion, batches, make(), chip_smoke.METHOD_WINDOW,
            cuda)
    assert g_opt.dispatch_stats["replays"] == 8
    assert e_opt.loss_history == g_opt.loss_history
    for p, q in zip(eager.parameters(), graph.parameters()):
        assert torch.equal(p, q)
    assert chip_smoke._state_equal(e_opt._opt_states, g_opt._opt_states)


@pytest.mark.parametrize("fault", [
    None, "adam_bias_correction_as_python_floats",
    "step_scalars_not_refilled_before_a_replay",
    "plateau_not_told_the_score"])
def test_methods_gate_refuses_each_fault(cuda, fault):
    """chip_smoke's methods gate passes the port as it stands and refuses
    Adam's bias corrections baked at the capture, a graph's step scalars
    not refilled before a replay and Plateau not told the score
    (chip_gate_controls.py, 13)."""
    import chip_gate_controls
    refused_by, _ = chip_gate_controls.methods_gate_under(fault)
    assert bool(refused_by) == (fault is not None), refused_by


# ---- int8 inference and the Tree-LSTM ----------------------------------------

@pytest.mark.parametrize("kind,shape", [
    ("lenet_conv1_k25_n6", (1, 28, 28, 1)),
    ("stem_7x7s2", (4, 64, 64, 3)),
    ("fc6_dilated6", (2, 19, 19, 32)),
    ("linear_k25_n6_b1", (1, 25)),
    ("linear_1d", (25,)),
])
def test_int8_layers_on_the_card_equal_the_plain_version(cuda, kind, shape):
    """The int8 layers' ``_int_mm`` path on the card, padded to its shape
    rules where K or N is not a multiple of 8 or the rows are 16 or
    fewer, against the float64 plain version: int32 sums and outputs bit
    for bit; ``torch._int_mm`` ran."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import quantized as q
    g = torch.Generator().manual_seed(3)
    layer = {
        "lenet_conv1_k25_n6": lambda: nn.SpatialConvolution(
            1, 6, 5, 5, generator=g, device=cuda),
        "stem_7x7s2": lambda: nn.SpatialConvolution(
            3, 64, 7, 7, 2, 2, 3, 3, generator=g, device=cuda),
        "fc6_dilated6": lambda: nn.SpatialDilatedConvolution(
            32, 24, 3, 3, 1, 1, 6, 6, 6, 6, generator=g, device=cuda),
    }.get(kind, lambda: nn.Linear(25, 6, generator=g, device=cuda))()
    ql = q.quantize(layer)
    x = rnd(*shape, seed=4, device=cuda)
    rows = x if x.dim() > 1 else x[None]
    with torch.no_grad(), chip_smoke.int_mm_calls() as calls:
        qx, sx, acc = ql.accumulate(rows)
        out = ql(x)
    assert calls[0] >= 2
    with torch.no_grad(), chip_smoke.plain_products():
        assert torch.equal(acc, ql.accumulate(rows)[2])
        assert torch.equal(out, ql(x))


def test_quantizer_on_the_card_leaves_no_float_layer():
    """Quantizer over ResNet-50 and SSD-300 on the card: no
    SpatialConvolution, SpatialDilatedConvolution or Linear of exact
    type is left, and the buffers are int8 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import resnet50, ssd_vgg16_300
    from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                              QuantizedSpatialConvolution,
                                              quantize)
    g = torch.Generator().manual_seed(0)
    for model in (resnet50(1000, generator=g, device="cuda"),
                  ssd_vgg16_300(21, generator=g, device="cuda")):
        q = quantize(model)
        floats = [type(m).__name__ for m in q.modules()
                  if type(m) in (nn.SpatialConvolution,
                                 nn.SpatialDilatedConvolution, nn.Linear)]
        assert floats == []
        quantized = [m for m in q.modules() if isinstance(
            m, (QuantizedLinear, QuantizedSpatialConvolution))]
        assert quantized and all(
            m.qweight.dtype == torch.int8 and m.qweight.is_cuda
            for m in quantized)


def test_tree_lstm_in_a_cuda_graph_equals_eager(cuda):
    """The Tree-LSTM example's forward and backward over 128 slots,
    captured once as a CUDA graph and replayed on new trees, equal to the
    eager run bit for bit."""
    from bigdl_tpu_torch.examples import treelstm_sentiment as ts
    parsed = ts._synthetic_trees(64, 2000, 128, seed=0)
    toks, ch, leaf, y = ts.trees_to_arrays(parsed, ts.vocabulary(parsed,
                                                                 2000),
                                          128, 64)
    model = ts.build_model(2000, 64, 64, 5,
                           generator=torch.Generator().manual_seed(0),
                           device=cuda)
    criterion = torch.nn.NLLLoss()
    batches = [tuple(torch.tensor(a[s], device=cuda) for a in
                     (toks, ch, leaf, y - 1))
               for s in (slice(0, 32), slice(32, 64))]

    def step(inputs):
        model.zero_grad(set_to_none=False)
        loss = criterion(model(inputs[:3]), inputs[3].long())
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in model.parameters()]

    eager = [step(b) for b in batches]
    static = [t.clone() for t in batches[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss, grads = step(static)
    for b, (want_loss, want_grads) in zip(batches, eager):
        for s, t in zip(static, b):
            s.copy_(t)
        graph.replay()
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(a, w) for a, w in zip(grads, want_grads))


@pytest.mark.parametrize("fault", [None, "round_half_away_from_zero",
                                   "weight_scale_per_tensor",
                                   "int8_conv_drops_its_dilation",
                                   "tree_children_swapped",
                                   "unpadded_int_mm_rescued_by_the_plain_"
                                   "version"])
def test_int8_checks_refuse_each_fault(cuda, fault):
    """chip_smoke's int8 gate and Tree-LSTM check pass the port as it
    stands and refuse each of chip_gate_controls.py's int8 faults (14)."""
    import chip_gate_controls
    refused_by = chip_gate_controls.int8_checks_under(fault)
    assert bool(refused_by) == (fault is not None), refused_by


def test_batchnorm_eval_on_the_card_equals_the_cpu_bit_for_bit(cuda):
    """An eval-mode BatchNorm gives the CPU's bits on the card: 1 / sqrt
    in float64 in place of the card's approximate float32 rsqrt and sqrt,
    each op correctly rounded (an int8 layer after it would turn an ulp
    into int8 steps).  4096 channels: the float32 sqrt of ResNet-50's
    blocks parted from the CPU's in one or two channels of 256-1024."""
    from bigdl_tpu_torch import nn
    g = torch.Generator().manual_seed(5)
    n = 4096
    bn = nn.SpatialBatchNormalization(n, generator=g, device="cpu").eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(n, generator=g) + 0.5)
        bn.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    x = rnd(2, 4, 4, n, seed=6)
    want = bn(x)
    got = bn.to(cuda)(x.to(cuda)).cpu()
    assert torch.equal(got, want)


def test_dedup_gather_backward_on_the_card_matches_the_cpu(cuda):
    """dedup_gather's backward on the card: the CPU's bits where no id
    repeats more than three times, within 1e-6 of the largest update
    beyond (a fixed-order scan, not atomics), the same bits twice."""
    rows, failed = chip_smoke.dedup_held("cuda")
    assert not failed, (failed, rows)


def test_a_host_predicate_is_refused_in_a_captured_step(cuda):
    """A Cond whose predicate is a tensor trains eagerly on the card, and
    raises, naming the capture, when the Optimizer's windows capture the
    step (a replay would take the captured branch)."""
    from bigdl_tpu_torch import nn, ops

    class Branch(nn.Module):
        def __init__(self):
            super().__init__()
            self.cond = ops.Cond(nn.Identity(), nn.Tanh())

        def forward(self, x):
            return self.cond((x.sum() > 0, x))

    def run(k):
        g = torch.Generator().manual_seed(0)
        model = nn.Sequential(nn.Linear(4, 4, generator=g, device=cuda),
                              Branch())
        data = DataSet.array([MiniBatch(rnd(8, 4, seed=i).numpy(),
                                        rnd(8, 4, seed=9 + i).numpy())
                              for i in range(4)], shuffle=False)
        from bigdl_tpu_torch.nn.criterion import MSECriterion
        return (Optimizer(model, data, MSECriterion())
                .set_optim_method(SGD(0.1)).set_end_when(Trigger.max_epoch(1))
                .set_iterations_per_dispatch(k)).optimize()

    run(1)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        run(2)


def test_wide_and_deep_windows_equal_eager_on_the_card(cuda):
    """WideAndDeep at 64 users x 32 items, 8 steps on the card in windows
    of 4 (CUDA graph replays), deterministic algorithms on: the eager
    run's losses and parameters bit for bit."""
    from bigdl_tpu_torch.models import WideAndDeep
    batches = chip_smoke.rec_batches(64, 32, 16, 8, seed=6)
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for k in (1, 4):
            model = WideAndDeep(64, 32, 8, (16,),
                                generator=torch.Generator().manual_seed(8),
                                device=cuda)
            opt = chip_smoke.rec_optimizer(
                model, chip_smoke.rec_dataset(batches, "cuda"), k=k, epochs=1)
            opt.optimize()
            runs.append((opt, model))
    finally:
        torch.use_deterministic_algorithms(was)
    (eager, em), (graph, gm) = runs
    assert graph.dispatch_stats["replays"] == 8
    assert eager.loss_history == graph.loss_history
    assert all(torch.equal(p, q) for p, q in zip(em.parameters(),
                                                 gm.parameters()))


@pytest.mark.parametrize("fault", [None, "dedup_scatters_a_row_per_occurrence",
                                   "deep_gradient_dropped_for_every_7th_sample",
                                   "dense_lookup_with_0_based_ids",
                                   "eval_resume_skips_one_batch_too_few",
                                   "top_k_by_an_unstable_sort",
                                   "floor_div_truncates"])
def test_recommender_checks_refuse_each_fault(cuda, fault):
    """chip_smoke's recommender step check, eval resume and ops_9b checks
    pass the port as it stands and refuse each of chip_gate_controls.py's
    recommender faults (15)."""
    import chip_gate_controls
    refused_by = chip_gate_controls.recommender_checks_under(fault)
    assert bool(refused_by) == (fault is not None), refused_by
