"""The recommender and autoencoder recipes of the port against the JAX
package's, on the CPU: ``NeuralCF``'s forward with the reference's
weights carried by name, ``synthetic_ratings`` and ``leave_one_out``
equal to the reference's, the MovieLens and MNIST readers, the two
example mains with ``--device cpu``, and ``optim/profiling.py``.

Restates ``tests/test_examples_cli.py`` :412 (the autoencoder main), :436
(the MovieLens reader, on a file written to ``tmp_path``), :454 (NCF's
shapes and leave-one-out) and :483 (the NCF main above chance), and
``tests/test_optim.py`` :423 (``module_forward_times`` and its unpatch).

Tolerance against the reference: NCF's scores float32 rtol 1e-5, atol
1e-6; the data splits equal.
"""

import gzip
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.dataset import movielens as jml
from bigdl_tpu.examples.ncf import leave_one_out as j_leave_one_out
from bigdl_tpu.models.ncf import NeuralCF as JNeuralCF
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import mnist as pmnist
from bigdl_tpu_torch.dataset import movielens as pml
from bigdl_tpu_torch.examples import autoencoder, ncf
from bigdl_tpu_torch.models import NeuralCF
from bigdl_tpu_torch.optim import module_forward_times, \
    times_by_module_type
from bigdl_tpu_torch.optim.profiling import profile_trace

from test_torch_rnn import carry, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _ncf_pair(users=12, items=20, embed=4):
    ref = JNeuralCF(users, items, embed_dim=embed)
    port = NeuralCF(users, items, embed_dim=embed,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    return ref, carry(ref, port)


def test_neural_cf_forward_matches_the_reference():
    ratings = pml.synthetic_ratings(n_users=12, n_items=20, per_user=5)
    pairs, _, eval_rows = ncf.leave_one_out(ratings, neg_train=3,
                                            neg_eval=10)
    ref, port = _ncf_pair()
    # training pairs and evaluation rows in one shape: one compile
    forward = jax.jit(ref.eval_mode().forward)
    for x in (pairs[:33].reshape(3, 11, 2), eval_rows[:3]):
        want = np.asarray(forward(jnp.asarray(x)))
        got = port.eval()(torch.tensor(x)).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(n_users=12, n_items=20, per_user=5),
                                dict(n_users=40, n_items=30, per_user=8,
                                     seed=3)])
def test_synthetic_ratings_and_leave_one_out_equal_the_reference(kw):
    ratings = pml.synthetic_ratings(**kw)
    np.testing.assert_array_equal(ratings, jml.synthetic_ratings(**kw))
    for neg_train, neg_eval in ((3, 10), (4, 40)):
        got = ncf.leave_one_out(ratings, neg_train, neg_eval, seed=1)
        want = j_leave_one_out(ratings, neg_train, neg_eval, seed=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_synthetic_id_stream_equals_the_reference():
    kw = dict(n_users=1000, n_items=500, batch_size=64, batches=3, seed=2)
    for (gp, gl), (wp, wl) in zip(pml.synthetic_id_stream(**kw),
                                  jml.synthetic_id_stream(**kw)):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError, match="int32"):
        next(pml.synthetic_id_stream(n_users=2 ** 31))


def test_movielens_reader(tmp_path):
    rows = "1::31::5::978300019\n2::12::3::978300020\n1::7::4::978300021\n"
    d = tmp_path / "ml-1m"
    d.mkdir()
    (d / "ratings.dat").write_text(rows)
    data = pml.read_data_sets(str(tmp_path))
    assert data.shape == (3, 4) and data[0, 1] == 31
    assert pml.get_id_pairs(str(tmp_path)).shape == (3, 2)
    assert pml.get_id_ratings(str(tmp_path))[1].tolist() == [2, 12, 3]
    np.testing.assert_array_equal(data, jml.read_data_sets(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        pml.read_data_sets(str(tmp_path / "nowhere"))


def test_ncf_model_shapes_and_leave_one_out():
    ratings = pml.synthetic_ratings(n_users=12, n_items=20, per_user=5)
    pairs, labels, eval_rows = ncf.leave_one_out(ratings, neg_train=3,
                                                 neg_eval=10)
    assert pairs.shape == (12 * 4 * (1 + 3), 2)
    assert labels.mean() == pytest.approx(0.25)
    assert eval_rows.shape == (12, 11, 2)
    for rows in eval_rows:
        u = rows[0, 0]
        seen = set(ratings[ratings[:, 0] == u][:, 1].tolist())
        assert int(rows[0, 1]) in seen
        assert not (set(rows[1:, 1].tolist()) & seen)
    m = NeuralCF(12, 20, embed_dim=4,
                 generator=torch.Generator().manual_seed(0),
                 device="cpu").eval()
    s1 = m(torch.tensor(pairs[:6]))
    s2 = m(torch.tensor(eval_rows[:3]))
    assert s1.shape == (6,) and s2.shape == (3, 11)
    assert float(s1.min()) >= 0.0 and float(s1.max()) <= 1.0


def test_ncf_main_learns_above_chance():
    """HitRatio@10 over 40-row evaluation lists (chance 0.25) ends well
    above chance."""
    m = ncf.main(["--synthetic", "640", "-e", "10", "-b", "32", "-r",
                  "0.005", "--embed-dim", "8", "-q", "--device", "cpu"])
    ratings = pml.synthetic_ratings(n_users=80, n_items=40, per_user=8)
    _, _, eval_rows = ncf.leave_one_out(ratings, 4, 39)
    with torch.no_grad():
        out = m.eval()(torch.tensor(eval_rows)).numpy()
    rank = (out > out[:, :1]).sum(axis=1) + 1
    hr = float((rank <= 10).mean())
    assert hr > 0.40, f"HitRatio@10 {hr} not above chance (0.25)"


def test_autoencoder_main_synthetic():
    """Reconstruction beats predicting the mean target, on the draw
    ``synthetic_split`` made for ``main``."""
    m = autoencoder.main(["--synthetic", "256", "-e", "5", "-b", "32", "-q",
                          "--device", "cpu"])
    train_s, _ = autoencoder.synthetic_split(256, 32)
    recon = autoencoder.to_reconstruction_samples(train_s[:64])
    x = np.stack([np.asarray(s.feature) for s in recon])
    t = np.stack([np.asarray(s.label) for s in recon])
    with torch.no_grad():
        out = m.eval()(torch.tensor(x)).numpy()
    mse = float(((out - t) ** 2).mean())
    base = float(((t.mean() - t) ** 2).mean())
    assert mse < base, (mse, base)


def test_the_examples_train_with_their_recipes():
    """The autoencoder's Adagrad (lr 0.01, weight decay 5e-4) on MSE, and
    NCF's Adam on BCE, as the reference's mains set them."""
    args = autoencoder.parse_args(["--synthetic", "64", "-e", "1", "-b", "16",
                                   "-q", "--device", "cpu"])
    _, opt = autoencoder.train(args)
    method = opt.optim_method
    assert type(method).__name__ == "Adagrad"
    assert (method.learning_rate, method.weight_decay) == (0.01, 5e-4)
    assert isinstance(opt.criterion, pnn.MSECriterion)
    ratings = pml.synthetic_ratings(n_users=10, n_items=30, per_user=4)
    _, opt = ncf.train(ncf.parse_args(["--synthetic", "1", "-e", "1", "-q",
                                       "-b", "8", "--device", "cpu", "-r",
                                       "0.003"]),
                       ratings=ratings)
    assert type(opt.optim_method).__name__ == "Adam"
    assert opt.optim_method.learning_rate == 0.003
    assert isinstance(opt.criterion, pnn.BCECriterion)
    assert [type(v).__name__ for v in opt.val_methods] == ["HitRatio", "NDCG"]


def test_examples_refuse_what_is_not_there():
    with pytest.raises(SystemExit, match="--folder"):
        ncf.main(["-q", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 13"):
        autoencoder.main(["--synthetic", "64", "--summary-dir", "/nowhere",
                          "-q", "--device", "cpu"])


def _write_idx(path, array):
    dims = array.shape
    magic = (8 << 8) | len(dims)
    with gzip.open(str(path) + ".gz", "wb") as f:
        f.write(struct.pack(">i", magic))
        f.write(struct.pack(">" + "i" * len(dims), *dims))
        f.write(array.astype(np.uint8).tobytes())


def test_mnist_reader_and_synthetic_equal_the_reference(tmp_path):
    from bigdl_tpu.dataset import mnist as jmnist
    rng = np.random.default_rng(0)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte",
               rng.integers(0, 256, (5, 28, 28)))
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 5))
    got = pmnist.mnist_samples(str(tmp_path), train=False)
    want = jmnist.mnist_samples(str(tmp_path), train=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.label == w.label
    for g, w in zip(pmnist.synthetic_mnist(20, seed=4),
                    jmnist.synthetic_mnist(20, seed=4)):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.label == w.label


def _mlp():
    gen = torch.Generator().manual_seed(2)
    return pnn.Sequential(pnn.Flatten(),
                          pnn.Linear(784, 32, generator=gen, device="cpu"),
                          pnn.Tanh(),
                          pnn.Linear(32, 10, generator=gen, device="cpu"),
                          pnn.LogSoftMax())


def test_module_forward_times_and_unpatch():
    model = _mlp().eval()
    x = torch.ones((2, 28, 28, 1))
    recs = module_forward_times(model, x)
    names = [t for _, t, _ in recs]
    assert names.count("Linear") == 2 and "Sequential" in names
    assert names[-1] == "Sequential" and recs[-1][0] == ""
    assert all(sec >= 0 for _, _, sec in recs)
    by_type = times_by_module_type(recs)
    assert by_type["Linear"][0] == 2
    assert "forward" not in model.__dict__
    assert torch.isfinite(model(x)).all()


def test_module_forward_times_restores_an_instance_forward():
    model = _mlp()
    calls = []
    lin = model.layers[1]
    orig = lin.forward

    def spy(*a):
        calls.append(1)
        return orig(*a)
    object.__setattr__(lin, "forward", spy)
    module_forward_times(model, torch.ones((1, 28, 28, 1)))
    assert lin.__dict__["forward"] is spy and calls == [1]


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        torch.ones(4) + 1
    assert (tmp_path / "trace.json").stat().st_size > 0
    # a profiler left running by a crashed capture does not block it
    orphan = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    orphan.start()
    with profile_trace(str(tmp_path / "again")):
        torch.ones(4) * 2
    assert (tmp_path / "again" / "trace.json").stat().st_size > 0
