"""The port's checkpoint files (``bigdl_tpu_torch/utils/file.py``) against
the JAX package's: the reference's ``TestAtomicWrites`` and
``TestCheckpointManager`` (``tests/test_fault_tolerance.py``) restated
against the port, the round trip of every node tag in both directions
between the packages, and a checkpoint written by either package's
``Optimizer`` resumed in the other.

The cross-package resume runs LeNet-5 with two method groups of SGD with
momentum 0.9 for 3 epochs of 4 iterations; the writer checkpoints every
epoch and the other package resumes generation 5 (after epoch 1).  Each
is held against the writing package's uninterrupted run: ``neval``,
``epoch`` and ``records`` equal, the losses of epochs 2-3 within rtol
1e-5 and every parameter within 1e-4 relative in norm, the tolerances of
``tests/test_torch_lenet.py``'s trajectory test (the reference's step is
an SPMD program over 8 CPU devices, so its sums go in another order).
"""

import json
import os
import zlib

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.core.module import param_paths
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import file as jfile
from bigdl_tpu.utils import set_seed
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.interop import flatten_jax_parameters, \
    load_jax_parameters, nest_jax_parameters
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import chaos
from bigdl_tpu_torch.utils.file import (
    CheckpointManager, load_checkpoint, load_pytree, save_checkpoint,
    save_pytree,
)

LOSS_RTOL, PARAM_NORM_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


# --------------------------------------------------------------------------
# the format: every node tag, both ways
# --------------------------------------------------------------------------

def _every_tag():
    return {"none": None, "bool": True, "int": 7, "float": 2.5,
            "str": "s", 3: "an int key",
            "list": [np.arange(3, dtype=np.int32), [1, 2]],
            "tuple": (np.float32(1.5), np.zeros((2, 0), np.float64)),
            "nested": {"a": {"b": np.ones((2, 3), np.float32)}},
            "scalar": np.asarray(4, np.int32),
            "bool_arr": np.array([True, False])}


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_every_node_tag_round_trips_between_the_packages(tmp_path, writer):
    tree = _every_tag()
    p = str(tmp_path / "t.npz")
    (save_pytree if writer == "port" else jfile.save_pytree)(tree, p)
    want = dict(tree, tuple=(np.asarray(np.float32(1.5)),
                             tree["tuple"][1]))
    for load in (load_pytree, jfile.load_pytree):
        _assert_same_tree(load(p), want)


def test_the_payload_members_are_the_references(tmp_path):
    """The same tree written by both packages: the same members, the
    same structure descriptor and the same arrays, dtypes included."""
    tree = {"model": {"params": {"w": np.arange(6, dtype=np.float32)}},
            "optim": [{"t": np.asarray(3, np.int32)}], "k": (1, None)}
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_pytree(tree, a)
    jfile.save_pytree(tree, b)
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for name in za.files:
            assert za[name].dtype == zb[name].dtype
            np.testing.assert_array_equal(za[name], zb[name])


def test_refuses_what_item_11_holds(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        save_pytree({"w": np.ones(2)}, "gs://bucket/t.npz")
    with pytest.raises(NotImplementedError, match="item 11"):
        CheckpointManager(str(tmp_path)).save(*_ckpt_state(1.0),
                                              generation=1, sharded=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        load_checkpoint(str(tmp_path / "checkpoint.1.orbax"))
    with pytest.raises(NotImplementedError, match="item 11"):
        Optimizer(LeNet5(10, generator=torch.Generator(), device="cpu"),
                  [], pnn.ClassNLLCriterion()) \
            .set_checkpoint(str(tmp_path), Trigger.every_epoch(),
                            sharded=True)


def test_nest_inverts_flatten():
    set_seed(1)
    ref = jmodels.resnet_cifar(20)
    params = jax.tree_util.tree_map(np.asarray, ref.parameters())
    flat = flatten_jax_parameters(params)
    nested = nest_jax_parameters(flat)
    assert jax.tree_util.tree_structure(nested) == \
        jax.tree_util.tree_structure(params)
    assert list(flatten_jax_parameters(nested)) == list(flat)


# --------------------------------------------------------------------------
# atomic writes (the reference's TestAtomicWrites)
# --------------------------------------------------------------------------

class TestAtomicWrites:
    def test_save_leaves_no_tmp_file(self, tmp_path):
        p = str(tmp_path / "t.npz")
        crc, size = save_pytree({"w": np.arange(8, dtype=np.float32)}, p)
        assert size == os.path.getsize(p) and crc
        assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []

    def test_failed_write_leaves_previous_file_intact(self, tmp_path):
        p = str(tmp_path / "t.npz")
        save_pytree({"w": np.arange(8, dtype=np.float32)}, p)
        chaos.install(io_fail_p=1.0)
        with pytest.raises(OSError, match="injected IO failure"):
            save_pytree({"w": np.zeros(8, np.float32)}, p)
        chaos.reset()
        np.testing.assert_array_equal(load_pytree(p)["w"],
                                      np.arange(8, dtype=np.float32))

    def test_crc_matches_payload_bytes(self, tmp_path):
        p = str(tmp_path / "t.npz")
        crc, size = save_pytree({"a": np.ones((3, 3), np.float32)}, p)
        data = open(p, "rb").read()
        assert (zlib.crc32(data) & 0xFFFFFFFF, len(data)) == (crc, size)


# --------------------------------------------------------------------------
# CheckpointManager (the reference's TestCheckpointManager)
# --------------------------------------------------------------------------

def _ckpt_state(v: float):
    model = {"params": {"w": np.full((4,), v, np.float32)}, "buffers": {}}
    return model, [{"t": np.asarray(1)}], {"epoch": 1, "neval": int(v)}


class TestCheckpointManager:
    def test_save_and_latest_good_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        path = mgr.save(*_ckpt_state(3.0), generation=3)
        assert mgr.latest_good() == path
        _model, _opt, scalars = load_checkpoint(path)
        assert scalars["neval"] == 3

    def test_overwrite_mode_records_true_generation(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(*_ckpt_state(3.0), generation=3, overwrite=True)
        path = mgr.save(*_ckpt_state(5.0), generation=5, overwrite=True)
        assert os.path.basename(path) == "checkpoint.npz"
        man = json.loads(
            (tmp_path / "checkpoint.manifest.json").read_text())
        assert man["generation"] == 5 and man["crc32"]

    def test_latest_good_skips_truncated_generation(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        good = mgr.save(*_ckpt_state(3.0), generation=3)
        torn = mgr.save(*_ckpt_state(5.0), generation=5)
        with open(torn, "r+b") as f:
            f.truncate(64)
        assert mgr.latest_good() == good

    def test_latest_good_skips_uncommitted_generation(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        good = mgr.save(*_ckpt_state(3.0), generation=3)
        (tmp_path / "checkpoint.9.npz").write_bytes(b"PK\x03\x04 torn")
        assert mgr.latest_good() == good

    def test_latest_good_walks_back_multiple_generations(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        good = mgr.save(*_ckpt_state(1.0), generation=1)
        for g in (2, 3):
            p = mgr.save(*_ckpt_state(float(g)), generation=g)
            with open(p, "r+b") as f:
                f.truncate(32)
        assert mgr.latest_good() == good

    def test_latest_good_none_when_everything_corrupt(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        p = mgr.save(*_ckpt_state(1.0), generation=1)
        with open(p, "r+b") as f:
            f.truncate(16)
        assert mgr.latest_good() is None

    def test_legacy_unmanifested_checkpoint_still_found(self, tmp_path):
        save_checkpoint(str(tmp_path / "checkpoint.7.npz"),
                        *_ckpt_state(7.0))
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.latest_good() == str(tmp_path / "checkpoint.7.npz")

    def test_gc_keeps_exactly_keep_n_good_generations(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for g in range(1, 6):
            mgr.save(*_ckpt_state(float(g)), generation=g)
        kept = sorted(f for f in os.listdir(tmp_path)
                      if f.endswith(".npz"))
        assert kept == ["checkpoint.4.npz", "checkpoint.5.npz"]
        assert sorted(mgr.generations()) == [4, 5]

    def test_gc_does_not_count_torn_generation_toward_keep_n(
            self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        mgr.save(*_ckpt_state(1.0), generation=1)
        mgr.save(*_ckpt_state(2.0), generation=2)
        c = chaos.install(truncate_checkpoint=1, truncate_keep_bytes=16)
        mgr.save(*_ckpt_state(3.0), generation=3)
        assert any("truncated" in e for e in c.events)
        chaos.reset()
        good = [f for f in sorted(os.listdir(tmp_path))
                if f.endswith(".npz")]
        assert "checkpoint.1.npz" in good and "checkpoint.2.npz" in good

    def test_gc_sweeps_stale_tmp_files(self, tmp_path):
        stale = tmp_path / ".checkpoint.3.npz.tmp-123-dead"
        stale.write_bytes(b"partial")
        os.utime(stale, (0, 0))
        mgr = CheckpointManager(str(tmp_path), keep_n=1)
        mgr.save(*_ckpt_state(1.0), generation=1)
        assert not stale.exists()

    def test_remote_paths_are_item_11(self):
        """The reference's fsspec case: the port refuses a remote
        directory, naming the item that ports it."""
        with pytest.raises(NotImplementedError, match="item 11"):
            CheckpointManager("memory://bigdl_ft_test/ckpts")

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_each_manager_walks_back_the_others_generations(
            self, tmp_path, writer):
        """Manifests are shared: a torn generation written by one
        package is walked back past by the other's manager."""
        mgr = (CheckpointManager if writer == "port"
               else jfile.CheckpointManager)(str(tmp_path))
        good = mgr.save(*_ckpt_state(3.0), generation=3)
        torn = mgr.save(*_ckpt_state(5.0), generation=5)
        with open(torn, "r+b") as f:
            f.truncate(64)
        for other in (CheckpointManager, jfile.CheckpointManager):
            assert other(str(tmp_path)).latest_good() == good


# --------------------------------------------------------------------------
# cross-package resume: LeNet-5, SGD with momentum, two method groups
# --------------------------------------------------------------------------

BATCHES, BATCH, EPOCHS = 4, 16, 3
GROUPS = {"conv1_5x5": (0.05, 0.9), "layers": (0.02, 0.9)}


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(BATCHES):
        y = rng.integers(1, 11, size=(BATCH,))
        x = rng.normal(size=(BATCH, 28, 28, 1)).astype(np.float32)
        x[:, :10, :10, 0] += (y[:, None, None] - 5.5).astype(np.float32) / 3
        out.append((x, y))
    return out


def _ref_run(ckpt_dir=None, resume=None, seed=2):
    """The reference's LeNet for EPOCHS epochs; returns (model,
    optimizer, {neval: loss})."""
    set_seed(seed)
    model = jmodels.LeNet5(10)
    losses = {}

    def end(s):
        if s["neval"] > 1:
            losses[s["neval"] - 1] = s["loss"]
        return s["epoch"] > EPOCHS
    opt = (JOptimizer(model, JDataSet.array(
        [JMiniBatch(x, y) for x, y in _batches()], shuffle=False),
        jnn.ClassNLLCriterion())
        .set_optim_methods({k: JSGD(lr, momentum=m, dampening=0.0)
                            for k, (lr, m) in GROUPS.items()})
        .set_end_when(JTrigger(end, "record", needs_loss=True)))
    if ckpt_dir is not None:
        opt.set_checkpoint(str(ckpt_dir), JTrigger.every_epoch(),
                           is_overwrite=False)
    if resume is not None:
        opt.resume(resume)
    opt.optimize()
    return model, opt, losses


def _port_run(ckpt_dir=None, resume=None, init=None):
    """The port's LeNet (weights from the reference's ``init`` where
    given) for EPOCHS epochs; returns (model, optimizer, {neval: loss})."""
    model = LeNet5(10, generator=torch.Generator().manual_seed(9),
                   device="cpu")
    if init is not None:
        load_jax_parameters(model, init)
    opt = (Optimizer(model, DataSet.array(
        [MiniBatch(x, y) for x, y in _batches()], shuffle=False),
        pnn.ClassNLLCriterion())
        .set_optim_methods({k: SGD(lr, momentum=m, dampening=0.0)
                            for k, (lr, m) in GROUPS.items()})
        .set_end_when(Trigger.max_epoch(EPOCHS)))
    if ckpt_dir is not None:
        opt.set_checkpoint(str(ckpt_dir), Trigger.every_epoch(),
                           is_overwrite=False)
    if resume is not None:
        opt.resume(resume)
    opt.optimize()
    return model, opt, dict(opt.loss_history)


def _assert_resumed(writer, reader, writer_losses, reader_losses,
                    writer_params, reader_params):
    for key in ("neval", "epoch", "records"):
        assert reader.state[key] == writer.state[key], key
    steps = range(BATCHES + 1, BATCHES * EPOCHS + 1)
    np.testing.assert_allclose([reader_losses[i] for i in steps],
                               [writer_losses[i] for i in steps],
                               rtol=LOSS_RTOL)
    for name, want in writer_params.items():
        got = reader_params[name]
        assert np.linalg.norm(got - want) / np.linalg.norm(want) \
            <= PARAM_NORM_REL, name


def _np_params(model):
    if isinstance(model, torch.nn.Module):
        return {n: p.detach().numpy() for n, p in model.named_parameters()}
    return flatten_jax_parameters(
        jax.tree_util.tree_map(np.asarray, model.parameters()))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    ref, ref_opt, ref_losses = _ref_run(tmp_path)
    gen5 = str(tmp_path / "checkpoint.5.npz")
    port, port_opt, port_losses = _port_run(resume=gen5)
    _assert_resumed(ref_opt, port_opt, ref_losses, port_losses,
                    _np_params(ref), _np_params(port))
    assert port_opt.dispatch_stats["single_steps"] == BATCHES * 2


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    set_seed(2)
    init = jax.tree_util.tree_map(np.asarray,
                                  jmodels.LeNet5(10).parameters())
    port, port_opt, port_losses = _port_run(tmp_path, init=init)
    gen5 = str(tmp_path / "checkpoint.5.npz")
    ref, ref_opt, ref_losses = _ref_run(resume=gen5, seed=7)
    _assert_resumed(port_opt, ref_opt, port_losses, ref_losses,
                    _np_params(port), _np_params(ref))


def test_group_lists_follow_the_parameter_order(tmp_path):
    """In a checkpoint of either package the parameter dict's keys are
    sorted at every level (the reference writes it through
    ``jax.tree_util.tree_map``: ``layers[10]`` before ``layers[1]``,
    ``bias`` before ``weight``), while each group's ``velocity`` list is
    in ``param_paths`` order, the module's own: a reader that took the
    lists in the dict's order would pair each bias with a weight."""
    set_seed(2)
    model = jmodels.LeNet5(10)
    paths = [p.replace("[", ".").replace("]", "") for p in
             param_paths(model)]
    groups = [[p for p in paths if p.startswith("layers.1.")],
              [p for p in paths if not p.startswith("layers.1.")]]
    params = flatten_jax_parameters(
        jax.tree_util.tree_map(np.asarray, model.parameters()))
    _ref_run(tmp_path / "ref")
    _port_run(tmp_path / "port", init=model.parameters())
    for d in ("ref", "port"):
        model_state, optim, scalars = load_checkpoint(
            str(tmp_path / d / "checkpoint.5.npz"))
        file_order = list(flatten_jax_parameters(model_state["params"]))
        # the order of jax's own tree_map, which sorts dict keys
        assert file_order == list(params), d
        assert file_order[:2] == ["layers.10.bias", "layers.10.weight"], d
        for g, members in enumerate(groups):
            shapes = [v.shape for v in optim[g]["velocity"]]
            assert shapes == [params[p].shape for p in members], (d, g)
            assert optim[g]["t"].dtype == np.int32 and optim[g]["t"] == 4
        assert list(optim[0]) == ["t", "velocity"]
        assert list(scalars) == ["epoch", "neval", "records", "loss",
                                "score", "is_epoch_end"], d
