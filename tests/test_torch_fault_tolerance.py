"""The port's fault tolerance on the CPU: the reference's
``tests/test_fault_tolerance.py`` (``TestChaos``, ``TestRetryPolicy``,
``TestCrashResumeEndToEnd``, ``TestPreemption``, ``TestReviewRegressions``)
and the same-topology cases of ``tests/test_data_pipeline.py``
(``TestPipelineStatePersistence``, ``TestSampleAccurateResume``)
restated against ``bigdl_tpu_torch``'s ``Optimizer``, ``utils/file.py``,
``utils/chaos.py`` and ``data/pipeline.py``; and a crash then resume of
20 ``resnet_cifar(20)`` steps, equal to the uninterrupted run bit for
bit.  Imports no JAX.

Where the reference reads per-iteration losses through a train summary
(``set_train_summary`` is ROADMAP.md queue 1, item 10), these read the
Optimizer's ``loss_history``, which holds every attempt's losses of one
``optimize()`` (a replayed iteration's last).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.data import (
    PipelineState, dataset_seed, epoch_iter, skip_batches, skip_samples,
    supports_epoch,
)
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample, \
    SampleToMiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import _is_transient
from bigdl_tpu_torch.utils import chaos
from bigdl_tpu_torch.utils.file import (
    CheckpointManager, load_checkpoint, load_pipeline_state,
    pipeline_state_path,
)


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def _samples(n=32, dim=6, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Sample(rng.normal(size=(dim,)).astype(np.float32),
                   int(rng.integers(1, classes + 1))) for _ in range(n)]


def _model(seed=0, dim=6, classes=4):
    gen = torch.Generator().manual_seed(seed)
    kw = dict(generator=gen, device="cpu")
    return pnn.Sequential(pnn.Linear(dim, 8, **kw), pnn.ReLU(),
                          pnn.Linear(8, classes, **kw), pnn.LogSoftMax())


def _dataset(samples, batch=16, seed=5):
    return DataSet.array(samples, seed=seed).transform(
        SampleToMiniBatch(batch))


def _fast_retry(opt, times=2):
    return opt.set_failure_retry(times, interval_s=300,
                                 backoff_s=0.01, backoff_cap_s=0.05)


# --------------------------------------------------------------------------
# chaos hooks
# --------------------------------------------------------------------------

class TestChaos:
    def test_on_step_fires_once(self):
        c = chaos.install(fail_at_step=3)
        chaos.on_step(2)
        with pytest.raises(chaos.FaultInjected):
            chaos.on_step(3)
        chaos.on_step(3)  # one-shot: the retry must get through
        assert c.events and chaos.active() is c

    def test_io_fail_probability_seeded(self):
        chaos.install(io_fail_p=1.0, seed=7)
        with pytest.raises(OSError):
            chaos.on_io_write("/x")
        chaos.install(io_fail_p=0.0)
        chaos.on_io_write("/x")  # never fires

    def test_inactive_hooks_are_noops(self):
        assert chaos.active() is None
        chaos.on_step(123)
        chaos.on_io_write("/x")
        chaos.on_checkpoint_payload("/x")


# --------------------------------------------------------------------------
# retry loop: classification + backoff
# --------------------------------------------------------------------------

class TestRetryPolicy:
    def test_programming_error_not_retried(self, tmp_path):
        class Bad:
            def __init__(self, inner):
                self.inner = inner
                self.calls = 0

            def data(self, train=True):
                self.calls += 1
                if self.calls >= 2:
                    raise ValueError("bug in user code")
                return self.inner.data(train)

            def size(self):
                return self.inner.size()

        data = Bad(_dataset(_samples(seed=3)))
        opt = _fast_retry(
            Optimizer(_model(31), data, pnn.ClassNLLCriterion())
            .set_optim_method(SGD(0.1))
            .set_end_when(Trigger.max_epoch(3))
            .set_checkpoint(str(tmp_path), Trigger.every_epoch()), 5)
        with pytest.raises(ValueError, match="bug in user code"):
            opt.optimize()
        assert data.calls == 2, "ValueError was retried"

    def test_backoff_grows_exponentially_and_caps(self):
        opt = Optimizer(_model(), _dataset(_samples()),
                        pnn.ClassNLLCriterion())
        opt.set_failure_retry(5, backoff_s=1.0, backoff_cap_s=8.0,
                              jitter=0.0)
        assert [opt._backoff_delay(a) for a in range(6)] == \
            [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]

    def test_backoff_jitter_bounded(self):
        opt = Optimizer(_model(), _dataset(_samples()),
                        pnn.ClassNLLCriterion())
        opt.set_failure_retry(5, backoff_s=2.0, jitter=0.25)
        for _ in range(50):
            assert 1.5 <= opt._backoff_delay(0) <= 2.5

    def test_transient_classification(self):
        assert _is_transient(RuntimeError("x"))
        assert _is_transient(OSError("x"))
        assert _is_transient(ConnectionError("x"))
        assert _is_transient(chaos.FaultInjected("x"))
        # a CUDA error (an illegal address, a lost device) is a
        # RuntimeError in torch: transient
        assert _is_transient(torch.cuda.OutOfMemoryError("x"))
        assert not _is_transient(ValueError("x"))
        assert not _is_transient(TypeError("x"))
        assert not _is_transient(KeyError("x"))
        assert not _is_transient(AssertionError("x"))


# --------------------------------------------------------------------------
# end-to-end: crash mid-checkpoint → walkback → resume → same final state
# --------------------------------------------------------------------------

def _run_training(tmp_path=None, keep_n=None, fail_at_step=None,
                  truncate_ckpt=None, seed=41, epochs=3):
    opt = (Optimizer(_model(seed), _dataset(_samples(seed=5)),
                     pnn.ClassNLLCriterion())
           .set_optim_method(SGD(0.1))
           .set_end_when(Trigger.max_epoch(epochs)))
    if tmp_path is not None:
        opt.set_checkpoint(str(tmp_path), Trigger.every_epoch(),
                           keep_n=keep_n)
        _fast_retry(opt, 3)
    if fail_at_step or truncate_ckpt:
        chaos.install(fail_at_step=fail_at_step,
                      truncate_checkpoint=truncate_ckpt,
                      truncate_keep_bytes=64)
    opt.optimize()
    return opt


class TestCrashResumeEndToEnd:
    def test_crash_mid_checkpoint_resumes_from_previous_good(
            self, tmp_path):
        """32 samples / batch 16: 2 iterations an epoch, checkpoints at
        the epoch ends (generations 3 and 5).  The 2nd checkpoint is torn
        and training killed at iteration 6 (epoch 3): the resume walks
        back past generation 5 to 3 and ends with the uninterrupted run's
        loop state, weights and losses."""
        clean = _run_training(None)
        faulty = _run_training(tmp_path, keep_n=2, fail_at_step=6,
                               truncate_ckpt=2)
        events = chaos.active().events
        assert any("truncated" in e for e in events)
        assert any("injected failure at iteration 6" in e for e in events)
        for key in ("epoch", "neval", "records", "loss"):
            assert faulty.state[key] == clean.state[key], key
        assert np.isfinite(faulty.state["loss"])
        for p, q in zip(clean.model.parameters(),
                        faulty.model.parameters()):
            assert torch.equal(p, q)
        assert dict(faulty.loss_history) == dict(clean.loss_history)

        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        last = mgr.latest_good()
        assert last is not None
        _model_s, _opt_s, scalars = load_checkpoint(last)
        assert scalars["neval"] == faulty.state["neval"]
        good = [g for g in mgr.generations()
                if mgr.validate(next(m for m in mgr._manifests()
                                     if m["generation"] == g))]
        assert len(good) == 2

    def test_resume_replays_interrupted_epoch(self, tmp_path):
        """An epoch-boundary checkpoint stores the next epoch: a failure
        mid-epoch replays that epoch from its start."""
        opt = _run_training(tmp_path, keep_n=None, fail_at_step=4)
        assert opt.state["epoch"] == 4
        assert opt.state["neval"] == 7

    def test_retry_exhaustion_still_raises(self, tmp_path):
        class AlwaysFails:
            def __init__(self, inner):
                self.inner = inner
                self.calls = 0

            def data(self, train=True):
                self.calls += 1
                if self.calls >= 2:
                    raise RuntimeError("persistent failure")
                return self.inner.data(train)

            def size(self):
                return self.inner.size()

        data = AlwaysFails(_dataset(_samples(seed=7)))
        opt = _fast_retry(
            Optimizer(_model(43), data, pnn.ClassNLLCriterion())
            .set_optim_method(SGD(0.1))
            .set_end_when(Trigger.max_epoch(3))
            .set_checkpoint(str(tmp_path), Trigger.every_epoch()), 2)
        with pytest.raises(RuntimeError, match="persistent failure"):
            opt.optimize()
        assert data.calls == 4  # initial + 2 retries + final raise

    def test_no_checkpoint_no_retry(self):
        """With no checkpoint to resume from, a transient failure
        re-raises (as a capture that fails on the card does)."""
        chaos.install(fail_at_step=2)
        opt = _fast_retry(Optimizer(_model(), _dataset(_samples()),
                                    pnn.ClassNLLCriterion()), 3)
        with pytest.raises(chaos.FaultInjected):
            opt.optimize()

    def test_resnet_cifar_crash_resume_equals_uninterrupted(self, tmp_path):
        """20 steps of resnet_cifar(20) (5 shuffled batches of 8, 4
        epochs, SGD with momentum): checkpoints every 4 iterations, a
        crash at iteration 14 resumes from generation 12, one batch into
        epoch 3; losses, parameters, BatchNorm statistics and the SGD
        state equal the uninterrupted run's bit for bit."""
        rng = np.random.default_rng(5)
        batches = [MiniBatch(rng.normal(size=(8, 32, 32, 3))
                             .astype(np.float32),
                             rng.integers(1, 11, size=(8,)))
                   for _ in range(5)]

        def run(ckpt=None):
            opt = (Optimizer(resnet_cifar(20, 10, generator=torch.Generator()
                                          .manual_seed(3), device="cpu"),
                             DataSet.array(batches, seed=11),
                             pnn.CrossEntropyCriterion())
                   .set_optim_method(SGD(0.05, momentum=0.9,
                                         dampening=0.0))
                   .set_end_when(Trigger.max_epoch(4)))
            if ckpt is not None:
                _fast_retry(opt.set_checkpoint(
                    str(ckpt), Trigger.several_iteration(4), keep_n=2))
                chaos.install(fail_at_step=14)
            opt.optimize()
            return opt
        clean, faulty = run(), run(tmp_path)
        assert any("iteration 14" in e for e in chaos.active().events)
        assert dict(faulty.loss_history) == dict(clean.loss_history)
        assert len(clean.loss_history) == 20
        for key in ("epoch", "neval", "records", "loss"):
            assert faulty.state[key] == clean.state[key], key
        for (name, p), q in zip(clean.model.state_dict().items(),
                                faulty.model.state_dict().values()):
            assert torch.equal(p, q), name
        for a, b in zip(clean._opt_states, faulty._opt_states):
            assert a["t"] == b["t"] == 20
            assert all(torch.equal(u, v) for u, v in zip(a["velocity"],
                                                         b["velocity"]))


# --------------------------------------------------------------------------
# preemption (SIGTERM)
# --------------------------------------------------------------------------

class TestPreemption:
    def test_sigterm_checkpoints_and_exits_cleanly(self, tmp_path):
        """SIGTERM mid-epoch 2: a final checkpoint at the next step
        boundary, a clean return, the epoch not advanced; a fresh
        Optimizer resumes from it and completes the run."""
        class KillsItself:
            def __init__(self, inner):
                self.inner = inner
                self.epochs = 0

            def data(self, train=True):
                self.epochs += 1
                it = self.inner.data(train)
                if self.epochs == 2:
                    def gen():
                        yield next(it)
                        os.kill(os.getpid(), signal.SIGTERM)
                        yield next(it)
                    return gen()
                return it

            def size(self):
                return self.inner.size()

        data = KillsItself(_dataset(_samples(seed=9)))
        opt = (Optimizer(_model(47), data, pnn.ClassNLLCriterion())
               .set_optim_method(SGD(0.1))
               .set_end_when(Trigger.max_epoch(3))
               .set_checkpoint(str(tmp_path), Trigger.every_epoch()))
        model = opt.optimize()
        assert model is not None
        assert opt.preempted
        assert opt.state["epoch"] == 2, "unfinished epoch must not advance"
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

        ckpt = CheckpointManager(str(tmp_path)).latest_good()
        assert ckpt is not None
        _m, _o, scalars = load_checkpoint(ckpt)
        assert scalars["epoch"] == 2

        opt2 = (Optimizer(_model(47), _dataset(_samples(seed=9)),
                          pnn.ClassNLLCriterion())
                .set_optim_method(SGD(0.1))
                .set_end_when(Trigger.max_epoch(3))
                .resume(ckpt))
        opt2.optimize()
        assert opt2.state["epoch"] == 4 and not opt2.preempted

    def test_sigterm_without_checkpoint_path_still_clean(self):
        class KillsItself:
            def __init__(self, inner):
                self.inner = inner

            def data(self, train=True):
                it = self.inner.data(train)

                def gen():
                    yield next(it)
                    os.kill(os.getpid(), signal.SIGTERM)
                    yield next(it)
                return gen()

            def size(self):
                return self.inner.size()

        opt = (Optimizer(_model(53), KillsItself(_dataset(_samples())),
                         pnn.ClassNLLCriterion())
               .set_optim_method(SGD(0.1))
               .set_end_when(Trigger.max_epoch(2)))
        opt.optimize()
        assert opt.preempted


class TestReviewRegressions:
    def _state(self, v):
        model = {"params": {"w": np.full((4,), v, np.float32)},
                 "buffers": {}}
        return model, [{"t": np.asarray(1)}], {"epoch": 1, "neval": int(v)}

    def test_stale_manifest_overwrite_mode_still_resumes(self, tmp_path):
        """Overwrite mode: a crash between the payload's rename and the
        manifest leaves a stale manifest beside a complete payload, which
        the load probe accepts."""
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(*self._state(2.0), generation=2, overwrite=True)
        chaos.install(crash_checkpoint=1)
        with pytest.raises(chaos.FaultInjected):
            mgr.save(*self._state(4.0), generation=4, overwrite=True)
        chaos.reset()
        p = mgr.latest_good()
        assert p == str(tmp_path / "checkpoint.npz")
        _m, _o, scalars = load_checkpoint(p)
        assert scalars["neval"] == 4

    def test_gc_does_not_count_unmarked_orbax_dir_as_good(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=1)
        good = tmp_path / "checkpoint.1.orbax" / "tree"
        good.mkdir(parents=True)
        (good / "_CHECKPOINT_METADATA").write_text("{}")
        mgr._write_manifest("checkpoint.1.orbax", 1, None, None, True)
        torn = tmp_path / "checkpoint.2.orbax" / "tree"
        torn.mkdir(parents=True)
        mgr._write_manifest("checkpoint.2.orbax", 2, None, None, True)
        mgr.gc()
        assert (tmp_path / "checkpoint.1.orbax").exists(), \
            "GC deleted the only committed generation"

    def test_preempted_flag_resets_on_next_optimize(self, tmp_path):
        opt = _run_training(tmp_path)
        opt.preempted = True
        opt.set_end_when(Trigger.max_epoch(4))
        opt.optimize()
        assert not opt.preempted


# --------------------------------------------------------------------------
# the input pipeline's position (tests/test_data_pipeline.py)
# --------------------------------------------------------------------------

def _indexed_samples(n=32, dim=6, classes=4):
    """Sample i's feature is the constant i."""
    return [Sample(np.full((dim,), i, np.float32), (i % classes) + 1)
            for i in range(n)]


class _RecordBatches(Transformer):
    def __init__(self, log):
        self.log = log

    def apply(self, it):
        for b in it:
            self.log.append(tuple(int(v)
                                  for v in np.asarray(b.input)[:, 0]))
            yield b


def _pipeline(samples, batch=8, log=None):
    ds = DataSet.array(samples, seed=21).transform(SampleToMiniBatch(batch))
    if log is not None:
        ds = ds.transform(_RecordBatches(log))
    return ds


def _train(dataset, *, epochs=3, ckpt=None, ckpt_trigger=None,
           retry=False, seed=17):
    opt = (Optimizer(_model(seed), dataset, pnn.ClassNLLCriterion())
           .set_optim_method(SGD(0.1))
           .set_end_when(Trigger.max_epoch(epochs)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt),
                           ckpt_trigger or Trigger.several_iteration(1))
    if retry:
        _fast_retry(opt, 3)
    return opt


class TestPipelineHelpers:
    def test_skips_and_epoch_keyword(self):
        ds = _pipeline(_indexed_samples())
        assert supports_epoch(ds) and dataset_seed(ds) == 21
        it = iter(epoch_iter(ds, 2))
        assert skip_batches(it, 3) == 3 and skip_batches(it, 5) == 1
        it = iter(epoch_iter(ds, 2))
        assert skip_samples(it, 12) == (2, 16)

        class NoEpoch:
            def data(self, train=True):
                return iter(())
        assert not supports_epoch(NoEpoch())
        assert dataset_seed(NoEpoch()) == 0


class TestPipelineStatePersistence:
    def _save(self, mgr, gen, pipeline):
        return mgr.save({"params": {"w": np.ones((2,))}, "buffers": {}},
                        [{"t": np.asarray(gen)}], {"epoch": gen},
                        generation=gen, pipeline_state=pipeline)

    def test_snapshot_restore_roundtrip(self):
        ps = PipelineState(seed=7, epoch=3, offset=5,
                           sampler={"kind": "weighted_mixing"})
        back = PipelineState.restore(json.loads(json.dumps(ps.snapshot())))
        assert (back.seed, back.epoch, back.offset) == (7, 3, 5)
        assert back.sampler == {"kind": "weighted_mixing"}
        with pytest.raises(ValueError, match="version"):
            PipelineState.restore({**ps.snapshot(), "version": 99})

    def test_sidecar_written_and_crcd_in_manifest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        ps = PipelineState(seed=1, epoch=2, offset=3).snapshot()
        path = self._save(mgr, 4, ps)
        assert os.path.isfile(pipeline_state_path(path))
        assert load_pipeline_state(path) == ps
        man = next(m for m in mgr._manifests() if m["generation"] == 4)
        assert man["pipeline"]["file"].endswith(".pipeline.json")
        assert man["pipeline"]["crc32"] is not None
        assert mgr.validate(man)

    def test_torn_sidecar_fails_validation_and_walks_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        ps = PipelineState(seed=1, epoch=1, offset=1).snapshot()
        p1 = self._save(mgr, 1, ps)
        p2 = self._save(mgr, 2, ps)
        with open(pipeline_state_path(p2), "w") as f:
            f.write('{"torn": tru')
        assert mgr.latest_good() == p1

    def test_gc_sweeps_pipeline_sidecars(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=1)
        for g in (1, 2, 3):
            last = self._save(
                mgr, g, PipelineState(seed=0, epoch=g, offset=0).snapshot())
        names = os.listdir(tmp_path)
        assert sum(n.endswith(".pipeline.json") for n in names) == 1
        assert load_pipeline_state(last)["epoch"] == 3

    def test_missing_sidecar_is_none_not_crash(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert load_pipeline_state(self._save(mgr, 1, None)) is None


class TestSampleAccurateResume:
    def test_crash_mid_epoch_resumes_at_exact_next_batch(self, tmp_path):
        """A crash at iteration 6 (mid epoch 2 of 4-iteration epochs),
        checkpoints every iteration: every iteration's loss, the weights
        and the final loop state equal the uninterrupted run's."""
        clean = _train(_pipeline(_indexed_samples()))
        clean.optimize()
        chaos.install(fail_at_step=6)
        faulty = _train(_pipeline(_indexed_samples()), ckpt=tmp_path,
                        retry=True)
        faulty.optimize()
        for key in ("epoch", "neval", "records"):
            assert faulty.state[key] == clean.state[key], key
        assert dict(faulty.loss_history) == dict(clean.loss_history)
        for p, q in zip(clean.model.parameters(),
                        faulty.model.parameters()):
            assert torch.equal(p, q)
        ps = load_pipeline_state(CheckpointManager(str(tmp_path))
                                 .latest_good())
        # the last step's checkpoint: epoch 3 with its 4 batches consumed
        # (the epoch end's trigger sees the same iteration and skips)
        assert (ps["generation"], ps["epoch"], ps["offset"]) == (13, 3, 4)

    def test_resumed_epoch_pull_order_matches_uninterrupted(self, tmp_path):
        clean_pulls = []
        clean = _train(_pipeline(_indexed_samples(), log=clean_pulls),
                       epochs=2)
        clean.optimize()
        epoch2_clean = clean_pulls[4:8]
        chaos.install(fail_at_step=6)
        faulty_pulls = []
        faulty = _train(_pipeline(_indexed_samples(), log=faulty_pulls),
                        epochs=2, ckpt=tmp_path, retry=True)
        faulty.optimize()
        # epoch 1 (4), epoch 2 before the crash (2, the second pulled but
        # never stepped), then epoch 2 again: 1 skipped, 3 stepped
        assert faulty_pulls[:4] == clean_pulls[:4]
        assert faulty_pulls[-4:] == epoch2_clean
        assert len(faulty_pulls) == 10
        assert faulty.state["neval"] == clean.state["neval"]

    def test_sigterm_preemption_resume_sample_accurate(self, tmp_path):
        clean = _train(_pipeline(_indexed_samples()), seed=19)
        clean.optimize()

        class KillOnce(Transformer):
            def __init__(self):
                self.batches = 0

            def apply(self, it):
                for b in it:
                    self.batches += 1
                    if self.batches == 6:  # mid epoch 2
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

        ds = _pipeline(_indexed_samples()).transform(KillOnce())
        opt = _train(ds, seed=19, ckpt=tmp_path,
                     ckpt_trigger=Trigger.every_epoch())
        opt.optimize()
        assert opt.preempted and opt.state["epoch"] == 2
        ckpt = CheckpointManager(str(tmp_path)).latest_good()
        ps = load_pipeline_state(ckpt)
        assert ps is not None and ps["epoch"] == 2 and ps["offset"] > 0

        opt2 = _train(_pipeline(_indexed_samples()), seed=23).resume(ckpt)
        opt2.optimize()
        assert not opt2.preempted
        for key in ("epoch", "neval", "records"):
            assert opt2.state[key] == clean.state[key], key
        merged = {**dict(opt.loss_history), **dict(opt2.loss_history)}
        assert merged == dict(clean.loss_history)
        for p, q in zip(clean.model.parameters(), opt2.model.parameters()):
            assert torch.equal(p, q)

    def test_stale_sidecar_generation_mismatch_replays_epoch(
            self, tmp_path, caplog):
        opt = _train(_pipeline(_indexed_samples()), epochs=2, ckpt=tmp_path)
        opt.optimize()
        path = CheckpointManager(str(tmp_path)).latest_good()
        side = pipeline_state_path(path)
        with open(side) as f:
            ps = json.load(f)
        ps["generation"] -= 1
        ps["offset"] = max(ps.get("offset", 1), 1)
        with open(side, "w") as f:
            json.dump(ps, f)
        opt2 = _train(_pipeline(_indexed_samples())).resume(path)
        with caplog.at_level("WARNING", logger="bigdl_tpu_torch.optim"):
            opt2.optimize()
        assert opt2.state["epoch"] == 4
        assert any("stale sidecar" in r.message for r in caplog.records)

    def test_resume_without_sidecar_replays_epoch_start(self, tmp_path,
                                                        monkeypatch):
        chaos.install(fail_at_step=6)
        pulls = []
        opt = _train(_pipeline(_indexed_samples(), log=pulls),
                     epochs=2, ckpt=tmp_path, retry=True)
        real_save = CheckpointManager.save

        def save_no_sidecar(self, *a, **kw):
            kw["pipeline_state"] = None
            return real_save(self, *a, **kw)

        monkeypatch.setattr(CheckpointManager, "save", save_no_sidecar)
        opt.optimize()
        # epoch 2 was replayed in full: 4 + 2 + 4 pulls
        assert opt.state["epoch"] == 3
        assert len(pulls) == 10 and pulls[6:8] == pulls[4:6]
