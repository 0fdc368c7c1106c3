"""The PyTorch port's Trainer, data, checkpoints and worker entrypoint.

On the CPU at ``bert_tiny`` size: the Trainer on an ``.npz`` written here;
``NpzDataset`` batches against the reference's, batch for batch; resume
(3 steps, then 3 more from the checkpoint) against 6 straight steps; the
fields the port refuses, each by name; the profiler window; and
``python -m kubeflow_tpu_torch.training --device cpu`` in a subprocess.
Gangs and elastic membership: ``test_torch_dp.py`` and
``test_torch_elastic.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu.training.data import NpzDataset as JNpzDataset
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
TINY = {"model": "bert", "model_config": {"size": "tiny", "dtype": "float32"},
        "global_batch": 4, "log_every": 1,
        "optimizer": {"name": "adamw", "learning_rate": 1e-3,
                      "weight_decay": 0.01}}


def tiny(**kw) -> TrainerConfig:
    return TrainerConfig.from_dict({**TINY, **kw})


def write_npz(path, rows=12, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    np.savez(path,
             input_ids=rng.integers(0, 1024, (rows, seq)).astype(np.int32),
             labels=rng.integers(0, 1024, (rows, seq)).astype(np.int32),
             weights=(rng.random((rows, seq)) < 0.3).astype(np.float32))
    return str(path)


def test_trainer_runs_on_an_npz_file(tmp_path):
    path = write_npz(tmp_path / "train.npz")
    records = []
    trainer = Trainer(tiny(steps=4, data_path=path),
                      lambda step, rec: records.append(step), device="cpu")
    out = trainer.run()
    assert set(out) == {"final_loss", "steps", "start_step",
                        "samples_per_sec"}
    assert out["steps"] == 4 and out["start_step"] == 0
    assert np.isfinite(out["final_loss"]) and out["samples_per_sec"] > 0
    assert records == [1, 2, 3, 4]
    assert [r["step"] for r in trainer.history] == [1, 2, 3, 4]
    assert out["final_loss"] == trainer.history[-1]["loss"]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_npz_batches_match_the_reference(tmp_path, world):
    path = write_npz(tmp_path / "d.npz", rows=10)
    for rank in range(world):
        ref = JNpzDataset(path, 4, seed=7, process_index=rank,
                          process_count=world).iter_from(1)
        got = tdata.NpzDataset(path, 4, seed=7, process_index=rank,
                               process_count=world).iter_from(1)
        for _ in range(5):      # across an epoch boundary (2 per epoch)
            a, b = next(got), next(ref)
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k])


def test_shard_rows_is_the_reference_partition():
    from kubeflow_tpu.elastic.protocol import shard_rows

    for n, world in ((8, 3), (5, 5), (7, 2)):
        for rank in range(world):
            assert tdata.shard_rows(n, rank, world) == shard_rows(n, rank,
                                                                  world)
    with pytest.raises(ValueError):
        tdata.shard_rows(4, 2, 2)


def test_synthetic_batches_are_keyed_by_step_and_rank():
    from kubeflow_tpu_torch.models import registry

    model = registry.get("bert").make_model(size="tiny", device="cpu")
    ds = tdata.SyntheticDataset("bert", model, 2, seed=3)
    a = next(ds.iter_from(5))
    b = next(ds.iter_from(5))
    c = next(ds.iter_from(5, rank=1))
    d = next(ds.iter_from(6))
    assert torch.equal(a["input_ids"], b["input_ids"])
    assert not torch.equal(a["input_ids"], c["input_ids"])
    assert not torch.equal(a["input_ids"], d["input_ids"])


def test_resume_gives_the_loss_of_the_straight_run(tmp_path):
    straight = Trainer(tiny(steps=6), device="cpu").run()
    ckpt = str(tmp_path / "ckpt")
    first = Trainer(tiny(steps=3, checkpoint_dir=ckpt), device="cpu").run()
    assert CheckpointManager(ckpt).latest_step() == 3
    second = Trainer(tiny(steps=6, checkpoint_dir=ckpt), device="cpu")
    out = second.run()
    assert first["start_step"] == 0 and out["start_step"] == 3
    assert [r["step"] for r in second.history] == [4, 5, 6]
    assert out["final_loss"] == pytest.approx(straight["final_loss"],
                                              rel=1e-6)
    again = Trainer(tiny(steps=6, checkpoint_dir=ckpt), device="cpu").run()
    assert again["already_complete"] and again["final_loss"] is None


def test_checkpoints_keep_the_newest_and_write_atomically(tmp_path):
    Trainer(tiny(steps=5, checkpoint_dir=str(tmp_path),
                 checkpoint_every=1), device="cpu").run()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [3, 4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt-3.pt", "ckpt-4.pt", "ckpt-5.pt"]


def test_prefetch_gives_the_same_losses():
    # what the prefetcher must preserve: the batches, bit for bit
    from kubeflow_tpu_torch.models import registry

    model = registry.get("bert").make_model(size="tiny", device="cpu")
    cpu = torch.device("cpu")

    def host():
        return tdata.SyntheticDataset("bert", model, 4, seed=0).iter_from(0)

    def put(batch):
        return tdata.to_device(batch, cpu)

    want = [b for _, b in zip(range(3), map(put, host()))]
    prefetcher = tdata.DevicePrefetcher(host(), put, depth=2)
    got = [next(prefetcher) for _ in range(3)]
    prefetcher.close()
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k])
    # the losses: float32 CPU training differs from run to run by an ulp
    # after an optimizer update even without prefetch, so as in the resume
    # test they agree to rel 1e-6, not bitwise
    plain = Trainer(tiny(steps=3), device="cpu")
    plain.run()
    fetched = Trainer(tiny(steps=3, prefetch=2), device="cpu")
    fetched.run()
    assert [r["loss"] for r in fetched.history] == pytest.approx(
        [r["loss"] for r in plain.history], rel=1e-6)


def test_profile_window_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    Trainer(tiny(steps=4, profile_dir=str(out), profile_steps=2),
            device="cpu").run()
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("field,value", [
    ("fsdp", 2), ("tp", 2), ("sp", 2),
])
def test_unported_fields_are_refused_by_name(field, value):
    # fsdp, tp and sp are admitted; one process cannot hold a mesh of two
    with pytest.raises(ValueError, match=f"{field}=2.*1 devices not "
                       "divisible by fixed axes product 2"):
        Trainer(tiny(steps=1, **{field: value}), device="cpu").run()


def test_models_without_a_training_loss_are_refused(monkeypatch):
    # every registry model trains now: a serving-only entry made here
    from kubeflow_tpu_torch.models import registry

    entry = registry.ModelEntry(
        "serving_only", registry.get("llama").make_model, generative=True)
    monkeypatch.setitem(registry._REGISTRY, entry.name, entry)
    with pytest.raises(NotImplementedError, match="serving_only"):
        Trainer(TrainerConfig(model="serving_only", steps=1),
                device="cpu").run()


def test_fault_kill_needs_a_checkpoint_before_it():
    with pytest.raises(ValueError, match="fault_kill_at_step"):
        Trainer(tiny(steps=4, fault_kill_at_step=2), device="cpu").run()


def test_worker_entrypoint_prints_the_summary(tmp_path):
    env = dict(os.environ, JAXJOB_TRAINER_CONFIG=json.dumps(TINY))
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.training", "--steps", "2",
         "--learning-rate", "0.01", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
