"""Elastic membership in the PyTorch port, against the JAX reference.

The port keeps its own copies of ``kubeflow_tpu/elastic``'s worker-side
parts; here they run beside the reference's on the same inputs:

- the protocol (``Membership``, ``membership_from_status``,
  ``shard_rows``, ``step_rows``, ``BatchLedger`` and its digest) equal to
  the reference's;
- ``NpzDataset`` across a membership history (world 4, then 2, then 3)
  giving every rank exactly the reference's rows, the union of each step
  the whole batch (``test_elastic.py``'s scenario);
- ``ResizeCheckpoint`` files read across both packages (byte-identical
  for the same record), with torn, corrupt and missing records refused
  and a write that fails before its rename leaving the previous record;
- ``FileMembership`` with torn and missing reads, and its bootstrap
  epoch -1;
- the reference's trainer resize scenario (``TRAINER_RESIZE``: mnist_mlp,
  world 2 -> 1 at step 6) in-process on the port: one resize, steps 1-12
  logged in order, the barrier's record, two runs with equal losses, and
  worker 1 resigning at step 6; then the Trainer's own refusals;
- a 2-process gang through the Trainer: rank 0 writes the checkpoints and
  every rank resumes from them, and a rank killed by
  ``fault_kill_at_step`` makes the survivor raise instead of wait.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from kubeflow_tpu.elastic import checkpoint as jck
from kubeflow_tpu.elastic import protocol as jproto
from kubeflow_tpu.elastic import runtime as jrt
from kubeflow_tpu.training.data import NpzDataset as JNpzDataset
from kubeflow_tpu_torch import elastic as telastic
from kubeflow_tpu_torch.elastic import checkpoint as tck
from kubeflow_tpu_torch.elastic import protocol as tproto
from kubeflow_tpu_torch.elastic import runtime as trt
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent


def test_elastic_exports_the_references_less_the_decider():
    from kubeflow_tpu import elastic as jelastic

    assert set(telastic.__all__) == set(jelastic.__all__) - {"ElasticDecider"}


@pytest.mark.parametrize("members", [(0,), (2, 0, 1), (5, 3), (1, 4, 2, 7)])
def test_protocol_matches_the_reference(members):
    a, b = tproto.Membership(3, members), jproto.Membership(3, members)
    assert (a.members, a.size, a.coordinator) == (b.members, b.size,
                                                  b.coordinator)
    for i in range(8):
        assert a.rank_of(i) == b.rank_of(i)
    job = {"status": {"elastic": {"epoch": 3, "members": list(members)}}}
    assert tproto.membership_from_status(job) == a
    assert tproto.membership_from_status({"status": {}}) is None
    for gb in (7, 8, 16):
        assert tproto.step_rows(gb, members) == jproto.step_rows(gb, members)
    # the data module's partition is the protocol's
    assert tdata.shard_rows is tproto.shard_rows
    with pytest.raises(ValueError):
        tproto.shard_rows(8, len(members), len(members))


def test_batch_ledger_verifies_and_digests_as_the_reference():
    ledgers = (tproto.BatchLedger(), jproto.BatchLedger())
    for led in ledgers:
        for step, members in ((0, (0, 1)), (1, (0, 1)), (2, (1,))):
            for m, rows in tproto.step_rows(6, members).items():
                led.record(step, m, rows)
        led.verify(steps=3, global_batch=6)
    assert ledgers[0].digest() == ledgers[1].digest()
    assert len(ledgers[0]) == 3
    bad = tproto.BatchLedger()
    bad.record(0, 0, [0, 1, 2])
    bad.record(0, 1, [2, 3, 4, 5])
    with pytest.raises(AssertionError, match="twice"):
        bad.verify(steps=1, global_batch=6)
    with pytest.raises(AssertionError, match="twice"):
        bad.record(0, 1, [0])
    with pytest.raises(AssertionError, match="skipped"):
        bad.verify(steps=2, global_batch=6)


def test_npz_shards_across_a_resize_are_the_references(tmp_path):
    path = str(tmp_path / "d.npz")
    np.savez(path, x=np.arange(64).reshape(64, 1), y=np.arange(64))
    ledger = tproto.BatchLedger()
    # steps 0-2 world 4, 3-5 world 2, 6-7 world 3: each segment
    # re-iterates from its resize step under the new (rank, world)
    history = [(0, 3, [0, 1, 2, 3]), (3, 6, [0, 1]), (6, 8, [0, 2, 4])]
    for start, stop, members in history:
        for rank, member in enumerate(sorted(members)):
            got = tdata.NpzDataset(path, 8, seed=0).iter_from(
                start, rank=rank, world=len(members))
            want = JNpzDataset(path, 8, seed=0, process_index=0,
                               process_count=1).iter_from(
                start, rank=rank, world=len(members))
            for step in range(start, stop):
                a, b = next(got), next(want)
                assert all(np.array_equal(a[k], b[k]) for k in b)
                ledger.record(step, member, [int(v) for v in a["y"]])
    # the rows are sample ids: each step's union is that step's batch
    for step in range(8):
        seen = sorted(r for m in ledger._steps[step].values() for r in m)
        whole = next(tdata.NpzDataset(path, 8, seed=0).iter_from(step))
        assert seen == sorted(int(v) for v in whole["y"])


RECORD = {"step": 6, "epoch": 2, "members": (3, 0, 1), "extra": {"c": 7}}


def test_resize_checkpoints_are_read_across_both_packages(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    tck.ResizeCheckpoint(str(ours)).save(**RECORD)
    jck.ResizeCheckpoint(str(theirs)).save(**RECORD)
    assert ((ours / "resize.json").read_bytes()
            == (theirs / "resize.json").read_bytes())
    want = {"step": 6, "epoch": 2, "members": [0, 1, 3], "extra": {"c": 7}}
    assert jck.ResizeCheckpoint(str(ours)).load() == want
    assert tck.ResizeCheckpoint(str(theirs)).load() == want


@pytest.mark.parametrize("damage", ["torn", "crc", "no_frame", "missing"])
def test_damaged_resize_records_are_refused_by_both(tmp_path, damage):
    tck.ResizeCheckpoint(str(tmp_path)).save(step=3, epoch=1, members=[0])
    path = tmp_path / "resize.json"
    framed = path.read_text()
    if damage == "torn":
        path.write_text(framed[:len(framed) // 2])
    elif damage == "crc":
        path.write_text(framed.replace('"step": 3', '"step": 4'))
    elif damage == "no_frame":
        path.write_text(framed.split("|", 1)[1])
    else:
        path.unlink()
    assert tck.ResizeCheckpoint(str(tmp_path)).load() is None
    assert jck.ResizeCheckpoint(str(tmp_path)).load() is None


class CrashBeforeRename(tck.FileIO):
    def replace(self, src, dst):
        raise OSError("crash between fsync and rename")


def test_a_write_that_dies_before_its_rename_keeps_the_last_record(
        tmp_path):
    good = tck.ResizeCheckpoint(str(tmp_path))
    good.save(step=3, epoch=1, members=[0, 1])
    crashing = tck.ResizeCheckpoint(str(tmp_path), io=CrashBeforeRename())
    with pytest.raises(OSError, match="crash"):
        crashing.save(step=6, epoch=2, members=[0])
    assert good.load() == {"step": 3, "epoch": 1, "members": [0, 1]}
    assert jck.ResizeCheckpoint(str(tmp_path)).load()["step"] == 3


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_membership_survives_torn_and_missing_reads(tmp_path, writer):
    write = (trt.write_membership_file if writer == "port"
             else lambda p, m: jrt.write_membership_file(
                 p, jproto.Membership(m.epoch, m.members)))
    path = str(tmp_path / "membership.json")
    src = trt.FileMembership(path, index=1)
    # no file yet: this worker alone at the bootstrap epoch -1, below any
    # the controller stamps, so even epoch 0 reads as a change
    assert src.current(0) == tproto.Membership(-1, (1,))
    write(path, tproto.Membership(2, (0, 1, 2)))
    assert src.current(5) == tproto.Membership(2, (0, 1, 2))
    with open(path, "w") as f:
        f.write('{"epoch": 3, "mem')                 # a torn rewrite
    assert src.current(6) == tproto.Membership(2, (0, 1, 2))
    write(path, tproto.Membership(4, (1,)))
    assert src.current(7) == tproto.Membership(4, (1,))
    assert (jrt.FileMembership(path, 1).current(0)
            == jproto.Membership(4, (1,)))


def test_scripted_membership_needs_a_step_zero_view():
    with pytest.raises(ValueError, match="step-0"):
        trt.ScriptedMembership(0, {3: tproto.Membership(1, (0,))})
    src = trt.ScriptedMembership(0, {0: tproto.Membership(0, (0, 1)),
                                     6: tproto.Membership(1, (0,))})
    assert src.current(5).epoch == 0 and src.current(6).epoch == 1


# -- the Trainer's resize barrier: the reference's TRAINER_RESIZE -----------

SCHEDULE = {0: tproto.Membership(0, (0, 1)), 6: tproto.Membership(1, (0,))}


def resize_run(index: int, ckdir) -> tuple[dict, Trainer]:
    cfg = TrainerConfig(model="mnist_mlp", global_batch=16, steps=12,
                        log_every=1, checkpoint_dir=str(ckdir),
                        checkpoint_every=100,
                        optimizer={"name": "sgd", "learning_rate": 1e-2})
    t = Trainer(cfg, membership=trt.ScriptedMembership(index, SCHEDULE),
                device="cpu")
    return t.run(), t


def test_trainer_resize_barrier_is_the_references(tmp_path):
    out, t = resize_run(0, tmp_path / "a")
    assert out["steps"] == 12 and out["resizes"] == 1
    assert t.resizes == [{"step": 6, "epoch": 1, "world": 1, "rank": 0}]
    assert [h["step"] for h in t.history] == list(range(1, 13))
    rec = tck.ResizeCheckpoint(str(tmp_path / "a")).load()
    assert rec == {"step": 6, "epoch": 1, "members": [0]}
    assert jck.ResizeCheckpoint(str(tmp_path / "a")).load() == rec
    # the barrier committed the full state at step 6 beside the final one
    assert sorted(p.name for p in (tmp_path / "a").glob("ckpt-*.pt")) == [
        "ckpt-12.pt", "ckpt-6.pt"]
    # same seed and schedule: the same trajectory
    _, again = resize_run(0, tmp_path / "b")
    assert [h["loss"] for h in again.history] == [
        h["loss"] for h in t.history]
    # the worker shrunk out resigns at the barrier
    res, gone = resize_run(1, tmp_path / "c")
    assert res["resigned"] is True and res["start_step"] == 6
    assert res["resizes"] == 0 and res["final_loss"] is None
    assert [h["step"] for h in gone.history] == list(range(1, 7))


def test_file_membership_drives_the_trainer(tmp_path, monkeypatch):
    path = str(tmp_path / "members.json")
    trt.write_membership_file(path, tproto.Membership(0, (0, 2)))
    monkeypatch.setenv("JAXJOB_MEMBER_INDEX", "2")
    cfg = TrainerConfig(model="mnist_mlp", global_batch=8, steps=2,
                        log_every=1, membership_file=path)
    t = Trainer(cfg, device="cpu")
    out = t.run()
    assert t._membership.index == 2 and out["resizes"] == 0


@pytest.mark.parametrize("members,batch,match", [
    ((0, 1), 16, "not in the initial membership"),
    ((3, 4, 5), 2, "exceeds global_batch"),
])
def test_trainer_refuses_bad_initial_memberships(members, batch, match):
    cfg = TrainerConfig(model="mnist_mlp", global_batch=batch, steps=1)
    src = trt.ScriptedMembership(3 if 3 in members else 7,
                                 {0: tproto.Membership(0, members)})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, membership=src, device="cpu").run()


class Flipping:
    """A membership whose epoch moves on its second read."""

    index = 0

    def __init__(self):
        self.reads = 0

    def current(self, step):
        self.reads += 1
        return tproto.Membership(0 if self.reads == 1 else 1, (0, 1))


def fake_gang(monkeypatch, world: int):
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(pd, "default_group", lambda: "group")
    monkeypatch.setattr(pd, "world_size", lambda g: 1 if g is None else world)
    monkeypatch.setattr(pd, "rank_of", lambda g: 0)
    # the Trainer's mesh names the fake gang as its dp group
    monkeypatch.setattr(tmesh.Mesh, "group", lambda self, *axes: (
        "group" if self.axis_size(*axes) > 1 else None))


def test_a_resize_inside_a_process_group_is_refused(monkeypatch):
    fake_gang(monkeypatch, 2)
    cfg = TrainerConfig(model="mnist_mlp", global_batch=8, steps=2)
    with pytest.raises(NotImplementedError, match="re-formed group"):
        Trainer(cfg, membership=Flipping(), device="cpu").run()


@pytest.mark.parametrize("field,value,match", [
    ("global_batch", 9, "must divide by process count 2"),
    ("dp", 4, "dp=4"),
])
def test_trainer_checks_the_gang(monkeypatch, field, value, match):
    fake_gang(monkeypatch, 2)
    cfg = TrainerConfig.from_dict({"model": "mnist_mlp", "steps": 1,
                                   "global_batch": 8, field: value})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu").run()


# -- a real gang through the Trainer: checkpoints and a dead rank -----------

GANG_TRAINER = r"""
import json, os, torch
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
pd.initialize_from_env(device="cpu")
base = json.loads(os.environ["TRAINER_CONFIG"])
first = Trainer(TrainerConfig.from_dict({**base, "steps": 3}),
                device="cpu").run()
names = sorted(os.listdir(base["checkpoint_dir"]))
resumed = Trainer(TrainerConfig.from_dict({**base, "steps": 5}),
                  device="cpu")
second = resumed.run()
print(json.dumps({"first": first, "second": second, "names": names,
                  "losses": [h["loss"] for h in resumed.history]}))
"""


def test_a_gang_checkpoints_on_rank_0_and_resumes_on_every_rank(tmp_path):
    ck = tmp_path / "ck"
    cfg = {"model": "mnist_mlp", "global_batch": 8, "log_every": 1,
           "checkpoint_dir": str(ck), "checkpoint_every": 1,
           "optimizer": {"name": "sgd", "learning_rate": 1e-2}}
    outs = pd.spawn_local_gang(GANG_TRAINER, 2, timeout=120.0,
                               extra_env={"TRAINER_CONFIG": json.dumps(cfg)})
    for o in outs:
        assert o["names"] == ["ckpt-1.pt", "ckpt-2.pt", "ckpt-3.pt"]
        assert o["first"]["start_step"] == 0
        assert o["second"]["start_step"] == 3
    assert outs[0]["losses"] == outs[1]["losses"] and len(
        outs[0]["losses"]) == 2
    assert sorted(p.name for p in ck.iterdir()) == [
        "ckpt-3.pt", "ckpt-4.pt", "ckpt-5.pt"]      # no stray temporaries


KILLED = r"""
import json, os, sys, torch
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

pd.initialize_from_env(device="cpu")
cfg = json.loads(os.environ["TRAINER_CONFIG"])
if os.environ["JAXJOB_PROCESS_ID"] == "1":
    cfg["fault_kill_at_step"] = 2
Trainer(TrainerConfig.from_dict(cfg), device="cpu").run()
"""


def test_a_rank_killed_mid_run_makes_the_survivor_raise(tmp_path):
    cfg = {"model": "mnist_mlp", "global_batch": 8, "steps": 6,
           "log_every": 1, "checkpoint_dir": str(tmp_path),
           "checkpoint_every": 1}
    port = pd.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", KILLED], cwd=ROOT,
        env={**os.environ, **pd.rendezvous_env(f"127.0.0.1:{port}", 2, r),
             "TRAINER_CONFIG": json.dumps(cfg)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    t0 = time.monotonic()
    try:
        errs = [p.communicate(timeout=90)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 17                 # the injected kill
    assert procs[0].returncode not in (0, None), errs[0][-2000:]
    assert time.monotonic() - t0 < 60.0              # raised, not waited
