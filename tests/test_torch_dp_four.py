"""Data-parallel training of the PyTorch port: the 4-process gloo gang on
the CPU, a dead rank ending its gang, and the worker entrypoint joining a
gang from the env that ``build_worker_pod`` writes.

``test_torch_dp.py`` runs the 2-process gang and says what both gangs
are held to; the shared parts are in ``torch_dp_gangs.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu.api import jaxjob as japi
from kubeflow_tpu_torch.parallel import distributed as pd
from torch_dp_gangs import (  # noqa: F401  (setup: a fixture)
    CASES, ROOT, assert_trails_close, gang, one_process, setup)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", [4])
def test_gang_trains_what_one_process_trains(setup, world, name):
    outs = gang(setup, world)
    trails = [o["trails"][name] for o in outs]
    for r, o in enumerate(outs):
        assert o["rdv"]["process_id"] == r
        assert o["rdv"]["backend"] == "gloo"
        assert trails[r] == trails[0], "ranks disagree"     # bitwise
    want, final = one_process(setup, name, world)
    assert_trails_close(trails[0], want)
    states = [torch.load(setup["root"] / f"{name}-w{world}-r{r}.pt",
                         weights_only=True) for r in range(world)]
    for key, p in final.items():
        for s in states[1:]:
            assert torch.equal(s[key], states[0][key]), key
        err = (states[0][key] - p).abs().max() / p.abs().max().clamp_min(1e-6)
        assert err <= 1e-5, key


DYING = r"""
import json, os, sys, torch
from kubeflow_tpu_torch.parallel import distributed as pd
pd.initialize_from_env(device="cpu")
x = torch.ones(4)
pd.all_reduce_sum([x], pd.default_group())
if pd.rank_of(pd.default_group()) == 1:
    os._exit(17)           # a preempted rank: no cleanup
pd.all_reduce_sum([x], pd.default_group())
print(json.dumps({}))
"""


def test_a_dead_rank_ends_its_gang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited 17"):
        pd.spawn_local_gang(DYING, 2, timeout=60.0)
    assert time.monotonic() - t0 < 30.0


def test_worker_entrypoint_joins_the_gang_build_worker_pod_describes(
        tmp_path):
    job = japi.new("gang2", "ml", topology="v5e-8",
                   trainer={"model": "mnist_mlp", "steps": 3,
                            "global_batch": 16, "log_every": 1,
                            "optimizer": {"name": "adam",
                                          "learning_rate": 1e-3}})
    port = pd.free_port()
    procs = []
    for index in range(2):
        pod = japi.build_worker_pod(job, index)
        env = {e["name"]: e["value"]
               for e in pod["spec"]["containers"][0]["env"]}
        assert env["JAXJOB_NUM_PROCESSES"] == "2"
        # the pod's DNS name resolves only in a cluster: both workers meet
        # at the coordinator rank 0 binds here
        env["JAXJOB_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.training",
             "--device", "cpu"], cwd=ROOT, env={**os.environ, **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
            assert '"backend": "gloo"' in err        # the rendezvous log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [r["steps"] for r in results] == [3, 3]
    assert results[0]["final_loss"] == results[1]["final_loss"]
    assert np.isfinite(results[0]["final_loss"])
