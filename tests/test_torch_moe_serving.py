"""The dropless MoE block (serving's) under ep, tp and tp x ep.

Each layout runs in a gang on the CPU over gloo: the reference's block
weights (``torch_moe_ep_gangs.reference_block``) placed by the serving
rules (``serving/sharded.py``: the experts over ep, ``w_in``'s FFN
columns and ``w_out``'s rows over tp, the router whole), its output held
to the reference's dropless block on the same batch within 1e-5 of max
|y|, and to the same block in one process: bitwise at ep=2 (each token's
two gated terms sum over the ranks with zeros elsewhere) and within 1e-5
under tp (the FFN contraction is split).  Every layout issues one
all-reduce per forward, over the weights' ``model_group``.  Item 6b's
refusal of capacity-mode MoE under tp is ``test_torch_moe_ep.py``'s.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import moe as jmoe
from kubeflow_tpu_torch.models import moe as tmoe
from kubeflow_tpu_torch.parallel import distributed as pd
from torch_moe_ep_gangs import block_config, block_weights, reference_block

TOL = 1e-5
LAYOUTS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}        # ranks: [(tp, ep)]

WORKER = r"""
import json, os, torch
import torch.distributed as dist
from kubeflow_tpu_torch.models import moe
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.serving import sharded

torch.set_num_threads(1)
spec = json.loads(os.environ["GANG_SPEC"])
pd.initialize_from_env(device="cpu")
world = pd.world_size(pd.default_group())
blob = torch.load(spec["blob"], weights_only=True)
calls = []
_all_reduce = dist.all_reduce


def all_reduce(t, *a, **k):
    calls.append(list(t.shape))
    return _all_reduce(t, *a, **k)


dist.all_reduce = all_reduce
out = {"rank": dist.get_rank()}
for tp, ep in spec["layouts"]:
    block = moe.MoEBlock(moe.MoEConfig(**spec["config"]), device="cpu")
    block.load_state_dict(blob["weights"])
    with torch.no_grad():
        one = block(blob["x"], dropless=True)[0]
    mesh = make_mesh(world, dp=1, tp=tp, ep=ep, device_type="cpu")
    sharded.place_params(block, mesh)
    calls.clear()
    with torch.no_grad():
        y = block(blob["x"], dropless=True)[0]
    out[f"tp{tp}_ep{ep}"] = {
        "y": y.tolist(), "bitwise": torch.equal(y, one),
        "one_rel": ((y - one).abs().max() / one.abs().max()).item(),
        "all_reduces": list(calls), "w_in": list(block.w_in.shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    module, params, x, _ = reference_block()
    root = tmp_path_factory.mktemp("moe_serving")
    torch.save({"weights": block_weights(params), "x": torch.from_numpy(x)},
               root / "blob.pt")
    dropless = jmoe.MoEBlock(module.config, dropless=True)
    want = np.asarray(dropless.apply({"params": params},
                                     jnp.asarray(x))[0])
    return {"blob": str(root / "blob.pt"), "want": want, "gangs": {}}


def gang(setup, ranks: int) -> list[dict]:
    if ranks not in setup["gangs"]:
        spec = {"blob": setup["blob"], "config": block_config(),
                "layouts": LAYOUTS[ranks]}
        setup["gangs"][ranks] = pd.spawn_local_gang(
            WORKER, ranks, timeout=120.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return setup["gangs"][ranks]


@pytest.mark.parametrize("ranks, tp, ep", [(2, 1, 2), (2, 2, 1), (4, 2, 2)])
def test_dropless_block_matches_the_reference(setup, ranks, tp, ep):
    want = setup["want"]
    e, f = block_config()["num_experts"], block_config()["ffn_size"]
    for o in gang(setup, ranks):
        got = o[f"tp{tp}_ep{ep}"]
        y = np.asarray(got["y"], np.float32)
        assert np.abs(y - want).max() <= TOL * np.abs(want).max()
        if tp == 1:
            assert got["bitwise"], o["rank"]
        else:
            assert got["one_rel"] <= TOL
        assert got["w_in"] == [e // ep, block_config()["hidden_size"],
                               f // tp]
        # one all-reduce of the gated [T, D] per forward
        assert got["all_reduces"] == [[want.shape[0] * want.shape[1],
                                       want.shape[2]]]


def test_capacity_mode_under_tp_is_refused_by_the_block():
    """A block whose experts are split over tp refuses the capacity
    formulation by name (the train step refuses it first: item 6b)."""
    from kubeflow_tpu_torch.parallel.sharding import Split

    block = tmoe.MoEBlock(tmoe.MoEConfig(**block_config()), device="cpu")
    block.w_in.tp_split = Split("tp", None, 2, 2, 0)
    with pytest.raises(NotImplementedError, match="queue A item 6b"):
        block(torch.zeros(1, 4, block_config()["hidden_size"]))
