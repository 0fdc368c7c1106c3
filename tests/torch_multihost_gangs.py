"""The multi-host serving gangs' shared parts: the reference's weights as
the port's state dict, the gang worker, the reference's decodes and its
per-device shards.

``test_torch_multihost_gangs.py`` runs a 4-process dp=2 x tp=2 gang and
a 2-process tp=2 gang (the reference's ``GANG_SCRIPT``, and int8) of the
port on the CPU over gloo, each spawned once, and holds them to the
reference's ``MultiHostPredictor`` on the 8-device CPU mesh and to its
engine.  Both sides run the tiny Llama in float32.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import registry as jreg
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving.quant import QTensor as JQTensor
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.parallel import distributed as pd

# the reference test's prompts, and its gang's
PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [5], [11, 12]]
GANG_PROMPTS = PROMPTS[:2]
CFG = {"dtype": "float32"}
MAX_SEQ, NEW = 64, 8

WORKER = r"""
import hashlib, json, os, torch
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.serving import sharded
from kubeflow_tpu_torch.serving.multihost import (
    MultiHostPredictor, broadcast_prompts, constrain_cache)
from kubeflow_tpu_torch.serving.quant import QTensor

torch.set_num_threads(1)
spec = json.loads(os.environ["GANG_SPEC"])
rdv = pd.initialize_from_env(device="cpu")
rank = pd.rank_of(pd.default_group())
state = torch.load(spec["state"], weights_only=True)


def sha(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def blocks(module):
    out = {}
    for mod_name, m in module.named_modules():
        for leaf, w in [*m.named_parameters(recurse=False),
                        *((n, c) for n, c in m.named_children()
                          if isinstance(c, QTensor))]:
            split = getattr(w, "tp_split", None)
            rec = {"tp": None if split is None else
                   [split.dim, split.size, split.index]}
            if isinstance(w, QTensor):
                rec.update(q=list(w.q.shape), scale=list(w.scale.shape),
                           q_sha=sha(w.q), scale_sha=sha(w.scale))
            else:
                rec.update(shape=list(w.shape))
            out[f"{mod_name}.{leaf}"] = rec
    return out


def refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


BF16 = {**spec["cfg"], "dtype": "bfloat16"}
mk = dict(size="tiny", max_seq=spec["max_seq"], model_config=spec["cfg"],
          state=state, device="cpu")
out = {"rank": rank, "backend": rdv["backend"]}
if spec["layout"] == "dp2_tp2":
    mh = MultiHostPredictor("llama", tp=2, dp=2, **mk)
    out["coords"] = [mh.mesh.coordinate("dp"), mh.mesh.coordinate("tp")]
    out["ids"] = mh.generate(spec["prompts"], max_new_tokens=spec["new"])
    out["blocks"] = blocks(mh.module)
    (cache,) = mh._gen_cache.values()
    out["cache"] = [list(layer[k].shape) for layer in cache["layers"]
                    for k in ("k", "v")]
    out["gen_keys"] = [list(k) for k in mh._gen_cache]
    whole = llama.init_cache(mh.cfg, 4, 32, device="cpu")
    out["refuses_whole"] = refused(lambda: constrain_cache(
        whole, mh.mesh, batch=4, num_kv_heads=mh.cfg.num_kv_heads))
    mine = sharded.shard_cache(llama.init_cache(mh.cfg, 2, 32, device="cpu"),
                               mh.mesh, mh.cfg.num_kv_heads)
    out["sharded_cache"] = list(mine["layers"][0]["k"].shape)
    out["accepts_own"] = constrain_cache(
        mine, mh.mesh, batch=4, num_kv_heads=mh.cfg.num_kv_heads) is mine
    out["pad"] = mh.generate([[1, 2, 3]], max_new_tokens=6)
    out["kv_heads"] = refused(lambda: MultiHostPredictor("llama", tp=4,
                                                         dp=1, **mk))
else:
    prompts = broadcast_prompts(spec["prompts"] if rank == 0 else None,
                                max_items=4, max_len=16)
    out["prompts"] = prompts
    out["ids"] = MultiHostPredictor("llama", tp=2, **mk).generate(
        prompts, max_new_tokens=spec["new"])
    mq = MultiHostPredictor("llama", tp=2, quantize=True, **mk)
    out["int8_ids"] = mq.generate(prompts, max_new_tokens=spec["new"])
    out["int8_logits"] = mq.prefill_logits.tolist()
    out["blocks"] = blocks(mq.module)
    # a whole quantized model placed in one call: the predictor's blocks
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.serving.quant import quantize_params
    whole = registry.get("llama").make_model(size="tiny", device="cpu",
                                             **spec["cfg"])
    whole.load_state_dict(state)
    quantize_params(whole)
    out["shard_params_blocks"] = blocks(sharded.shard_params(whole,
                                                             mq.mesh))
    # bf16 weights from the seed: each row-parallel product's two halves
    # are summed over tp in bf16
    mb = MultiHostPredictor("llama", tp=2, **dict(mk, state=None,
                                                  model_config=BF16))
    mb.generate(prompts, max_new_tokens=1)
    out["bf16_logits"] = mb.prefill_logits.float().tolist()
print(json.dumps(out))
"""


def flat(tree: dict, prefix: str = "") -> dict:
    """A flax params tree by the port's names; an int8 leaf stays a
    ``QTensor``."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flat(val, path))
        else:
            out[path.replace("layer_", "layers.")] = val
    return out


def shard_at(x, mesh, dp: int, tp: int):
    """The reference's shard of placed array ``x`` on the device at mesh
    coordinate (dp, tp), as numpy."""
    device = mesh.devices[dp, 0, tp, 0, 0, 0]
    (shard,) = [s for s in x.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's seed-0 init as the port's state dict (a file), the
    reference's decodes (its engine, its dp=2 x tp=2 and int8 tp=2
    ``MultiHostPredictor``), and its placed params."""
    from kubeflow_tpu.serving.multihost import MultiHostPredictor
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    root = tmp_path_factory.mktemp("multihost")
    module = jreg.get("llama").make_model(size="tiny", **CFG)
    params = unbox_params(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    host = jax.tree.map(np.asarray, params)
    torch.save(convert.from_jax_params(host, tl.llama_tiny(**CFG)),
               root / "state.pt")
    engine = GenerativePredictor("llama", size="tiny", max_batch=4,
                                 max_seq=MAX_SEQ, model_config=CFG)
    try:
        engine_ids = engine.generate(PROMPTS, max_new_tokens=NEW,
                                     temperature=0.0)["ids"]
        engine_pad = engine.generate([[1, 2, 3]], max_new_tokens=6,
                                     temperature=0.0)["ids"]
    finally:
        engine.engine.shutdown()
    mh = MultiHostPredictor("llama", size="tiny", tp=2, dp=2,
                            max_seq=MAX_SEQ, model_config=CFG)
    mq = MultiHostPredictor("llama", size="tiny", tp=2, max_seq=MAX_SEQ,
                            quantize=True, model_config=CFG)
    ids = np.zeros((len(GANG_PROMPTS), 8), np.int32)
    for i, p in enumerate(GANG_PROMPTS):
        ids[i, :len(p)] = p
    logits = np.asarray(mq.module.apply({"params": mq.params},
                                        jnp.asarray(ids))["logits"])
    return {"root": root, "module": module, "engine_ids": engine_ids,
            "engine_pad": engine_pad, "mh": mh,
            "ids": mh.generate(PROMPTS, max_new_tokens=NEW),
            "mq": mq,
            "int8_ids": mq.generate(GANG_PROMPTS, max_new_tokens=NEW),
            "int8_logits": np.stack([logits[i, len(p) - 1]
                                     for i, p in enumerate(GANG_PROMPTS)]),
            "gangs": {}}


def gang(setup, layout: str) -> list[dict]:
    """The port's gang of ``layout`` ("dp2_tp2": 4 ranks, "tp2": 2),
    spawned once per module; each rank's output in rank order."""
    if layout not in setup["gangs"]:
        spec = {"layout": layout, "state": str(setup["root"] / "state.pt"),
                "cfg": CFG, "max_seq": MAX_SEQ, "new": NEW,
                "prompts": PROMPTS if layout == "dp2_tp2" else GANG_PROMPTS}
        setup["gangs"][layout] = pd.spawn_local_gang(
            WORKER, 4 if layout == "dp2_tp2" else 2, timeout=240.0,
            extra_env={"GANG_SPEC": json.dumps(spec)})
    return setup["gangs"][layout]


def reference_leaves(pred) -> dict:
    """A reference predictor's placed params by the port's names."""
    return flat(pred.params)


def is_int8(leaf) -> bool:
    return isinstance(leaf, JQTensor)
