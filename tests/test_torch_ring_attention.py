"""Ring attention of the PyTorch port against the reference's, on the CPU.

One 4-process gloo gang at sp = 4 (``spawn_local_gang``) runs the port's
``ring_attention`` (its K1/K2/K3 wrappers take their plain versions on a
CPU tensor) and ``ring_attention_reference`` on each rank's chunk of the
sequence, at the reference test's shapes (B, S, H, D = 4, 64, 2, 16),
causal and not, and a GQA case (4 query heads over 2 KV heads) through
``dot_product_attention`` under ``ring_context``.  The reference runs
``make_ring_attention`` over its (dp 2, sp 4) mesh of the conftest's 8
host devices on the same numpy inputs (the GQA case through its
dispatcher, which repeats K/V up to the query heads).  Held: every
rank's output chunk within 1e-5 of the reference's, and its chunks of
the gradients of sum(out^2) within 1e-5 of max |ref|.

In one process: ``ring_attention_reference`` on one rank against
``plain_attention``, the dispatcher's conditions (a mask, Sq != Sk, an
sp axis of one rank), and the ``ValueError`` for a mesh without the
axis.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops.ring_attention import (
    make_ring_attention as jmake_ring)
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops import ring_attention as tring
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import mesh as tmesh

SP = 4
B, S, D = 4, 64, 16
CASES = {  # case: (query heads, kv heads, causal)
    "noncausal": (2, 2, False),
    "causal": (2, 2, True),
    "gqa_causal": (4, 2, True),
}

WORKER = r"""
import json, os
import numpy as np
import torch
from kubeflow_tpu_torch.ops import attention as attn
from kubeflow_tpu_torch.ops import ring_attention as ring
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
pd.initialize_from_env(device="cpu")
spec = json.loads(os.environ["RING_SPEC"])
mesh = make_mesh(dp=1, sp=spec["sp"], device_type="cpu")
i, n = mesh.coordinate("sp"), spec["sp"]
out = {}
for name, (hq, hkv, causal) in spec["cases"].items():
    data = np.load(os.path.join(spec["dir"], name + ".npz"))
    chunk = lambda a: torch.tensor(a[:, i * a.shape[1] // n:
                                        (i + 1) * a.shape[1] // n])
    for kind in ("ring", "reference"):
        q, k, v = (chunk(data[x]).requires_grad_() for x in "qkv")
        if kind == "reference":
            o = ring.ring_attention_reference(q, k, v, group=mesh.group("sp"),
                                              causal=causal)
        elif hq != hkv:     # GQA through the dispatcher
            with attn.ring_context(mesh):
                o = attn.dot_product_attention(q, k, v, causal=causal)
        else:
            o = ring.make_ring_attention(mesh, causal=causal)(q, k, v)
        (o ** 2).sum().backward()
        out[name + "/" + kind] = [t.tolist() for t in
                                  (o, q.grad, k.grad, v.grad)]
print(json.dumps(out))
"""


def inputs(name: str) -> dict:
    hq, hkv, _ = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    return {"q": rng.standard_normal((B, S, hq, D)).astype(np.float32),
            "k": rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            "v": rng.standard_normal((B, S, hkv, D)).astype(np.float32)}


@functools.cache
def reference(name: str):
    """(out, dq, dk, dv) of the reference's ring over (dp 2, sp 4)."""
    _, _, causal = CASES[name]
    mesh = jmake_mesh(8, dp=2, fsdp=1, tp=1, sp=SP)
    x = {k: jnp.asarray(v) for k, v in inputs(name).items()}

    def f(q, k, v):
        with mesh:
            if q.shape[2] != k.shape[2]:
                with jattn.ring_context(mesh):
                    return jattn.dot_product_attention(q, k, v,
                                                       causal=causal)
            return jmake_ring(mesh, causal=causal)(q, k, v)

    def loss(q, k, v):
        out = f(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return [np.asarray(t) for t in (out, *grads)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    for name in CASES:
        np.savez(root / f"{name}.npz", **inputs(name))
    spec = {"sp": SP, "cases": CASES, "dir": str(root)}
    return pd.spawn_local_gang(WORKER, SP, timeout=120.0,
                               extra_env={"RING_SPEC": json.dumps(spec)})


@pytest.mark.parametrize("kind", ["ring", "reference"])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_chunks_match_the_reference_ring(gang, name, kind):
    want = reference(name)
    for rank, out in enumerate(gang):
        got = [np.asarray(t) for t in out[f"{name}/{kind}"]]
        sl = slice(rank * S // SP, (rank + 1) * S // SP)
        np.testing.assert_allclose(got[0], want[0][:, sl], rtol=0,
                                   atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            err = np.abs(g - w[:, sl]).max() / np.abs(w).max()
            assert err <= 1e-5, (name, kind, rank, err)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_ring_on_one_rank_is_plain_attention(causal, hq, hkv):
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 24, h, 8)),
                            dtype=torch.float32)
               for h in (hq, hkv, hkv))
    got = tring.ring_attention_reference(q, k, v, group=None, causal=causal)
    want = tattn.plain_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the ring itself on one rank: K1 of the diagonal block alone
    got = tring.ring_attention(q, k, v, group=None, causal=causal)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def sp_layout(sp: int):
    """A mesh of ``sp`` ranks on sp, this process rank 0, whose group is a
    stand-in (the dispatcher's choice is checked, no collective runs)."""
    return tmesh.Mesh(np.arange(sp).reshape(1, 1, 1, sp, 1, 1),
                      device_mesh=object(), _groups={("sp",): "sp"})


def test_dispatcher_takes_the_ring_only_where_the_reference_does(
        monkeypatch):
    calls = []
    monkeypatch.setattr(tring, "make_ring_attention",
                        lambda mesh, **kw: calls.append(kw) or (
                            lambda q, k, v: "ring"))
    q = torch.zeros(1, 8, 2, 16)
    mask = torch.ones(1, 1, 8, 8, dtype=torch.bool)
    with tattn.ring_context(sp_layout(2)):
        assert tattn.dot_product_attention(q, q, q, causal=True) == "ring"
        # a mask, or a decode-shaped call (Sq != Sk), stays local
        assert torch.is_tensor(tattn.dot_product_attention(q, q, q,
                                                           mask=mask))
        assert torch.is_tensor(tattn.dot_product_attention(
            q[:, :1], q, q, causal=True))
        assert tattn.sequence_offset(8) == 0      # rank 0's chunk
    assert calls == [{"causal": True, "axis_name": "sp"}]
    with tattn.ring_context(sp_layout(1)):      # one rank: no ring
        assert torch.is_tensor(tattn.dot_product_attention(q, q, q))
        assert tattn._active_ring() is None
    assert tattn._active_ring() is None and len(calls) == 1


def test_a_mesh_without_the_axis_is_refused():
    devices = np.array(jax.devices()[:2])
    with pytest.raises(ValueError, match="no 'sp' axis"):
        jmake_ring(JaxMesh(devices, ("dp",)))
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tring.make_ring_attention(sp_layout(2), axis_name="seq")
