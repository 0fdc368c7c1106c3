"""The paged KV branch of the port's Llama, ``init_kv_pool`` and
``kv_page_nbytes``, at the tiny size in float32.

The port's paged branch against its own contiguous per-sequence cache
must be BITWISE equal (prefill, a decode step, and rows whose page tables
share a page): both attend over the same ``[B, span]`` keys through the
same plain masked route.  Against the reference's paged branch (flax
weights carried over by ``from_jax_params``) the logits must agree within
1e-5 of max |logit|, the port's float32 tolerance against the reference
(``test_torch_llama.py``): the frameworks sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl

PS, MAX_LEN = 16, 64
REF_TOL = 1e-5
TOKS = [[(i * 7) % 511 + 1 for i in range(20)],
        [(i * 13) % 511 + 1 for i in range(20)]]


@pytest.fixture(scope="module")
def models():
    jcfg = jl.llama_tiny(dtype="float32")
    jm = jl.LlamaModel(jcfg)
    params = unbox_params(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tcfg = tl.llama_tiny(dtype="float32")
    tm = tl.LlamaModel(tcfg, device="cpu")
    tm.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def paged_cache(pool, tables, index):
    return {"layers": [dict(pool_k=l["k"], pool_v=l["v"], pages=tables,
                            index=index) for l in pool["layers"]]}


def rel_err(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(out.numpy() - ref)) / np.max(np.abs(ref)))


@torch.no_grad()
def test_paged_matches_contiguous_bitwise(models):
    _, _, tm = models
    cfg = tm.config
    ids = torch.tensor(TOKS)
    ref = tm(ids, cache=tl.init_cache(cfg, 2, MAX_LEN, per_sequence=True,
                                      device="cpu"))
    pool = tl.init_kv_pool(cfg, 16, PS, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    zero = torch.zeros(2, dtype=torch.long)
    out = tm(ids, cache=paged_cache(pool, tables, zero))
    assert torch.equal(out["logits"], ref["logits"])
    # the pool was written in place at (page, offset) of each position
    for layer, got in zip(ref["cache"]["layers"], pool["layers"]):
        flat = got["k"][tables].reshape(2, 4 * PS, *got["k"].shape[2:])
        assert torch.equal(flat[:, :20], layer["k"][:, :20])

    # one decode step on both caches
    nxt = ref["logits"][:, -1].argmax(-1)[:, None]
    idx = torch.full((2,), 20, dtype=torch.long)
    ref2 = tm(nxt, cache={"layers": [dict(k=l["k"], v=l["v"], index=idx)
                                     for l in ref["cache"]["layers"]]})
    out2 = tm(nxt, cache=paged_cache(pool, tables, idx))
    assert torch.equal(out2["logits"], ref2["logits"])
    assert out2["cache"]["layers"][0]["index"].tolist() == [21, 21]

    # page SHARING: row 1 reuses row 0's first page and prefills only its
    # suffix; its logits equal a private contiguous layout's
    shared = [TOKS[0], TOKS[0][:16] + TOKS[1][16:]]
    sids = torch.tensor(shared)
    ref_s = tm(sids, cache=tl.init_cache(cfg, 2, MAX_LEN, per_sequence=True,
                                         device="cpu"))
    pool2 = tl.init_kv_pool(cfg, 16, PS, device="cpu")
    tm(sids[:1], cache=paged_cache(pool2, torch.tensor([[1, 2]]),
                                   torch.zeros(1, dtype=torch.long)))
    o_row1 = tm(sids[1:, 16:], cache=paged_cache(
        pool2, torch.tensor([[1, 5]]), torch.full((1,), 16,
                                                  dtype=torch.long)))
    assert torch.equal(o_row1["logits"][0], ref_s["logits"][1, 16:])


@torch.no_grad()
def test_paged_matches_reference_paged(models):
    jm, params, tm = models
    jcfg = jm.config
    tables = [[1, 2, 3, 4], [5, 6, 7, 8]]
    jpool = jl.init_kv_pool(jcfg, num_pages=16, page_size=PS)
    jout = jm.apply({"params": params}, jnp.asarray(TOKS, jnp.int32),
                    cache=paged_cache(jpool, jnp.asarray(tables, jnp.int32),
                                      jnp.zeros((2,), jnp.int32)))
    pool = tl.init_kv_pool(tm.config, 16, PS, device="cpu")
    out = tm(torch.tensor(TOKS), cache=paged_cache(
        pool, torch.tensor(tables), torch.zeros(2, dtype=torch.long)))
    assert rel_err(out["logits"], jout["logits"]) < REF_TOL
    for got, want in zip(pool["layers"], jout["cache"]["layers"]):
        for name in ("k", "v"):
            ref = np.asarray(want[f"pool_{name}"])
            assert np.max(np.abs(got[name].numpy() - ref)) < REF_TOL * max(
                1.0, np.max(np.abs(ref)))

    # a decode step on each side from its own pool
    nxt = jnp.argmax(jout["logits"][:, -1], -1).astype(jnp.int32)[:, None]
    idx = jnp.full((2,), 20, jnp.int32)
    jcache = {"layers": [dict(l, index=idx) for l in jout["cache"]["layers"]]}
    jout2 = jm.apply({"params": params}, nxt, cache=jcache)
    out2 = tm(torch.tensor(np.asarray(nxt)).long(), cache=paged_cache(
        pool, torch.tensor(tables), torch.full((2,), 20, dtype=torch.long)))
    assert rel_err(out2["logits"], jout2["logits"]) < REF_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", ["tiny", "7b"])
def test_init_kv_pool_and_page_nbytes_match_reference(dtype, size):
    make_j = {"tiny": jl.llama_tiny, "7b": jl.llama2_7b}[size]
    make_t = {"tiny": tl.llama_tiny, "7b": tl.llama2_7b}[size]
    jcfg, tcfg = make_j(dtype=dtype), make_t(dtype=dtype)
    for page in (1, 16, 32):
        assert tl.kv_page_nbytes(tcfg, page) == jl.kv_page_nbytes(jcfg, page)
    if size == "tiny":
        jpool = jl.init_kv_pool(jcfg, 5, 16)
        tpool = tl.init_kv_pool(tcfg, 5, 16, device="cpu")
        assert len(tpool["layers"]) == len(jpool["layers"])
        for t, j in zip(tpool["layers"], jpool["layers"]):
            for name in ("k", "v"):
                assert tuple(t[name].shape) == j[name].shape
                assert str(t[name].dtype).endswith(dtype)
                assert not t[name].any()
