"""Weight residency and streamed checkpoints of the port against the
reference's ``serving/model_pool.py``.

The ``ModelPool``/``PagePool`` scenarios of ``tests/test_model_pool.py``
(residency LRU, cold-start coalescing, weights-and-pages arbitration) are
written once and driven on both packages under one ``FakeClock`` each:
after every step the two sides must agree on states, ``stats()``, bytes
freed, and donated and reclaimed page counts.  The streamed checkpoint
format is held in both directions: a checkpoint the reference writes
serves the JAX predictor's greedy stream through the port, and a float32
port module's checkpoint restores bitwise through the reference.  Park
and warm keep streams token-identical, and the leased HTTP path coalesces
concurrent cold requests behind one load.
"""

import io
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch import nn

from kubeflow_tpu.serving import model_pool as jmp
from kubeflow_tpu.serving import page_pool as jpp
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import model_pool as tmp_
from kubeflow_tpu_torch.serving import page_pool as tpp
from kubeflow_tpu_torch.serving import predictor as tpred

REF = SimpleNamespace(pool=jmp, pages=jpp.PagePool)
PORT = SimpleNamespace(pool=tmp_, pages=tpp.PagePool)
SIDES = (REF, PORT)


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def loader_of(nbytes: int, calls: list | None = None):
    def loader():
        if calls is not None:
            calls.append(nbytes)
        return (f"weights-{nbytes}", nbytes)
    return loader


def snapshot(side, mp, names) -> dict:
    return {"stats": mp.stats(), "states": {n: mp.state_of(n)
                                            for n in names},
            "weight_bytes": mp.weight_bytes(),
            "donated_bytes": mp.donated_bytes()}


def both(scenario):
    """Run ``scenario(side, log)`` on each package; the two logs of
    observations must be equal step for step."""
    logs = []
    for side in SIDES:
        log: list = []
        scenario(side, log)
        logs.append(log)
    assert len(logs[0]) == len(logs[1]) > 0
    for i, (a, b) in enumerate(zip(*logs)):
        assert a == b, (i, a, b)
    return logs[1]


# -- residency LRU ---------------------------------------------------------------

def lru_acquire_pins_release_unpins(side, log):
    clk = FakeClock()
    mp = side.pool.ModelPool(1024, clock=clk)
    calls = []
    mp.register("m", loader_of(100, calls))
    log.append(mp.acquire("m"))
    log.append(snapshot(side, mp, ["m"]))
    log.append(mp.evict_lru())           # pinned: no victim
    mp.release("m")
    log.append(mp.evict_lru())
    log.append(snapshot(side, mp, ["m"]))
    log.append(list(calls))
    with pytest.raises(ValueError):
        mp.release("m")


def lru_evicts_least_recently_released(side, log):
    clk = FakeClock()
    mp = side.pool.ModelPool(250, clock=clk)
    for name in ("a", "b", "c"):
        mp.register(name, loader_of(100))
    for name in ("a", "b"):
        mp.acquire(name)
        mp.release(name)
        clk.advance(1)
        log.append(snapshot(side, mp, ["a", "b", "c"]))
    mp.acquire("c")
    log.append(snapshot(side, mp, ["a", "b", "c"]))
    mp.release("c")


def lru_pinned_models_overshoot(side, log):
    clk = FakeClock()
    mp = side.pool.ModelPool(150, clock=clk)
    mp.register("hot", loader_of(100))
    mp.register("cold", loader_of(100))
    mp.acquire("hot")
    mp.acquire("cold")                   # 200 > 150: every model pinned
    log.append(snapshot(side, mp, ["hot", "cold"]))
    mp.release("cold")
    mp.release("hot")
    clk.advance(1)
    mp.register("late", loader_of(100))
    mp.acquire("late")
    log.append(snapshot(side, mp, ["hot", "cold", "late"]))


def lru_nbytes_hint_preevicts(side, log):
    clk = FakeClock()
    mp = side.pool.ModelPool(200, clock=clk)
    mp.register("a", loader_of(150))
    mp.acquire("a")
    mp.release("a")
    clk.advance(1)
    seen = {}

    def loader_b():
        seen["bytes_at_load"] = mp.weight_bytes()
        return ("wb", 150)

    mp.register("b", loader_b, nbytes_hint=150)
    mp.acquire("b")
    log.append(seen["bytes_at_load"])
    log.append(snapshot(side, mp, ["a", "b"]))
    mp.release("b")


def lru_draining(side, log):
    clk = FakeClock()
    mp = side.pool.ModelPool(1024, clock=clk)
    mp.register("m", loader_of(100))
    mp.acquire("m")
    mp.drain("m")
    with pytest.raises(side.pool.ModelDraining):
        mp.acquire("m")
    log.append(snapshot(side, mp, ["m"]))
    mp.release("m")
    log.append(snapshot(side, mp, ["m"]))


def lru_evictor_and_on_change(side, log):
    clk = FakeClock()
    changes = []
    mp = side.pool.ModelPool(1024, clock=clk, on_change=changes.append)
    freed = []
    mp.register("m", loader_of(100),
                evictor=lambda: freed.append(100) or 100)
    mp.acquire("m")
    mp.release("m")
    log.append(sorted(changes[-1]))
    log.append(mp.evict("m"))
    log.append(list(freed))
    log.append(sorted(changes[-1]))
    log.append(snapshot(side, mp, ["m"]))
    mp.unregister("m")
    log.append(mp.has("m"))


@pytest.mark.parametrize("scenario", [
    lru_acquire_pins_release_unpins, lru_evicts_least_recently_released,
    lru_pinned_models_overshoot, lru_nbytes_hint_preevicts, lru_draining,
    lru_evictor_and_on_change], ids=lambda f: f.__name__)
def test_residency_lru_matches_reference(scenario):
    log = both(scenario)
    if scenario is lru_evicts_least_recently_released:
        assert log[-1]["states"] == {"a": "parked", "b": "resident",
                                     "c": "resident"}
    if scenario is lru_nbytes_hint_preevicts:
        assert log[0] == 0        # "a" evicted before b's loader ran


# -- cold-start coalescing ---------------------------------------------------------

def coalesce_k_concurrent(side, log, k=6):
    mp = side.pool.ModelPool(1024)
    calls = []
    gate = threading.Event()

    def slow_loader():
        calls.append(1)
        gate.wait(10)
        return ("w", 100)

    mp.register("m", slow_loader)
    results = []

    def worker():
        results.append(mp.acquire("m", timeout=30))
        mp.release("m")

    threads = [threading.Thread(target=worker) for _ in range(k)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while mp.stats()["coalesced_total"] < k - 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    stats = mp.stats()
    stats["models"]["m"].pop("last_load_seconds")   # a host time
    log.append((len(calls), results, stats))


def coalesce_failed_leader_retries(side, log):
    mp = side.pool.ModelPool(1024)
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise OSError("checkpoint unreachable")
        return ("w", 100)

    mp.register("m", flaky)
    with pytest.raises(OSError):
        mp.acquire("m")
    log.append(mp.state_of("m"))
    log.append(mp.acquire("m"))
    mp.release("m")
    log.append(len(attempts))


def coalesce_follower_sees_failure(side, log):
    mp = side.pool.ModelPool(1024)
    entered, gate = threading.Event(), threading.Event()

    def doomed():
        entered.set()
        gate.wait(10)
        raise RuntimeError("boom")

    mp.register("m", doomed)
    errors = []

    def call(who):
        try:
            mp.acquire("m", timeout=30)
        except Exception as e:
            errors.append((who, type(e).__name__))

    lead = threading.Thread(target=call, args=("leader",))
    lead.start()
    assert entered.wait(10)
    follow = threading.Thread(target=call, args=("follower",))
    follow.start()
    deadline = time.monotonic() + 10
    while mp.stats()["coalesced_total"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in (lead, follow):
        t.join(timeout=30)
        assert not t.is_alive()
    log.append(sorted(errors))
    log.append(mp.state_of("m"))


@pytest.mark.parametrize("scenario", [
    coalesce_k_concurrent, coalesce_failed_leader_retries,
    coalesce_follower_sees_failure], ids=lambda f: f.__name__)
def test_cold_start_coalescing_matches_reference(scenario):
    log = both(scenario)
    if scenario is coalesce_k_concurrent:
        calls, results, stats = log[0]
        assert calls == 1 and results == ["w"] * 6
        assert stats["loads_total"] == 1 and stats["coalesced_total"] == 5
    if scenario is coalesce_follower_sees_failure:
        assert log[0] == [("follower", "RuntimeError"),
                          ("leader", "RuntimeError")]


# -- weights and KV pages: one currency ------------------------------------------

def pool_view(pool) -> dict:
    stats = pool.stats()
    stats.pop("device_rows", None)       # the port's storage, not shared
    stats.pop("fault_wait_seconds", None)
    return {"num_pages": pool.num_pages, "free_count": pool.free_count,
            "stats": stats}


def relieve_donates(side, log):
    clk = FakeClock()
    pool = side.pages(4, 4, page_nbytes=64)
    mp = side.pool.ModelPool(512, clock=clk)
    mp.register("cold", loader_of(256))
    mp.acquire("cold")
    mp.release("cold")
    log.append(pool.alloc(3))
    log.append(pool.alloc(1))            # dry
    log.append(mp.relieve(pool))         # 256 // 64 = 4 slots
    log.append(snapshot(side, mp, ["cold"]))
    log.append(pool.alloc(1))
    log.append(pool_view(pool))


def relieve_without_victim(side, log):
    mp = side.pool.ModelPool(512)
    log.append(mp.relieve(None))
    log.append(mp.relieve(side.pages(4, 4, page_nbytes=64)))


def reload_reclaims_free_slots_only(side, log):
    clk = FakeClock()
    pool = side.pages(4, 4, page_nbytes=64)
    mp = side.pool.ModelPool(512, clock=clk)
    mp.register("a", loader_of(256))
    mp.register("b", loader_of(384), nbytes_hint=384)
    mp.acquire("a")
    mp.release("a")
    pool.alloc(3)
    log.append(mp.relieve(pool))
    clk.advance(1)
    log.append(pool.alloc(1))
    mp.acquire("b")                      # reclaims the 3 free slots only
    log.append(snapshot(side, mp, ["a", "b"]))
    log.append(pool_view(pool))
    mp.release("b")


def donate_and_reclaim_units(side, log):
    pool = side.pages(4, 4, page_nbytes=64)
    held = pool.alloc(3)
    log.append(pool.alloc(1))
    pool.donate(2)
    log.append(pool_view(pool))
    more = pool.alloc(2)
    log.append(more)
    log.append(pool.reclaim(2))          # every slot occupied
    pool.decref(more)
    log.append(pool.reclaim(5))          # capped at the free headroom
    log.append(pool_view(pool))
    log.append(pool.alloc(1))
    pool.decref(held)
    log.append(pool_view(pool))


def alternating_relieve_and_reload(side, log):
    """Pressure and the model's return alternate: each relieve donates
    the model's slots and each reload takes every free one back."""
    clk = FakeClock()
    pool = side.pages(4, 4, page_nbytes=64)
    mp = side.pool.ModelPool(256, clock=clk)
    mp.register("m", loader_of(256))
    for _ in range(3):
        mp.acquire("m")
        mp.release("m")
        held = pool.alloc(3)
        log.append(pool.alloc(1))        # dry
        log.append(mp.relieve(pool))     # 256 // 64 = 4 slots
        more = pool.alloc(4)
        log.append(pool_view(pool))
        pool.decref(more + held)
        clk.advance(1)
        mp.acquire("m")                  # reclaims the 4 free slots
        mp.release("m")
        log.append(snapshot(side, mp, ["m"]))
        log.append(pool_view(pool))


@pytest.mark.parametrize("scenario", [
    relieve_donates, relieve_without_victim,
    reload_reclaims_free_slots_only, donate_and_reclaim_units,
    alternating_relieve_and_reload],
    ids=lambda f: f.__name__)
def test_weight_page_arbitration_matches_reference(scenario):
    log = both(scenario)
    if scenario is reload_reclaims_free_slots_only:
        assert log[2]["donated_bytes"] == 64
        assert log[3]["num_pages"] == 5
        assert log[3]["stats"]["in_use"] == 4


def test_donation_grows_device_rows_and_keeps_pages():
    """A pool with storage grows every layer's row tensors by the donated
    slots; a committed page keeps its bytes across the growth, and a
    reclaim leaves the rows reserved."""
    cfg = tl.llama_tiny(dtype="float32")
    kv = tl.init_kv_pool(cfg, 4, 2, device="cpu")
    pool = tpp.PagePool(4, 2, page_nbytes=tl.kv_page_nbytes(cfg, 2), kv=kv)
    (page,) = pool.alloc(1)
    rng = np.random.default_rng(0)
    layers = [(torch.from_numpy(rng.standard_normal(
        (2, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)),) * 2
        for _ in range(cfg.num_layers)]
    pool.put_many([page], layers)
    before = pool.get(page)["layers"][1]["k"].clone()
    pool.donate(3)
    assert pool.kv["layers"][0]["k"].shape[0] == 7
    assert pool.stats()["device_rows"] == 7
    assert torch.equal(pool.get(page)["layers"][1]["k"], before)
    fresh = pool.alloc(5)                # 2 old free + 3 donated
    assert fresh is not None and pool.alloc(1) is None
    pool.decref(fresh)
    assert pool.reclaim(3) == 3
    assert pool.stats()["pages"] == 3 and pool.stats()["device_rows"] == 7


def test_donation_after_reclaim_reuses_reserved_rows():
    """The rows a reclaim leaves reserved back the next donation: cycles
    of donate and reclaim hold the row tensors at their first size, a
    committed page keeps its bytes throughout, and only a donation past
    the reserved rows grows the tensors again."""
    cfg = tl.llama_tiny(dtype="float32")
    kv = tl.init_kv_pool(cfg, 4, 2, device="cpu")
    pool = tpp.PagePool(4, 2, page_nbytes=tl.kv_page_nbytes(cfg, 2), kv=kv)
    mp = tmp_.ModelPool(3 * pool.page_nbytes, clock=FakeClock())
    mp.register("m", loader_of(3 * pool.page_nbytes))
    (page,) = pool.alloc(1)
    rng = np.random.default_rng(1)
    layers = [(torch.from_numpy(rng.standard_normal(
        (2, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)),) * 2
        for _ in range(cfg.num_layers)]
    pool.put_many([page], layers)
    before = pool.get(page)["layers"][1]["k"].clone()
    for _ in range(4):
        mp.acquire("m")
        mp.release("m")
        assert mp.relieve(pool)          # 3 slots
        assert pool.stats()["pages"] == 6
        assert pool.kv["layers"][0]["k"].shape[0] == 7
        fresh = pool.alloc(5)
        assert fresh is not None and pool.alloc(1) is None
        pool.decref(fresh)
        mp.acquire("m")                  # reclaims the 3 slots
        mp.release("m")
        assert mp.stats()["donated_pages"] == 0
        assert pool.stats()["pages"] == 3
        assert pool.stats()["device_rows"] == 7
        assert torch.equal(pool.get(page)["layers"][1]["k"], before)
    pool.donate(5)                       # 3 reserved rows + 2 new
    assert pool.stats()["device_rows"] == 9
    assert pool.kv["layers"][0]["k"].shape[0] == 9
    assert pool.alloc(7) is not None
    assert torch.equal(pool.get(page)["layers"][1]["k"], before)


# -- streamed checkpoints ----------------------------------------------------------

class Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Module()
        self.dense.kernel = nn.Parameter(
            torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16))
        self.dense.bias = nn.Parameter(torch.ones(16))
        self.emb = nn.Parameter(torch.full((32, 4), 0.5,
                                           dtype=torch.bfloat16))


def test_save_restore_roundtrip_including_bf16(tmp_path):
    m = Small()
    d = str(tmp_path / "ckpt")
    total = tmp_.save_streamable(m, d)
    assert tmp_.is_streamable(d)
    like = dict(m.named_parameters())
    assert total == sum(p.numel() * p.element_size() for p in like.values())
    restored, report = tmp_.stream_restore(d, like)
    for name, p in like.items():
        assert restored[name].dtype == p.dtype
        assert torch.equal(restored[name], p.detach())
    assert report["tensors"] == 3 and report["bytes"] == total
    manifest = json.load(open(f"{d}/{tmp_.MANIFEST}"))
    assert [r["key"] for r in manifest["tensors"]] == [
        "['dense']['bias']", "['dense']['kernel']", "['emb']"]
    assert manifest["tensors"][2]["stored"] == "uint16"
    assert manifest["tensors"][2]["dtype"] == "bfloat16"


def test_staging_window_bounds_host_copies(tmp_path):
    m = nn.Module()
    for i in range(6):
        m.register_parameter(f"t{i}", nn.Parameter(
            torch.full((32, 32), float(i))))     # 4096 B each
    d = str(tmp_path / "ckpt")
    tmp_.save_streamable(m, d)
    like = dict(m.named_parameters())
    out, report = tmp_.stream_restore(d, like, staging_bytes=6000)
    assert 0 < report["max_staged_bytes"] <= 6000
    _, wide = tmp_.stream_restore(d, like, staging_bytes=1 << 20)
    assert wide["max_staged_bytes"] >= report["max_staged_bytes"]
    # a window smaller than one tensor: pieces, the bound still holds
    narrow, small = tmp_.stream_restore(d, like, staging_bytes=1000)
    assert 0 < small["max_staged_bytes"] <= 1000
    for name, p in like.items():
        assert torch.equal(narrow[name], p.detach())
        assert torch.equal(out[name], p.detach())


def test_float32_record_casts_into_a_bf16_target(tmp_path):
    m = Small()
    d = str(tmp_path / "ckpt")
    tmp_.save_streamable(m, d)
    like = {n: p.detach().to(torch.bfloat16)
            for n, p in m.named_parameters()}
    out, _ = tmp_.stream_restore(d, like, staging_bytes=100)
    for name, want in like.items():
        assert out[name].dtype == torch.bfloat16
        assert torch.equal(out[name], want)


def test_refusals_name_the_mismatch(tmp_path):
    m = nn.Module()
    m.w = nn.Parameter(torch.zeros(4, 4))
    d = str(tmp_path / "ckpt")
    tmp_.save_streamable(m, d)
    with pytest.raises(ValueError, match="checkpoint is"):
        tmp_.stream_restore(d, {"w": torch.zeros(4, 5)})
    with pytest.raises(ValueError, match="leaves"):
        tmp_.stream_restore(d, {"w": torch.zeros(4, 4),
                                "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="has no leaf"):
        tmp_.stream_restore(d, {"v": torch.zeros(4, 4)})
    b = nn.Module()
    b.w = nn.Parameter(torch.zeros(4, 4, dtype=torch.bfloat16))
    tmp_.save_streamable(b, str(tmp_path / "bf16"))
    # only float32 casts; a bf16 record into a float32 target is refused
    with pytest.raises(ValueError, match="checkpoint is"):
        tmp_.stream_restore(str(tmp_path / "bf16"), {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="streamable"):
        tmp_.read_manifest(str(tmp_path))


# -- both directions across the packages ---------------------------------------

PROMPT = [[5, 8, 13, 21]]


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A float32 llama_tiny the reference's predictor serves, its greedy
    stream, and the checkpoint its ``save_streamable`` wrote."""
    from kubeflow_tpu.serving.predictor import GenerativePredictor

    ref = GenerativePredictor("llama", size="tiny",
                              model_config={"dtype": "float32"},
                              max_batch=1, max_seq=64)
    d = str(tmp_path_factory.mktemp("ref") / "weights")
    try:
        stream = ref.generate(PROMPT, max_new_tokens=6)["ids"]
        jmp.save_streamable(ref.params, d)
    finally:
        ref.engine.shutdown()
    return d, stream


@pytest.fixture(scope="module")
def restored(reference_checkpoint):
    d, _ = reference_checkpoint
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        checkpoint_dir=d, seed=7, max_batch=2, max_seq=64, device="cpu")
    yield pred
    pred.stop(timeout=10)


def test_reference_checkpoint_serves_the_jax_stream(reference_checkpoint,
                                                    restored):
    # seed 7 inits other weights: the equal stream shows every tensor
    # was overwritten by the restore
    _, stream = reference_checkpoint
    assert restored.generate(PROMPT, max_new_tokens=6)["ids"] == stream
    assert restored.last_restore["tensors"] == len(
        dict(restored.module.named_parameters()))


def test_port_checkpoint_restores_bitwise_through_the_reference(tmp_path):
    module = tl.LlamaModel(tl.llama_tiny(), device="cpu").init_weights(3)
    d = str(tmp_path / "port")
    tmp_.save_streamable(module, d)
    from kubeflow_tpu.models import llama as jl
    from kubeflow_tpu.parallel.sharding import unbox_params

    jmodel = jl.LlamaModel(jl.llama_tiny())
    like = unbox_params(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"])
    params, report = jmp.stream_restore(d, like)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    ours = dict(module.named_parameters())
    assert report["tensors"] == len(flat) == len(ours)
    for path, leaf in flat:
        name = tmp_.port_name(jax.tree_util.keystr(path))
        assert np.asarray(leaf).tobytes() == \
            ours[name].detach().numpy().tobytes(), name


def test_int8_restore_quantizes_from_the_float32_values(
        reference_checkpoint):
    """quantize=int8 over a float32 checkpoint: every q and scale equals
    quantizing the reference's float32 leaves, as the reference's
    host-side quantization does."""
    from kubeflow_tpu.serving import quant as jq

    d, _ = reference_checkpoint
    pred = tpred.GenerativePredictor(
        "llama", size="tiny", model_config={"dtype": "float32"},
        checkpoint_dir=d, quantize=True, max_batch=1, max_seq=64,
        device="cpu")
    try:
        records = json.load(open(f"{d}/{jmp.MANIFEST}"))["tensors"]
        got = dict(pred.module.named_buffers())
        checked = 0
        for rec in records:
            name = tmp_.port_name(rec["key"])
            if name + ".q" not in got:
                continue
            w = np.load(f"{d}/{rec['file']}")
            axis = w.ndim - 2 if name.endswith(("w_in", "w_out")) else 0
            qt = jq.quantize_array(w, axis)
            q, scale = qt.q, qt.scale
            assert np.array_equal(got[name + ".q"].numpy(), np.asarray(q))
            assert np.array_equal(got[name + ".scale"].numpy(),
                                  np.asarray(scale))
            checked += 1
        assert checked > 0
    finally:
        pred.stop(timeout=10)


# -- park / warm and the pool wiring -------------------------------------------------

@pytest.fixture(scope="module")
def predictor():
    pred = tpred.GenerativePredictor("llama", size="tiny", max_batch=2,
                                     max_seq=64, device="cpu")
    yield pred
    pred.stop(timeout=10)


def test_park_warm_token_identical_and_builds_nothing(predictor):
    p = predictor
    p.warm()
    base = p.generate(PROMPT, max_new_tokens=8)["ids"]
    builds, loaded = _build.BUILDS.get(), dict(_build._loaded)
    nbytes = p.weight_bytes
    assert p.park() == nbytes and p.parked
    assert all(t.is_meta for t in p.module.parameters())
    assert p.weight_bytes == nbytes          # the parked size, reported
    assert p.park() == 0
    assert p.warm() == nbytes and p.warm() == nbytes   # idempotent
    assert p.generate(PROMPT, max_new_tokens=8)["ids"] == base
    assert _build.BUILDS.get() == builds and _build._loaded == loaded


def test_predictor_refuses_the_meta_device():
    """The structure-only build is internal: a caller's ``device="meta"``
    is refused where every device is checked, before anything loads."""
    with pytest.raises(ValueError, match="unsupported device meta"):
        tpred.GenerativePredictor("llama", size="tiny", max_seq=64,
                                  device="meta")


def test_int8_park_warm_is_the_same_model():
    p = tpred.GenerativePredictor("llama", size="tiny", quantize=True,
                                  max_batch=1, max_seq=64, device="cpu")
    try:
        base = p.generate(PROMPT, max_new_tokens=6)["ids"]
        before = {n: t.clone() for n, t in p.module.named_buffers()}
        freed = p.park()
        assert freed == p.weight_bytes and not list(p.module.buffers())
        p.warm()
        after = dict(p.module.named_buffers())
        assert before.keys() == after.keys()
        assert all(torch.equal(before[n], after[n]) for n in before)
        assert p.generate(PROMPT, max_new_tokens=6)["ids"] == base
    finally:
        p.stop(timeout=10)


def test_pool_acquire_warms_evict_parks(predictor):
    p = predictor
    p.warm()
    pool = tmp_.ModelPool(max(1, p.weight_bytes))
    pool.register("llama", lambda: (p, p.warm()), evictor=p.park,
                  nbytes_hint=p.weight_bytes)
    assert pool.acquire("llama") is p
    assert pool.weight_bytes() == p.weight_bytes
    pool.release("llama")
    assert pool.evict_lru() == p.weight_bytes and p.parked
    assert pool.acquire("llama") is p and not p.parked
    pool.release("llama")


def wsgi(app, path, body=None):
    raw = json.dumps(body).encode() if body is not None else b""
    env = {"REQUEST_METHOD": "POST" if body is not None else "GET",
           "PATH_INFO": path, "CONTENT_LENGTH": str(len(raw)),
           "wsgi.input": io.BytesIO(raw)}
    got = {}
    out = b"".join(app(env, lambda s, h: got.update(status=s)))
    return int(got["status"].split()[0]), json.loads(out)


def test_cold_http_requests_coalesce_and_match(predictor):
    p = predictor
    p.warm()
    base = p.generate(PROMPT, max_new_tokens=6)["ids"]
    pool = tpred.wire_model_pool({"llama": p}, max(1, p.weight_bytes))
    app = tpred.PredictorApp({"llama": p}, model_pool=pool)
    pool.acquire("llama")
    pool.release("llama")
    pool.evict("llama")
    status, meta = wsgi(app, "/v1/models/llama")
    assert status == 200 and meta["residency"] == "parked"
    assert p.parked                      # the probe did not warm it
    loads0 = tmp_.COLDSTART_LOADS.get()
    results = [None] * 4

    def call(i):
        results[i] = wsgi(app, "/v1/models/llama:generate",
                          {"ids": PROMPT, "max_new_tokens": 6})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r[0] == 200 and r[1]["ids"] == base for r in results)
    assert tmp_.COLDSTART_LOADS.get() - loads0 == 1
    assert pool.stats()["models"]["llama"]["loads"] == 2
    assert wsgi(app, "/v1/models/llama")[1]["residency"] == "resident"
    assert tmp_.MODEL_REQUEST_SECONDS.count("llama") >= 4
    pool.drain("llama")
    status, body = wsgi(app, "/v1/models/llama:generate",
                        {"ids": PROMPT, "max_new_tokens": 2})
    assert status == 500 and "draining" in body["error"]
    p.warm()
    tmp_.set_model_pool(None)


def test_pressure_relieves_before_prefix_eviction(predictor):
    """An engine whose page pool runs dry asks the residency pool first:
    the idle model's weights become page slots (device rows included),
    the commit goes ahead, and no cached prefix is evicted; a warm hit
    then reads the pages from the grown rows."""
    idle = predictor
    idle.warm()
    # a budget of the one model: its re-warm must reclaim donated slots
    pool = tmp_.ModelPool(idle.weight_bytes)
    pool.register("idle", lambda: (idle, idle.warm()), evictor=idle.park,
                  nbytes_hint=idle.weight_bytes)
    pool.acquire("idle")
    pool.release("idle")
    module = tl.LlamaModel(tl.llama_tiny(dtype="float32"),
                           device="cpu").init_weights(1)
    eng = teng.ContinuousBatcher(module, module.config, max_batch=1,
                                 max_seq=64, prefix_cache_bytes=1 << 20,
                                 page_size=8, kv_pages=4)
    eng.pressure_fn = lambda: pool.relieve(eng.pool)
    evicted = []
    eng.prefix_cache.on_evict = evicted.append
    try:
        prompt = np.random.default_rng(5).integers(1, 500, 40).tolist()
        cold = eng.generate_sync([prompt], max_new_tokens=4)
        donated = idle.weight_bytes // eng.pool.page_nbytes
        assert idle.parked and pool.state_of("idle") == "parked"
        assert pool.stats()["donated_pages"] == donated > 0
        assert eng.pool.stats()["pages"] == 3 + donated
        assert eng.pool.stats()["device_rows"] == 4 + donated
        assert eng.prefix_cache.stats()["pages"] == 5 and evicted == []
        warm = eng.generate_sync([prompt], max_new_tokens=4)
        assert warm == cold
        # the warming model takes back only the free slots: the 5 cached
        # pages stay, 2 slots stay donated
        pool.acquire("idle")
        pool.release("idle")
        assert eng.pool.stats()["in_use"] == 5
        assert eng.pool.stats()["pages"] == 5
        assert pool.stats()["donated_pages"] == 2
        assert eng.pool.stats()["device_rows"] == 4 + donated
    finally:
        eng.shutdown()
        idle.warm()


def test_predictor_refuses_a_checkpoint_without_manifest(tmp_path):
    with pytest.raises(ValueError, match="streamable"):
        tpred.GenerativePredictor("llama", size="tiny", max_seq=64,
                                  checkpoint_dir=str(tmp_path),
                                  device="cpu")


def test_main_wires_checkpoint_parked_and_budget(tmp_path, monkeypatch):
    module = tl.LlamaModel(tl.llama_tiny(), device="cpu").init_weights(0)
    tmp_.save_streamable(module, str(tmp_path))
    seen = {}

    class Stop(Exception):
        pass

    def serve(app, port):
        seen["app"] = app
        raise Stop

    import kubeflow_tpu_torch.serving.httpserve as hs

    monkeypatch.setattr(hs, "serve", serve)
    with pytest.raises(Stop):
        tpred.main(["--model", "llama:parked=true,staging_mb=2",
                    "--checkpoint-dir", str(tmp_path), "--weight-budget-mb",
                    "64", "--device", "cpu", "--max-seq", "64"])
    app = seen["app"]
    pred = app.predictors["llama"]
    try:
        assert pred.parked and app.model_pool.state_of("llama") == "parked"
        assert pred.engine.pressure_fn is not None
        assert tmp_.get_model_pool() is app.model_pool
        assert pred.warm() == pred.weight_bytes
        assert all(torch.equal(a, b) for a, b in zip(
            pred.module.parameters(), module.to(torch.bfloat16).parameters()))
        assert pred.last_restore["max_staged_bytes"] <= 2 << 20
    finally:
        pred.stop(timeout=10)
        tmp_.set_model_pool(None)
