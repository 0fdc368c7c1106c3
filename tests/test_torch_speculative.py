"""Speculative decoding in the PyTorch port (CPU, float32, llama_tiny).

- ``ngram_draft`` and ``SpeculationState`` against the reference's on the
  same sequences and the same observe/skip histories.
- The engine with speculation on gives the streams it gives with
  speculation off: greedy, seeded (top-k/top-p), a ragged co-batch, a
  drafter that is always wrong (every round rejects), one whose second
  token is always wrong (partial accepts), an oracle whose accepted draft
  holds the EOS; with the n-gram drafter, greedy streams equal the JAX
  engine's with ``speculative_tokens=4``; the stats and counters.
- ``DraftModel``: it shares the target's parameters, its incremental
  drafts equal fresh ones, its streams equal speculation-off streams, a
  depth outside the target raises ``ValueError``; the predictor falls
  back to n-gram on that error only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.sharding import unbox_params
from kubeflow_tpu.serving import speculative as jspec
from kubeflow_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serving import draft_model as tdraft
from kubeflow_tpu_torch.serving import engine as teng
from kubeflow_tpu_torch.serving import predictor as tpred
from kubeflow_tpu_torch.serving import speculative as tspec

MAX_SEQ = 128
PROMPT = [5, 8, 13, 21, 3, 9, 2, 17, 11, 4, 6, 12, 7, 1]
# a prompt whose greedy continuation on these weights turns repetitive, so
# n-gram drafts run and land
REPEAT = PROMPT * 3


# --- drafter and per-request state -------------------------------------------

def sequences():
    rng = np.random.default_rng(0)
    seqs = [[], [7], [1, 2], [1, 2, 3, 1, 2], [4, 4, 4, 4, 4],
            PROMPT + PROMPT[:5], [9, 1, 2, 9, 1, 3, 9, 1]]
    seqs += [rng.integers(0, 6, n).tolist() for n in (10, 25, 40, 60)]
    return seqs


@pytest.mark.parametrize("max_n", [1, 3])
@pytest.mark.parametrize("max_tokens", [0, 1, 2, 4, 7])
def test_ngram_draft_matches_reference(max_tokens, max_n):
    for seq in sequences():
        assert (tspec.ngram_draft(seq, max_tokens, max_n)
                == jspec.ngram_draft(seq, max_tokens, max_n)), seq


@pytest.mark.parametrize("max_tokens", [1, 2, 4, 8])
def test_speculation_state_matches_reference(max_tokens):
    ours, ref = (tspec.SpeculationState(max_tokens),
                 jspec.SpeculationState(max_tokens))
    rng = np.random.default_rng(max_tokens)
    for _ in range(60):
        if rng.random() < 0.3:
            w = int(rng.integers(0, 4))
            ours.note_skip(weight=w)
            ref.note_skip(weight=w)
        else:
            proposed = int(rng.integers(0, max_tokens + 1))
            accepted = int(rng.integers(0, proposed + 1))
            ours.observe(proposed, accepted)
            ref.observe(proposed, accepted)
        assert (ours.next_len, ours.accept_ewma, ours._skipped) == (
            ref.next_len, ref.accept_ewma, ref._skipped)
    assert tspec.MIN_DRAFT == jspec.MIN_DRAFT


# --- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    cfg = jl.llama_tiny(dtype="float32")
    model = jl.LlamaModel(cfg)
    params = unbox_params(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return cfg, model, params


@pytest.fixture(scope="module")
def model(jax_side):
    _, _, params = jax_side
    cfg = tl.llama_tiny(dtype="float32")
    m = tl.LlamaModel(cfg, device="cpu")
    m.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return m


def engine(model, **kw):
    return teng.ContinuousBatcher(model, model.config, max_batch=2,
                                  max_seq=MAX_SEQ, **kw)


@pytest.fixture(scope="module")
def plain(model):
    eng = engine(model)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def ngram(model):
    eng = engine(model, speculative_tokens=4)
    yield eng
    eng.shutdown()


def oracle(stream, wrong_at=None):
    """A drafter that proposes ``stream``'s next tokens; with
    ``wrong_at`` the draft's token at that offset is replaced by another."""
    def draft(toks, n):
        d = list(stream[len(toks):len(toks) + n])
        if wrong_at is not None and len(d) > wrong_at:
            d[wrong_at] = d[wrong_at] % 511 + 1
            d = d[:wrong_at + 1]
        return d
    return draft


def spec_counts(eng) -> tuple[int, int, int]:
    st = eng.stats()["speculative"]
    return st["rounds"], st["proposed"], st["accepted"]


@pytest.mark.parametrize("prompt", [PROMPT, REPEAT])
def test_greedy_identical(plain, ngram, prompt):
    want = plain.generate_sync([prompt], max_new_tokens=80)[0]
    before = spec_counts(ngram)
    got = ngram.generate_sync([prompt], max_new_tokens=80)[0]
    after = spec_counts(ngram)
    assert got == want
    assert after[0] > before[0]
    if prompt is REPEAT:
        assert after[2] > before[2]


@pytest.mark.parametrize("drafter", ["ngram", "oracle", "partial",
                                     "wrong"])
def test_seeded_sampling_identical(model, plain, drafter):
    kw = dict(max_new_tokens=30, temperature=1.1, seed=9, top_k=8,
              top_p=0.9)
    want = plain.submit(PROMPT, **kw).result(120)
    fns = {"ngram": None, "oracle": oracle(want),
           "partial": oracle(want, wrong_at=1),
           "wrong": lambda toks, n: [t % 511 + 1 for t in toks[-n:]]}
    eng = engine(model, speculative_tokens=4, draft_fn=fns[drafter])
    try:
        got = eng.submit(PROMPT, **kw).result(120)
        rounds, proposed, accepted = spec_counts(eng)
    finally:
        eng.shutdown()
    assert got == want
    if drafter != "ngram":
        assert rounds > 0
        assert (accepted == proposed) == (drafter == "oracle")


def test_ragged_cobatch_identical(plain, ngram):
    a, b = PROMPT, PROMPT[:6] + [30, 31]
    solo = [plain.generate_sync([p], max_new_tokens=40)[0] for p in (a, b)]
    ra = ngram.submit(a, max_new_tokens=40)
    rb = ngram.submit(b, max_new_tokens=40, temperature=0.9, seed=3)
    sampled = plain.submit(b, max_new_tokens=40, temperature=0.9, seed=3)
    assert [ra.result(120), rb.result(120)] == [solo[0],
                                                sampled.result(120)]


def test_ragged_cobatch_with_oracle_drafts(model, plain):
    """Two rows at different lengths verified in the same rounds: every
    round writes and reads both rows' blocks at their own indices."""
    a, b = PROMPT, PROMPT[:6] + [30, 31]
    solo = {tuple(p): plain.generate_sync([p], max_new_tokens=40)[0]
            for p in (a, b)}

    def both(toks, n):
        for prompt, stream in solo.items():
            if tuple(toks[:len(prompt)]) == prompt:
                return oracle(stream, wrong_at=2)(toks, n)
        return []

    eng = engine(model, speculative_tokens=4, draft_fn=both)
    try:
        got = eng.generate_sync([a, b], max_new_tokens=40)
        rounds, _, accepted = spec_counts(eng)
    finally:
        eng.shutdown()
    assert got == [solo[tuple(a)], solo[tuple(b)]]
    assert rounds > 0 and accepted > 0


def test_all_rejected_path(model, plain):
    eng = engine(model, speculative_tokens=4,
                 draft_fn=lambda toks, n: [t % 511 + 1 for t in toks[-n:]])
    try:
        p0, a0 = teng.SPEC_PROPOSED.get(), teng.SPEC_ACCEPTED.get()
        want = plain.generate_sync([PROMPT], max_new_tokens=30)[0]
        got = eng.generate_sync([PROMPT], max_new_tokens=30)[0]
        assert got == want
        assert teng.SPEC_ACCEPTED.get() == a0    # nothing ever accepted
        assert teng.SPEC_PROPOSED.get() > p0     # but drafts were verified
    finally:
        eng.shutdown()


def test_partial_accept_path(model, plain):
    want = plain.generate_sync([PROMPT], max_new_tokens=30)[0]
    eng = engine(model, speculative_tokens=4,
                 draft_fn=oracle(want, wrong_at=1))
    try:
        got = eng.generate_sync([PROMPT], max_new_tokens=30)[0]
        _, proposed, accepted = spec_counts(eng)
    finally:
        eng.shutdown()
    assert got == want
    assert 0 < accepted < proposed


def test_eos_inside_accepted_draft_stops(model, plain):
    probe = plain.generate_sync([PROMPT], max_new_tokens=12)[0]
    eos = probe[len(PROMPT) + 5]                 # a token 6 steps in
    want = plain.generate_sync([PROMPT], max_new_tokens=40, eos_id=eos)[0]
    full = plain.generate_sync([PROMPT], max_new_tokens=40)[0]
    eng = engine(model, speculative_tokens=4, draft_fn=oracle(full))
    try:
        got = eng.generate_sync([PROMPT], max_new_tokens=40, eos_id=eos)[0]
        rounds, proposed, accepted = spec_counts(eng)
    finally:
        eng.shutdown()
    assert got == want and got[-1] == eos
    # the drafts ran past the EOS and were accepted; the stream stops at it
    assert rounds > 0 and accepted == proposed > len(want) - len(PROMPT) - 1


def test_greedy_identical_to_jax_engine_with_speculation(jax_side, ngram):
    cfg, module, params = jax_side
    rng = np.random.default_rng(4)
    prompts = [PROMPT, rng.integers(1, 512, 23).tolist()]
    jb = JaxBatcher(module, params, cfg, max_batch=2, max_seq=MAX_SEQ,
                    speculative_tokens=4)
    try:
        want = [jb.generate_sync([p], max_new_tokens=60)[0] for p in prompts]
    finally:
        jb.shutdown()
    assert [ngram.generate_sync([p], max_new_tokens=60)[0]
            for p in prompts] == want


def test_spec_metrics_and_stats(ngram):
    from kubeflow_tpu_torch.utils.metrics import REGISTRY

    r0 = teng.SPEC_ROUNDS.get()
    ngram.generate_sync([REPEAT], max_new_tokens=80)
    text = REGISTRY.expose()
    for series in ("serving_spec_tokens_proposed_total",
                   "serving_spec_tokens_accepted_total",
                   "serving_spec_rounds_total",
                   "serving_decode_tokens_total"):
        assert series in text, series
    assert teng.SPEC_ROUNDS.get() > r0
    st = ngram.stats()["speculative"]
    assert st["max_tokens"] == 4 and st["rounds"] > 0
    assert 0.0 <= st["accept_rate"] <= 1.0
    assert st["accept_rate"] == st["accepted"] / st["proposed"]
    assert "speculative" not in engine(ngram.model).stats()


# --- the draft model --------------------------------------------------------

def test_draft_model_shares_the_target_weights(model):
    dm = tdraft.DraftModel(model, num_layers=1)
    assert dm.model.config.num_layers == 1
    assert not dm.model.config.remat
    ours = dict(dm.model.named_parameters())
    target = dict(model.named_parameters())
    assert set(ours) == {n for n in target if not n.startswith("layers.1.")}
    assert all(p is target[n] for n, p in ours.items())
    assert dm.cost_per_token == pytest.approx(0.5 * 1 / 2)
    for depth in (0, 3):
        with pytest.raises(ValueError, match="draft depth"):
            tdraft.DraftModel(model, num_layers=depth)


def test_draft_model_incremental_matches_fresh(model):
    dm = tdraft.DraftModel(model, num_layers=1)
    toks = (PROMPT * 2)[:18]
    first = dm.draft(toks, 4)
    assert len(first) == 4
    ext = toks + first[:2] + [99]                # partial accept + correction
    inc = dm.draft(ext, 4)
    assert inc == tdraft.DraftModel(model, num_layers=1).draft(ext, 4)
    assert list(dm._ctx) == [tuple(ext)]         # the ancestor was moved on
    # a full-key hit drafts again from the stored context
    assert dm.draft(ext, 4) == inc
    assert len(dm._ctx) <= dm.max_entries


def test_draft_model_streams_identical(model, plain):
    dm = tdraft.DraftModel(model, num_layers=1)
    eng = engine(model, speculative_tokens=4, draft_fn=dm)
    try:
        assert eng.draft_cost == pytest.approx(dm.cost_per_token)
        a, b = PROMPT, PROMPT[:9]
        assert (eng.generate_sync([a, b], max_new_tokens=24)
                == plain.generate_sync([a, b], max_new_tokens=24))
        kw = dict(max_new_tokens=16, temperature=1.1, seed=7, top_k=4)
        assert eng.generate_sync([a], **kw) == plain.generate_sync([a], **kw)
        assert eng.generate_sync([a], max_new_tokens=60) == \
            plain.generate_sync([a], max_new_tokens=60)
        rounds, _, _ = spec_counts(eng)
    finally:
        eng.shutdown()
    assert rounds > 0


def test_predictor_builds_the_drafter_and_falls_back_only_on_depth(
        monkeypatch):
    kw = dict(model_config={"dtype": "float32"}, max_seq=64, device="cpu",
              speculative_tokens=3)
    pred = tpred.GenerativePredictor("llama", size="tiny", draft_layers=1,
                                     **kw)
    try:
        assert isinstance(pred.engine.draft_fn, tdraft.DraftModel)
        assert pred.engine.spec_max == 3
    finally:
        pred.stop(timeout=10)
    pred = tpred.GenerativePredictor("llama", size="tiny", draft_layers=9,
                                     **kw)                # deeper than 2
    try:
        assert pred.engine.draft_fn is tspec.ngram_draft
    finally:
        pred.stop(timeout=10)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tdraft, "DraftModel", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpred.GenerativePredictor("llama", size="tiny", draft_layers=1,
                                  **kw)
