"""Speculative decoding drafters: guess tokens cheaply, verify exactly.

The port's own copy of ``kubeflow_tpu/serving/speculative.py`` (plain
Python, no framework).  Speculative decoding (Leviathan et al., ICML
2023) splits a decode round into a cheap DRAFT of the next few tokens and
one model forward that VERIFIES them all: position j's logits are those
sequential decode would compute once drafts 0..j-1 are accepted, so every
accepted token is the token sequential decode would have produced, and
speculation changes only how many tokens one dispatch yields.

The default drafter is n-gram prompt lookup: find the most recent earlier
occurrence of the sequence's current suffix and propose what followed it.
Anything callable as ``draft(tokens, max_tokens) -> list[int]`` plugs into
the same seam (``ContinuousBatcher(draft_fn=...)``; a truncated-target
draft model is ``serving/draft_model.py``).

``SpeculationState`` holds the per-request adaptive draft length: full
acceptance doubles the next draft, any rejection resets it.
"""

from __future__ import annotations

MIN_DRAFT = 2


def ngram_draft(tokens: list[int], max_tokens: int,
                max_n: int = 3) -> list[int]:
    """Prompt-lookup draft: match the longest trailing n-gram
    (``max_n`` down to 1) against its most recent earlier occurrence and
    propose the ``max_tokens`` tokens that followed it.  Returns [] when
    nothing matches (the round falls back to plain single-token decode)."""
    if max_tokens <= 0 or len(tokens) < 2:
        return []
    for n in range(min(max_n, len(tokens) - 1), 0, -1):
        tail = tokens[-n:]
        # scan right-to-left (recency beats frequency for run-like
        # output) but keep looking past matches whose follow is cut off
        # by the sequence end — inside a run the nearest match sits one
        # position back and would cap every draft at a single token,
        # while an earlier occurrence of the same n-gram supplies the
        # full window
        best: list[int] = []
        for start in range(len(tokens) - n - 1, -1, -1):
            if tokens[start:start + n] == tail:
                follow = tokens[start + n:start + n + max_tokens]
                if len(follow) > len(best):
                    best = follow
                if len(best) >= max_tokens:
                    return list(best)
        if best:
            return list(best)
    return []


class SpeculationState:
    """Per-request adaptive speculation state.

    ``next_len`` is the draft-length probe: full acceptance doubles it
    (runs and quotes stretch), any rejection resets it — multiplicative
    probing keeps mispredicting requests near the plain-decode cost
    floor.  ``accept_ewma`` feeds the engine's round-level cost model
    (verify only when the expected accepted tokens beat a scan step);
    it starts optimistic so new requests get probed, and ``note_skip``
    re-opens probing after the engine has ignored the drafter for a
    while — acceptance is a property of the CURRENT stretch of output,
    not of the request."""

    __slots__ = ("max_tokens", "next_len", "accept_ewma", "_skipped")

    # one skipped dispatch re-opens probing: a cold γ=2 probe costs about
    # one scan step and pays for itself in expectation whenever a draft
    # exists, so the cadence stays tight; the engine's round-level cost
    # model (not this counter) is what protects co-batched rounds
    REPROBE_AFTER = 1

    def __init__(self, max_tokens: int):
        self.max_tokens = max(0, int(max_tokens))
        self.next_len = min(MIN_DRAFT, self.max_tokens)
        # optimistic enough that a fresh request gets ONE cheap probe,
        # pessimistic enough that a single rejection ends the experiment
        # (per-request probing is pure overhead on draft-hostile streams)
        self.accept_ewma = 0.6
        self._skipped = 0

    def observe(self, proposed: int, accepted: int) -> None:
        """Feed one verify round's outcome back into the probe."""
        self._skipped = 0
        if proposed <= 0:
            return
        # weight the newest round most: one rejected probe should end the
        # experiment, one landed draft should re-arm it quickly
        self.accept_ewma = (0.4 * self.accept_ewma
                            + 0.6 * (accepted / proposed))
        if accepted >= proposed:
            self.next_len = min(self.max_tokens, max(self.next_len * 2,
                                                     MIN_DRAFT))
        else:
            self.next_len = min(MIN_DRAFT, self.max_tokens)

    def note_skip(self, weight: int = 1) -> None:
        """The engine chose a scan chunk over a verify round; after
        enough skipped ground (``weight`` scales with the chunk's token
        count, so long chunks don't starve the cadence), reset to
        optimism so the stream gets re-probed — acceptance is a property
        of the CURRENT stretch of output, not of the request."""
        self._skipped += max(1, int(weight))
        if self._skipped >= self.REPROBE_AFTER:
            self._skipped = 0
            self.accept_ewma = 0.6
            self.next_len = min(MIN_DRAFT, self.max_tokens)
