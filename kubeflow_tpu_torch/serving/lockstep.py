"""The step record that keeps a serving gang's continuous batchers in
lockstep.

A model sharded over tp and/or ep runs one ``ContinuousBatcher`` per rank
over that rank's shard (``serving/engine.py``), and every forward issues
collectives, so every rank must run the same steps: the same admissions,
the same prefill chunks, the same decode chunk lengths.  Rank 0 (the
leader) alone takes requests; at the top of every scheduling step it
broadcasts a record of every input the step reads that is not a pure
function of state the ranks already share:

- the requests it enqueued since the last record, in order: their ids,
  ``max_new_tokens``, sampling parameters, seed (the one ``_auto_seed``
  assigned included), EOS, tenant and whether a deadline is set;
- the requests it found cancelled or expired (the clock and the cancel
  flags are the leader's alone), by arrival sequence, with the outcome;
- the stop flag;
- a digest of the tokens it emitted in the previous step, which each
  follower compares with its own: a gang must never diverge silently;
- the commands queued since the last record (``COMMANDS``): the
  residency commands ``park`` (with the leader's ticket for it), ``warm``
  and ``reclaim n`` (page slots a warming sibling takes back), and the
  handoff commands of a prefill gang, ``release #seq`` (the leader
  forwarded the request's pages to its decode peer: drop them) and
  ``resume #seq`` (no peer took it: seed a slot here from the pages each
  rank holds).  Every rank applies them at the step boundary, before
  admission, so the weights, the page pool's budget and its references
  change at the same point of every rank's schedule;
- the disaggregated handoffs a decode gang's leader took through
  ``:resume`` since the last record, after the new requests: their
  sampling fields, first token, whether a deadline is set, page count
  and the generator's state.  Their pages follow the record in one
  broadcast each (``exchange_pages``: every KV head, as the body carried
  them), and each rank keeps its own heads in pages it allocates at that
  point, so every rank's pool hands out the same ids.

Everything else (WFQ tags, the prefix cache's matches, pins, evictions
and spills, page ids, chunk lengths, the speculation arbiter, each
request's sampling generator) follows from replaying the same events in
the same order over the same logits.

Encoding: one int64 buffer of ``RECORD_WORDS`` words per step, one
broadcast on the model's record group (``exchange``'s ``group``: one per
gang model, so that two models' engines never interleave their records);
a step whose new prompts overflow it sends the whole record in a second
broadcast of its exact length (the first's header carries it).  Words:
``[length, stop, digest, n_dead, n_new, n_commands, n_handoffs]``, then
``(seq, outcome)`` per dead request, then ``(command, argument)`` per
command, then per new request ``[seq, n_ids, max_new_tokens, temperature
bits, eos (-1: none), seed, top_k, top_p bits, has_deadline, n_tenant]``,
the tenant's UTF-8 bytes one per word and the ids, then per handoff
``[n_ids, max_new_tokens, temperature bits, eos, seed, top_k, top_p
bits, has_deadline, first token, n_pages, n_gen_state]``, the ids and
the generator state's bytes eight to a word.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import time

import torch

from kubeflow_tpu_torch.parallel import distributed as pd

# words of the one broadcast a step costs (32 KiB: a few thousand prompt
# tokens fit before a step needs a second)
RECORD_WORDS = 4096
_HEADER = 7
_PER_REQUEST = 10
_PER_HANDOFF = 11
# a dead request's outcome on the wire
OUTCOMES = ("cancelled", "deadline_exceeded")
# a command on the wire: residency, then a prefill gang's handoffs
COMMANDS = ("park", "warm", "reclaim", "release", "resume")


@dataclasses.dataclass
class NewRequest:
    """What a follower needs to enqueue the leader's request."""

    seq: int
    ids: list[int]
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    seed: int
    top_k: int
    top_p: float
    has_deadline: bool
    tenant: str


@dataclasses.dataclass
class Handoff:
    """What a follower needs to resume the leader's ``:resume`` handoff:
    the body's fields, its page count (the pages follow in
    ``exchange_pages``) and the generator's state (empty: seeded from
    ``seed``, a greedy stream)."""

    ids: list[int]
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    seed: int
    top_k: int
    top_p: float
    has_deadline: bool
    first_token: int
    n_pages: int
    gen_state: bytes = b""


@dataclasses.dataclass
class StepRecord:
    stop: bool = False
    digest: int = 0
    dead: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    new: list[NewRequest] = dataclasses.field(default_factory=list)
    # (command, argument) in the order the leader queued them
    commands: list[tuple[str, int]] = dataclasses.field(
        default_factory=list)
    handoffs: list[Handoff] = dataclasses.field(default_factory=list)


def _f2i(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _i2f(n: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(n)))[0]


def _pack(data: bytes) -> list[int]:
    """``data`` as int64 words, eight bytes to a word (zero-padded)."""
    pad = data + bytes(-len(data) % 8)
    return list(struct.unpack(f"<{len(pad) // 8}q", pad))


def _unpack(words: list[int], n: int) -> bytes:
    return struct.pack(f"<{len(words)}q", *words)[:n]


def encode(rec: StepRecord) -> list[int]:
    words = [0, int(rec.stop), rec.digest, len(rec.dead), len(rec.new),
             len(rec.commands), len(rec.handoffs)]
    for seq, outcome in rec.dead:
        words += [seq, OUTCOMES.index(outcome)]
    for kind, arg in rec.commands:
        words += [COMMANDS.index(kind), arg]
    for r in rec.new:
        tenant = list(r.tenant.encode())
        words += [r.seq, len(r.ids), r.max_new_tokens, _f2i(r.temperature),
                  -1 if r.eos_id is None else r.eos_id, r.seed, r.top_k,
                  _f2i(r.top_p), int(r.has_deadline), len(tenant)]
        words += tenant + list(r.ids)
    for h in rec.handoffs:
        words += [len(h.ids), h.max_new_tokens, _f2i(h.temperature),
                  -1 if h.eos_id is None else h.eos_id, h.seed, h.top_k,
                  _f2i(h.top_p), int(h.has_deadline), h.first_token,
                  h.n_pages, len(h.gen_state)]
        words += list(h.ids) + _pack(h.gen_state)
    words[0] = len(words)
    return words


def decode(words: list[int]) -> StepRecord:
    n_dead, n_new, n_commands, n_handoffs = words[3:_HEADER]
    rec = StepRecord(stop=bool(words[1]), digest=words[2])
    at = _HEADER
    for _ in range(n_dead):
        rec.dead.append((words[at], OUTCOMES[words[at + 1]]))
        at += 2
    for _ in range(n_commands):
        rec.commands.append((COMMANDS[words[at]], words[at + 1]))
        at += 2
    for _ in range(n_new):
        (seq, n_ids, max_new, temp, eos, seed, top_k, top_p, deadline,
         n_tenant) = words[at:at + _PER_REQUEST]
        at += _PER_REQUEST
        tenant = bytes(words[at:at + n_tenant]).decode()
        at += n_tenant
        ids = list(words[at:at + n_ids])
        at += n_ids
        rec.new.append(NewRequest(seq, ids, max_new, _i2f(temp),
                                  None if eos < 0 else eos, seed, top_k,
                                  _i2f(top_p), bool(deadline), tenant))
    for _ in range(n_handoffs):
        (n_ids, max_new, temp, eos, seed, top_k, top_p, deadline, first,
         n_pages, n_gen) = words[at:at + _PER_HANDOFF]
        at += _PER_HANDOFF
        ids = list(words[at:at + n_ids])
        at += n_ids
        n_words = (n_gen + 7) // 8
        gen_state = _unpack(words[at:at + n_words], n_gen)
        at += n_words
        rec.handoffs.append(Handoff(ids, max_new, _i2f(temp),
                                    None if eos < 0 else eos, seed, top_k,
                                    _i2f(top_p), bool(deadline), first,
                                    n_pages, gen_state))
    return rec


def exchange(rec: StepRecord | None, tally: dict | None = None,
             group=None) -> StepRecord:
    """The leader's ``rec`` on every rank of ``group`` (the gang's default
    group when None; followers pass ``rec`` None): one broadcast of
    ``RECORD_WORDS`` words, two when the record is longer.  ``tally``
    counts the broadcasts and their seconds."""
    t0 = time.perf_counter()
    buf = torch.zeros(RECORD_WORDS, dtype=torch.int64)
    words = None
    if rec is not None:
        words = encode(rec)
        head = words[:RECORD_WORDS]
        buf[:len(head)] = torch.tensor(head, dtype=torch.int64)
    got = pd.broadcast_one_to_all(buf, group).tolist()
    calls = 1
    if got[0] > RECORD_WORDS:
        full = torch.zeros(got[0], dtype=torch.int64)
        if words is not None:
            full[:] = torch.tensor(words, dtype=torch.int64)
        got = pd.broadcast_one_to_all(full, group).tolist()
        calls = 2
    if tally is not None:
        tally["calls"] = tally.get("calls", 0) + calls
        tally["records"] = tally.get("records", 0) + 1
        tally["seconds"] = tally.get("seconds", 0.0) + (
            time.perf_counter() - t0)
    return rec if rec is not None else decode(got[:got[0]])


def exchange_pages(buf: torch.Tensor | None, nbytes: int, device,
                   tally: dict | None = None, group=None) -> torch.Tensor:
    """A handoff's pages on every rank of ``group``: the leader's ``buf``
    (every KV head of every page, as ``uint8``; followers pass None) in
    one broadcast of ``nbytes`` on ``device``.  ``tally`` counts the
    broadcasts, their bytes and seconds."""
    t0 = time.perf_counter()
    if buf is None:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    got = pd.broadcast_one_to_all(buf, group)
    if tally is not None:
        tally["page_calls"] = tally.get("page_calls", 0) + 1
        tally["page_bytes"] = tally.get("page_bytes", 0) + int(nbytes)
        tally["page_seconds"] = tally.get("page_seconds", 0.0) + (
            time.perf_counter() - t0)
    return got


def digest(emitted: list[int]) -> int:
    """A 56-bit digest of a step's ``(seq, token)`` emissions."""
    data = torch.tensor(emitted, dtype=torch.int64).numpy().tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=7).digest(),
                          "little")
