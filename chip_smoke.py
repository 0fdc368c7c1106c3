#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --kernel-times  # build, then K1-K3 times only
    python3 chip_smoke.py --phases 12,13  # build, then those phases only
                                          # (9 to 21; no result line)

Phases, numbered as PERF.md cites them, run in the order 1, 2, 3, 7, 11,
9, 12, 13, 14, 15, 4, 5, 10, 16, 6, 17-21, 8 (each phase frees its
models before the next; phases 17-21 run their one-process references
here first, then every 2-rank layout of the five in one gang of 2, then
their checks, with phase 18's and 21's 4-rank layouts in one gang of 4);
any failure exits nonzero and prints no result:

1. Build every CUDA kernel of the port from ``kubeflow_tpu_torch/ops/csrc``
   (one nvcc per source, all at once); fail if ptxas reports a spill or
   serialised wgmma products, or if ``cuobjdump -sass`` finds no wgmma
   product (HGMMA) or no TMA load (UTMALDG) in a bf16 K1, K2 or K3
   instantiation (all three are wgmma kernels fed by TMA).  Hold the
   flash-attention forward kernel (K1) against its plain PyTorch version
   on O and lse, in bfloat16 and float32 (TF32 off for the plain
   version), at every shape the serving run of phase 2 and the training
   runs of phases 4, 5, 17, 18, 19 and 20 give it (18: every layout's rank
   shape, which are 20's too; 19: the ring's diagonal and earlier blocks,
   one process's whole sequence, the pipeline's microbatch), at phase
   21's rank shapes (4 x 512 at 32 heads, 4 x 512 and 2 x 512 at 16) and
   at a GQA, a strided and a
   non-causal D=64 case; hold the backward
   kernels (K2 dQ, K3 dK/dV) against theirs at those training shapes, a
   causal D=128, a ragged Sq = Sk = 200 and a GQA (32 over 8 heads)
   case.  At D = 256 (phases 15 and 16): K1 at every
   shape of both phases, K1, K2 and K3 at phase 16's training shape, a
   causal multi-query 2048-token sequence, a ragged Sq = Sk = 200 case and
   a non-causal GQA case, and K1 at a strided GQA view.
2. Serving main path at full width: a Llama-2-7B ``GenerativePredictor``
   (32 layers, random weights from a seed) served through ``PredictorApp``
   on a local port answers 4 concurrent HTTP ``:generate`` requests
   (prompts of 17, 300, 700 and 1500 tokens; 3 greedy, 1 sampled).  The
   flash kernel's launch count over that run must be 32 x the prefill
   chunks; re-sent requests must reproduce their tokens.  Then, off the
   counted run: every kernel call of a chunked 1500-token prefill is held
   against the plain version on the same inputs, and the prefill logits of
   one prompt through the kernel and through the plain routes must agree.
3. Device time by operator (torch.profiler) of one 512-token prefill
   chunk and one 4-row decode step at 7B.
4. Training main path at full width: ``python -m
   kubeflow_tpu_torch.training``'s ``main`` in-process trains BERT-large
   (24 layers, hidden 1024, 16 heads of 64, sequence 512, bf16, random
   weights from a seed) for ``TRAIN_STEPS`` adamw steps at global batch
   24.  Every step
   must launch K1 48 times (24 layers, each recomputed by remat) and K2
   and K3 24 times each, and every loss must be finite.  Then, off the
   counted run: one train step through the kernels against the same step
   through the plain attention route (same weights and batch) in loss and
   grad_norm, with every K2 and K3 call of it held against its plain
   version on the same inputs; and the step's device time by operator.
5. The same for Llama at Llama-2-7B's width (hidden 4096, 32 heads of 128,
   FFN 11008, vocab 32000, float32 masters, bf16 compute, remat, causal
   attention), ``LLAMA_LAYERS`` of its 32 layers, global batch 16 x 512:
   ``TRAIN_STEPS`` adamw steps, each launching K1 2L times and K2 and K3
   L times; the
   in-step check; the step by operator; the peak memory of the phase.
6. The vision models through the same worker: ``mnist_mlp`` and
   ``cifar_convnet`` for 3 steps, ResNet-50 (224 x 224, batch 128) for 5
   (finite losses, no flash launch), and a ResNet-50 step by operator.
7. Prefix-cached serving at phase 2's 7B width and settings, through a
   ``GenerativePredictor`` with ``prefix_cache_mb`` 2048 (256 pages of 16
   positions) and a cache-less ``ContinuousBatcher`` on the same weights
   as the cold reference.  (a) A 1024-token system prompt with user turns
   of 64, 200 and 700 tokens (a miss, two hits that seed 64 pages and
   prefill only the suffix through K1 at a causal offset of 1024), then
   the first turn again (a full-prefix hit: one prefill dispatch of one
   token).  Before the counted run, as a warm-up at its shapes, the
   first turn on another system prompt runs through the cache-less engine
   and the same traffic on another system prompt through the warm engine,
   every K1 call held against the plain version.  In the
   counted run K1 must launch 32 x the prefill chunks; the seeded scratch
   must equal the cold run's rows and every committed page the scratch
   rows it was cut from, bitwise; the warm first-token logits must agree
   with the cold ones within 1e-1 of max |logit|; at idle no page is
   orphaned and no node pinned; TTFT cold and warm per request.  Then
   the seed and commit copies are timed.  (b) A second engine with a
   256 MB cache (32 pages) and a 64-page host arena: a 384-token prompt
   twice (cold, then a full hit), another 384-token prompt that makes the
   budget sweep spill the first one's 24 pages, then the first again: its
   pages fault back bitwise equal and its stream repeats the earlier
   hit's.
8. Numbers: the card's name and power limit; each kernel's device time at
   its main-path shapes (phases 2, 4, 5, 7 and 9 to 14) beside its
   bound, its plain version's time and a PyTorch call that computes the
   same function (``scaled_dot_product_attention`` forward, and its
   backward for K2 and K3: yardsticks the port never calls); K1, K2 and K3
   beside their bounds at a causal D=128 shape of one 2048-token sequence,
   at phase 17's per-rank shape (12 x 512) with the gang's launches, and
   at each of phase 18's rank shapes with its layout's launches (and
   phase 20's layouts' launches at the same shapes);
   TTFT and decode tokens/s of phases 2, 9 and 12; samples/s of every
   training run; phase 11's tokens/s per mode; phase 12's chunk and
   decode-step device times, dequantization time and weight bytes; phase
   13's per-handoff bytes and times, TTFT and decode tokens/s.  Phases 9,
   12 and 13 run K1 at phase 2's shapes (phase 12's int8 KV traffic at
   phase 7's) and phase 10 at phase 5's, so their rows carry those
   shapes' times with their own launches.  Phase 11's K1 calls are timed per
   distinct (Sq, Sk), except that the drafter's short calls (Sq <= 16) are
   timed at Sk rounded up to a multiple of 256; their bounds are computed
   from each call's own shape.  Phase 14's K1 calls are recorded and timed
   per distinct shape.
9. MoE serving at full width: phase 2's requests through a
   ``GenerativePredictor`` of Llama-2-7B's width and depth with
   ``moe_experts`` 8 on every second layer (16 MoE layers of 8 GELU
   experts, top-2; 15.98 B parameters in bf16, the routers in float32),
   random weights from seed 0, over HTTP.  K1 must launch 32 x the prefill
   chunks; re-sent requests reproduce their tokens; every K1 call of a
   chunked 1500-token prefill is held against the plain version; one
   prompt's prefill logits (dropless, through a cache) through the kernel
   and through the plain routes agree within 1e-1 of max |logit|; every
   router parameter is float32.  Then one MoE block at hidden 512 with 8
   experts, float32, in both modes, on the card against the same block on
   the CPU (1e-5 relative; the capacity drops printed and equal), and the
   device time by operator of one 512-token chunk and one 4-row decode
   step.
10. MoE training: Llama-2-7B's width with ``moe_experts`` 8,
   ``MOE_LAYERS`` of its 32 layers (half of them MoE), float32 masters,
   bf16 compute, remat, batch 16 x 512, adamw at lr 1e-4,
   ``MOE_TRAIN_STEPS`` steps through
   the worker entrypoint:
   finite losses, every step's ``moe_aux`` above 0, K1 2L, K2 and K3 L
   launches per step; the in-step check; the step by operator; peak memory
   under 90% of the card.
11. Speculative decoding: phase 2's 7B model and settings with
   ``speculative_tokens`` 4 and ``draft_layers`` 4 (a ``GenerativePredictor``
   over HTTP: the target's first 4 blocks draft), and on the same weights
   an engine without speculation, an n-gram engine, and an engine whose
   drafter proposes the stream without speculation (the oracle: the
   ceiling of speculation on this traffic).  Each serves phase 2's four
   prompts and a 512-token prompt of one 64-token block repeated 8 times,
   one request at a time, ``SPEC_NEW`` greedy tokens each; then the
   512-token prompt again without speculation, whose stream must repeat.
   Every token a
   verify round keeps must be that round's own choice; one verify forward's
   logits must agree with sequential decode's within 1e-1 of max |logit|;
   each speculative stream must equal the stream without speculation up to
   the first position whose top-1/top-2 margin is below twice that
   measured difference (bf16 GEMMs of other M round differently, so exact
   identity is held on the CPU only); K1 must launch 32 x the prefill
   chunks plus 4 per drafter forward.  Rounds, proposed and accepted
   drafts, accept rate and tokens/s per mode, and the memory the drafter
   adds.
12. int8 serving at full width and depth: phase 2's model, seed, settings
   and requests through a ``GenerativePredictor`` with ``quantize`` (every
   matmul weight int8 with per-channel scales, dequantized to bf16 at use)
   over HTTP: K1 launches 32 x the prefill chunks, re-sent requests
   reproduce their tokens, every K1 call of a chunked 1500-token prefill
   is held against the plain version, and the kernel and plain routes'
   logits agree (phase 2's checks).  The int8 q and scale of layers 0 and
   31 made on the card equal ``quantize_array`` on the CPU over the same
   bf16 weights, bitwise; ``weight_bytes`` against bf16; one prompt's
   prefill-logit drift and top-1 agreement against the bf16 model of the
   same seed; a chunk and a decode step by operator, and every weight's
   dequantization alone.  Then int8 KV pages (``kv_quant``, a 2048 MB
   cache of 16-position pages) on the int8 model take phase 7(a)'s
   traffic: at least 1.9x phase 7's pages, every committed page equal to
   ``quantize_kv`` of the scratch rows it was cut from (bitwise), warm
   hits seeded through the dequantization, K1 32 x the chunks, no orphan
   page or pin at idle; and the perplexity of a continuation over int8
   prompt KV within ``KV_QUANT_PPL_TOL`` of bf16's.
13. Disaggregated prefill/decode at full width.  (a) A ``--role decode``
   predictor as a child process through the CLI (phase 2's model, seed and
   settings, this card) and an in-process ``--role prefill`` predictor
   over HTTP take phase 2's four requests, the 17-, 300- and 700-token
   ones with ``X-KF-Decode-Peer`` naming the child and the 1500-token one
   without (it resumes on the prefill side: its 1.05 GB JSON handoff is
   cut): every stream (the sampled one included) equals phase 2's
   colocated stream, the child counts 3 resumed handoffs and the prefill
   side 1 resumed locally, K1 launches here 32 x the chunks;
   per handed-off
   request the handoff's JSON bytes, serialize, POST and deserialize
   times and TTFT.  Then the child stops and one more request completes
   through the colocated fallback with the colocated stream.  (b) A
   ``DisaggCoordinator`` (1 prefill and 1 decode engine over one int8
   pool) takes the same requests: every stream completes, K1 32 x the
   chunks, no orphan page at idle; the decode role's tokens/s beside phase
   2's.
14. Multi-model, multi-tenant serving at 7B (phase 2's model and
   settings).  (a) The seed-0 model serves phase 2's requests (equal to
   phase 2's streams), is written with ``save_streamable`` (13.2 GB, one
   file per tensor) and restored into a seed-7 predictor through a
   ``STAGING_MB`` pinned window: its streams equal the seed-0 ones; the
   restore's seconds and bytes/s beside the pinned copy rate measured
   here, ``max_staged_bytes`` within the window; the same checkpoint
   restored with ``quantize``, parked and warmed again, with the peak
   device memory of that restore within one layer's bf16 weights of the
   int8 weights.  (c) On one engine (``max_batch`` 4): ``TENANT_STORM`` "storm"
   requests of 300 tokens then one "victim", all queued before admission
   starts, under WFQ shares 1:1 (the victim admitted within the
   reference's starvation bound) and FIFO (admitted last); its TTFT and
   each tenant's usage.  (d) One request with a ``traceparent`` through
   ``PredictorApp``: every span of the trace (predictor, engine request,
   admission wait, one prefill per chunk, decode) under that trace id with
   the reference's parents, and the Chrome trace loads as JSON; phase 2's
   requests at sample rates 0 and 1 give the same tokens, decode tokens/s
   of both.  (b) Two 7B models from the checkpoint behind one
   ``PredictorApp`` under a ``WEIGHT_BUDGET_MB`` budget (room for one):
   "a" with a 2048 MB prefix cache, "b" started parked.  A request to a,
   then 4 concurrent cold one-token requests to the parked b, which make
   one load and 3 coalesced and park a, then b's whole stream over HTTP
   (every switch parks one, whose ``memory_allocated`` falls by its
   ``weight_bytes``, and warms the other; every stream equals phase 2's;
   ``residency`` reads right without warming; the a, b, a round before
   the cold requests was cut to keep the whole run under half its
   limit); with b
   resident and idle and most of a's pages held, a request to a relieves
   b, whose bytes become ``DONATED_PAGES`` page slots, with no prefix
   eviction; b's next load (``ModelPool.acquire``: a, idle, parks)
   reclaims only free donated slots (the one-token request it served
   was cut).  The
   one-token full prefix hit to a holds every K1 call against the
   plain version and its token against phase 2's stream.  (e)
   ``:predict`` for ``mnist_mlp`` over HTTP (logits within 1e-4 of the
   CPU's) and BERT-large on one 128-token row: K1 launches 24, every call
   held against the plain version, the logits against the plain route.
   The checkpoint directory is removed at the end of the phase.

15. Serving at head_dim 256: phase 2's predictor, traffic, settings and
   checks on the reference's Llama block at the widths of Gemma 2B
   (``GEMMA2B_WIDTHS`` as ``model_config`` on size "7b": hidden 2048, 18
   layers, 8 query heads over 1 KV head of 256, FFN 16384, a tied
   256000-row head; 2.51 B parameters, random weights from seed 0; not
   Gemma: SiLU gate, the reference's RMSNorm, no embedding scale).  K1
   (D = 256) must launch 18 x the prefill chunks; re-sent requests
   reproduce their tokens; every K1 call of a chunked 1500-token prefill
   is held against the plain version; the prefill logits through the
   kernel and plain routes agree within 1e-1 of max |logit|.
16. Training at head_dim 256: the same widths at full depth through the
   worker entrypoint, float32 masters, bf16 compute, remat, causal, global
   batch 8 x 512, ``TRAIN_STEPS`` adamw steps, each launching K1 36 times
   and K2 and K3
   18 times; the in-step check (loss and grad_norm against the plain
   route, every K2 and K3 call against its plain version); the step by
   operator; the phase's peak memory under 90% of the card.
17. Data-parallel training as a gang of processes on this card (NCCL
   refuses two ranks on one device, so the ranks meet over gloo, which
   moves every gradient through host memory).  (a) Phase 4's BERT-large
   and adamw at global batch 24 x 512 for ``GANG_BERT["steps"]`` steps,
   from an .npz made from
   seed 0, through the worker entrypoint as one process (this one) and in
   the gang of 2 from ``spawn_local_gang`` (both ranks on cuda:0) that
   also runs phases 18-20's 2-rank layouts: every rank launches
   K1 48 and K2 and K3 24 times a step, the ranks' losses and grad_norms
   are bitwise equal, and each step's loss and grad_norm is held to the
   one process's within ``GANG_TOL``; per rank the launches, peak memory,
   samples/s and the all-reduce seconds, calls and bytes of a step.  (b)
   ResNet-50 at 224 x 224, global batch 128, ``GANG_RESNET["steps"]``
   steps of momentum sgd, the
   same way (its BatchNorms take the gang's global statistics; no flash
   launch).  (c) The Trainer on BERT-large under the reference test's
   membership schedule cut to ``RESIZE_STEPS`` steps (world 2 -> 1 at
   step ``RESIZE_AT``; the reference test's is step 6 of 12), index 0 and
   then index 1 in this process: the ``ResizeCheckpoint`` record (step
   ``RESIZE_AT``, epoch 1, members [0]), every step logged in order and
   one resize for index 0, index 1 resigning at ``RESIZE_AT``; K1-K3 launch 48/24/24 a step on
   both sides of the barrier.
18. Sharded training as gangs of processes on this card (gloo, as in 17).
   Llama at Llama-2-7B's width (phase 5's model, float32 masters, bf16
   compute, remat) cut to ``MESH_LAYERS`` layers, global batch 8 x 512,
   ``MESH_STEPS`` adamw steps from an .npz made from seed 0, through the
   worker entrypoint on four layouts: one process (this one), ``fsdp=2``
   and ``tp=2`` (one after the other in the gang of 2) and ``fsdp=2,
   tp=2`` (a gang of 4).  Each rank runs
   K1, K2 and K3 on its own rows and heads (fsdp: 4 of the 8 rows; tp:
   16 of the 32 heads; each layout's rank shape is held against the
   plain versions, forward and backward, in phase 1) and must launch
   them 2L, L and L times a step; the ranks' losses and grad_norms are
   bitwise equal, and each layout's are held to one process's within
   ``GANG_TOL``; per rank the peak memory of the steps and of the whole
   run (the checkpoint's save included), samples/s of step 2, and step
   2's all-reduce, all-gather and reduce-scatter
   seconds, calls and bytes.  The last layout writes a checkpoint at its
   end, which this process restores: every parameter bitwise the gang's
   gathered one.
19. Sequence and pipeline parallelism in the gang of 2 processes on this
   card (gloo, as in 17; its point-to-point takes no CUDA tensor, so each
   neighbour exchange goes through pinned host memory).  (a) Ring
   attention at the sp = 2 run's chunk (2 x 2048 tokens, 32 heads of 128,
   causal, bf16), forward and backward (after (b), whose first step paid
   the gang's first launches and exchanges), against
   ``ring_attention_reference`` on the same rank: O per element within 2^-7 (|O| + P|V|), dQ, dK and dV
   within 2e-2 of max |ref|; rank r launches K1, K2 and K3 r + 1 times
   (its diagonal block and r earlier ones; a later block launches
   nothing).  (b) Phase 18's Llama at 7B width, ``SP_LAYERS`` layers, a
   batch of 2 x 4096 tokens (Llama-2's max_seq_len), ``SP_STEPS`` adamw
   steps from an .npz made from seed 0 through the worker entrypoint as
   one process (this one) and with ``sp=2`` (each rank 2 x 2048 tokens):
   launches per step and rank as in (a) per layer and pass, ranks bitwise
   equal, held to one process within ``GANG_TOL``; samples/s and tokens/s
   of each, per rank the exchange's and the all-reduce's seconds, calls
   and bytes of step 2 and the peak memory.  (c) pp = 2 over 4 blocks at
   that width (2 per stage), x [8, 512, 4096] bf16 in 4 microbatches
   (``pipeline_forward``; 5 ticks, bubble share 1/5), forward and
   backward against the 4 blocks in sequence on each rank: output within
   1e-1 of max |out|, stage gradients within 2e-2 of max |ref|, K1, K2 and
   K3 8 times per rank.
20. MoE training under a data group, expert, tensor and sequence
   parallelism in the gang of 2 (gloo, as in 17).  Phase 10's MoE Llama
   at Llama-2-7B's width (8 GELU experts, top-2, Mixtral's routing) cut
   to ``MOE_EP_LAYERS`` layers (layer 0 MoE, layer 1 dense), float32
   masters, bf16 compute, remat, global batch 8 x 512, ``MOE_EP_STEPS``
   steps from an .npz made from seed 0: one process (this one, through
   ``build_train_step``) with adamw and with lamb (``MOE_LAMB``), dp = 2
   (the worker entrypoint: each rank 4 rows; the MoE block gathers the
   ranks' expert counts, so capacity, positions and aux are the global
   batch's), and through ``build_train_step`` on ``make_mesh(dp=1, ...)``
   (each rank all 8 rows): ep = 2 (4 of the 8 experts a rank), tp = 2
   (16 heads and half of every expert's columns a rank; the chosen
   outputs summed over tp), sp = 2 (256 tokens of every row a rank, the
   ring through K1-K3 per K/V block, the routing ordered by (row, chunk))
   with adamw, and tp = 2 with lamb (the trust ratios of the whole
   tensors).  Per layout and rank: K1 2L and K2, K3 L launches a step
   (at sp = 2 once per visible ring block: rank r r + 1 of them), every
   MoE layer's dropped (token, choice) count equal to one process's at
   step 1 (the same weights; later steps' are printed beside one
   process's), the ranks' losses and grad_norms bitwise equal and held to
   one process's (with the same optimizer) within ``GANG_TOL``, samples/s
   of step 2, step 2's all-reduce and all-gather seconds, calls and
   bytes, peak memory; ep's and tp's expert blocks after the last step
   against one process's rows or columns of the same experts (ep:
   ``MOE_EP_EXPERT_TOL`` on the norm of the difference over the weights';
   tp: ``MOE_TP_EXPERT_TOL`` over one process's update's, since tp's
   rounding routes near-ties otherwise).  Under tp and sp, step 1's
   dropped counts are held within the (token, choice) assignments routed
   otherwise than one process routed them (counted).

21. Multi-host serving: phase 2's Llama-2-7B (bf16, seed 0) at
   ``MH_SHALLOW_LAYERS`` layers (phase 22 serves tp at full depth),
   ``max_seq`` 2048, through ``MultiHostPredictor`` as one process (this
   one), tp = 2 in the gang of 2 and dp = 2 x tp = 2 in the gang of 4
   (phase 18's), and with int8 weights as one process and at tp = 2.  4
   prompts of 17, 128, 300 and 500 tokens (one bucket of 512), ``MH_NEW``
   greedy tokens each, held by rank 0 and broadcast
   (``broadcast_prompts``).  Each layout's ranks return identical tokens;
   each prefills through K1 once per layer at its rank shape ([4, 512] at
   16 heads under tp = 2, [2, 512] under dp x tp); its first-token
   logits, gathered over the vocabulary, are within
   ``MH_SHALLOW_REL_TOL`` of max |logit| of one process's (the int8
   layout's every token one process's); each row's first token is one
   process's wherever one process's top-2 margin exceeds twice the logit
   gap (printed, with each stream's agreeing length).  One process also
   prefills once more in bf16 with each row-parallel product cut as tp =
   2 cuts it, two bf16 halves summed in bf16 (``tp2_partial_sums``):
   every bf16 tp layout's logits must equal that bitwise; each rank's
   memory after loading is at most 0.55 of one process's weight bytes;
   the int8 ``q`` and ``scale`` blocks are bitwise the local blocks of
   one process's whole-tensor quantization (SHA-256).  Per layout and
   rank: load and prefill seconds, decode tokens/s, one decode step's
   all-reduce and all-gather seconds, calls and bytes, peak memory.

22. The predictor's ``tp=`` and ``ep=``: (a) phase 2's Llama-2-7B (32
   layers) behind ``GenerativePredictor(tp=2, max_seq=2048,
   prefill_chunk=512, max_batch=4, prefix_cache_mb=2048)`` in the gang
   of 2: rank 0 serves HTTP and leads the continuous batcher, the
   follower replays its step records.  Phase 2's four prompts (greedy, 16
   tokens each, admitted in one step), then the 700-token one again (a
   prefix hit: K1 at causal offset ``sk - sq``).  The ranks' streams are
   identical, the warm stream equals the cold one, the first-token
   logits are within ``P22_REL_TOL`` of phase 2's one-process engine's
   (first tokens margin-gated), K1 runs once per layer and chunk at 16
   heads, the view and pool hold 16 KV heads, and a rank's weights are at
   most 0.55 of one process's.  The same at ``MH_SHALLOW_LAYERS`` layers
   is held bitwise (logits and every token) to one process whose every
   product runs at a tp = 2 rank's shapes (``tp2_partial_sums(columns=
   True)``).  (b) phase 9's MoE at 7B width and ``MH_SHALLOW_LAYERS``
   layers, four prompts of ``P22_MOE_LENS`` tokens: ep = 2 in the gang of
   2, held bitwise to one process; tp = 2 x ep = 2 in the gang of 4,
   within ``P22_REL_TOL``.  Per layout and rank: load seconds, TTFT per
   request, decode tokens/s, the step records' broadcasts and
   milliseconds per step, one decode step's collectives, weight and KV
   bytes.  (c) Residency: a dense tp = 2 and a MoE ep = 2 model under one
   weight budget (park, warm, page pressure, reclaim on both ranks).  (d)
   Disaggregation in the gang of 2: the 2-layer model as a prefill-role
   and a decode-role tp = 2 predictor; phase 2's four prompts prefilled
   (K1 at 16 heads) and handed across (the prefill gang gathers each
   handoff's heads to rank 0 inside the step, the body crosses as JSON to
   the decode gang's ``:resume``, whose rank 0 broadcasts the pages in
   its next step record), then one prompt with no decode peer, resumed on
   the prefill gang: every stream equals the 2-layer tp = 2 layout's, each
   body's pages are bitwise one process's under ``tp2_partial_sums``,
   both ranks' pools equal and empty at the end; per request the gather's
   ms and bytes, ``serialize_handoff`` ms and the body's bytes, the
   POST's wall ms, the decode leader's deserialize ms and page broadcast
   ms and bytes, the step records.  And the MoE in int8 at ep = 2 through
   one request: its stream and first-token logits bitwise one process's
   int8 MoE, each rank's int8 expert blocks bitwise its slice.

The line before the last is the ``kernels`` JSON object (``name<256>``:
the D = 256 instantiations on phases 15 and 16); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 and
# fp32 rates in FLOP/s (the f32 kernels run on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# what each kernel moves and computes: tensors shaped like Q [B, Sq, H, D]
# and like K [B, Sk, Hkv, D] read or written once, float32 rows [B, H, Sq]
# (lse, delta), and products of 2 D FLOPs per visible (query, key) pair
KERNEL_WORK = {  # name: (q-like, k-like, rows, products)
    "flash_fwd": (2, 2, 1, 2),        # Q, O | K, V | lse | QK^T, PV
    "flash_bwd_dq": (3, 2, 2, 3),     # Q, dO, dQ | K, V | lse, delta
    "flash_bwd_dkv": (2, 4, 2, 4),    # Q, dO | K, V, dK, dV | lse, delta
}
# the bf16 K1, K2 and K3 instantiations, which must keep their wgmma
# products and TMA loads in the built code
WGMMA_KERNELS = tuple(f"{k}<{d}>" for k in (
    "flash_fwd_bf16_wgmma", "flash_bwd_dq_bf16_wgmma",
    "flash_bwd_dkv_bf16_wgmma") for d in (64, 128, 256))

# phase 2's requests: prompt lengths and the engine settings
PROMPT_LENS = (17, 300, 700, 1500)
MAX_SEQ, PREFILL_CHUNK, NEW_TOKENS = 2048, 512, 16
EXTRA_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal)
    ("gqa_ragged_strided", 2, 200, 700, 32, 8, 128, True),
    ("noncausal_d64", 2, 100, 300, 4, 4, 64, False),
    ("gqa_ragged_d256_strided", 2, 200, 700, 8, 2, 256, True),
]
# phase 7: prefix-cached serving at phase 2's settings.  (a) a system
# prompt shared by three user turns, then the first turn again; (b) a
# 32-page cache over a 64-page host arena and two prompts of 24 pages
PC_SYSTEM, PC_SUFFIXES = 1024, (64, 200, 700)
PC_CACHE_MB, PC_PAGE = 2048, 16
PC_TIER_CACHE_MB, PC_TIER_HOST_PAGES, PC_TIER_PROMPT = 256, 64, 384
# warm first-token logits against the cold ones, relative to max |logit|:
# cold and warm run their GEMMs at other M (a 256-token suffix bucket
# against 512-token chunks), and 32 random-weight bf16 layers amplify the
# rounding (LOGITS_REL_TOL's reasoning)
WARM_LOGITS_REL_TOL = 1e-1
# phase 4: BERT-large pretraining through the port's worker entrypoint.
# Phases 4, 5 and 16 cut from 10 steps to 3 to keep the whole run under
# half its limit when phase 20 grew (their samples/s over steps 2-3)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 24, 512
TRAIN_CONFIG = {"model": "bert", "model_config": {"size": "large"},
                "global_batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                "log_every": 1, "seed": 0,
                "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
TRAIN_SHAPE = ("bert_large_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16,
               64, False)
# per step: K1 runs twice per layer (forward, and remat's recompute in the
# backward), K2 and K3 once per layer
TRAIN_LAUNCHES = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
# phase 17: the same model as a gang of processes on this card, each rank
# holding its rows of the global batch
GANG_RANKS = 2
GANG_SHAPE = ("bert_large_gang_rank", TRAIN_BATCH // GANG_RANKS, TRAIN_SEQ,
              TRAIN_SEQ, 16, 16, 64, False)
# phase 5: Llama training at Llama-2-7B's width (hidden 4096, 32 heads of
# 128, FFN 11008, vocab 32000), float32 masters, bf16 compute, remat,
# sequence 512 as the Trainer makes Llama batches; depth cut from 32 to 20
# layers so masters, gradients and adamw moments (16 bytes per parameter,
# 66.9 GB) fit one 80 GB card
LLAMA_LAYERS, LLAMA_BATCH, LLAMA_SEQ = 20, 16, 512
LLAMA_CONFIG = {"model": "llama",
                "model_config": {"size": "7b", "num_layers": LLAMA_LAYERS},
                "global_batch": LLAMA_BATCH, "steps": TRAIN_STEPS,
                "log_every": 1, "seed": 0,
                "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
LLAMA_SHAPE = ("llama7b_train", LLAMA_BATCH, LLAMA_SEQ, LLAMA_SEQ, 32, 32,
               128, True)
LLAMA_LAUNCHES = {"flash_fwd": 2 * LLAMA_LAYERS,
                  "flash_bwd_dq": LLAMA_LAYERS, "flash_bwd_dkv": LLAMA_LAYERS}
# phase 6: the vision models through the same Trainer (no flash kernel):
# (model, steps), global batch 128; ResNet-50 at 224 x 224 (cut from 10
# steps to 5 with phase 4)
VISION_RUNS = (("mnist_mlp", 3), ("cifar_convnet", 3), ("resnet50", 5))
VISION_BATCH = 128
# phase 9: MoE serving at phase 2's settings; the MoE block check's size
MOE_EXPERTS = 8
MOE_BLOCK = {"hidden_size": 512, "ffn_size": 1376, "tokens": (2, 256)}
# phase 10: MoE training at Llama-2-7B's width, depth cut from 32 to 8
# layers (4 MoE): 4.09 B parameters, 65.5 GB of masters, gradients and
# adamw moments, and the experts' float32 copies and [E, C, f] buffers
# under remat on top (6 layers peaked at 55.57 GB, 65.4% of the card, on
# an H100 80GB HBM3); steps cut from 5 to 3 (~1.67 s each) with phase 4's
MOE_LAYERS, MOE_TRAIN_STEPS = 8, 3
MOE_TRAIN_CONFIG = {"model": "llama",
                    "model_config": {"size": "7b", "num_layers": MOE_LAYERS,
                                     "moe_experts": MOE_EXPERTS},
                    "global_batch": LLAMA_BATCH, "steps": MOE_TRAIN_STEPS,
                    "log_every": 1, "seed": 0,
                    "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
MOE_LAUNCHES = {"flash_fwd": 2 * MOE_LAYERS, "flash_bwd_dq": MOE_LAYERS,
                "flash_bwd_dkv": MOE_LAYERS}
# phase 12: int8 serving.  The layers whose q/scale made on the card are
# held bitwise against quantize_array on the CPU; the perplexity of a
# continuation over int8 prompt KV against bf16 prompt KV (head and tail
# lengths): within KV_QUANT_PPL_TOL, the reference's bound (its
# test_kv_quant_perplexity_neutral), since symmetric int8 with one scale
# per (page, head) moves each KV value by at most half a step (1/254 of
# the head's amax), which random-weight logits barely feel; a wrong scale
# axis or a stale tail moves KV by O(1)
INT8_CHECK_LAYERS = (0, 31)
PPL_HEAD, PPL_TAIL = 1024, 64
KV_QUANT_PPL_TOL = 0.02
# phase 13: the decode child's start-up budget (a fresh interpreter,
# CUDA, the 7B init) and its HTTP port's polling; the prompts whose
# handoffs cross to the child in (a): the 17-, 300- and 700-token ones (the
# 700-token handoff resumes a prompt of two prefill chunks); the
# 1500-token one resumes locally (its handoff is 1.05 GB of JSON; cut to
# keep the whole run under half its limit when phase 21 joined)
CHILD_START_S = 240
DISAGG_HANDED_OFF = PROMPT_LENS[:3]
# phase 14: multi-model, multi-tenant serving at 7B.  Phase 2's model in
# bf16 is 13,214,687,232 B of weights (6,744,121,344 B in int8): one model
# fits WEIGHT_BUDGET_MB, two do not, and an eviction donates that many
# bytes in 8 MiB pages of 16 positions
STAGING_MB, WEIGHT_BUDGET_MB = 64, 20000
CKPT_BYTES, INT8_BYTES = 13_214_687_232, 6_744_121_344
DONATED_PAGES = CKPT_BYTES // (8 << 20)       # 1575
# phase 14(c)'s requests, each TENANT_NEW tokens long: cut from 16 to 8 to
# keep the whole run under half its limit (its two host-bound rounds took
# 18.4 s of a 757.6 s run on an H100 80GB HBM3 call); admission order,
# the point of the cell, does not depend on it.  The storm cut from 16
# requests to 8 when phase 20 grew: the victim still queues behind twice
# the engine's 4 slots (its FIFO position 8, its WFQ bound 2)
TENANT_STORM, TENANT_PROMPT, TENANT_NEW = 8, 300, 8
BERT_ROW = 128
# phase 11: speculation at phase 2's settings.  Depth cut from 64 new
# tokens per request to 32 when phase 14 joined: its 8 host-bound runs of
# 5 requests took ~267 s of a 694 s run at 64 (an H100 80GB HBM3 call);
# to 16 when phase 18 joined: at 32 they took ~101-103 s of whole runs of
# 629.0, 687.7 and 647.2 s (H100 80GB HBM3 calls).  Each mode still meets
# its verify rounds: a lone stream drafts once per decode chunk
SPEC_TOKENS, DRAFT_LAYERS, SPEC_NEW = 4, 4, 16
SPEC_BLOCK, SPEC_REPEATS = 64, 8
# off first: the oracle drafts the off streams (speculation's ceiling)
SPEC_MODES = ("off", "ngram", "draft", "oracle")
# verify logits against sequential decode logits, relative to max |logit|
# (LOGITS_REL_TOL's reasoning: other GEMM shapes, 32 bf16 layers)
VERIFY_REL_TOL = 1e-1
# K1 at phase 11's own shapes (the drafter's 1-token steps and 8-token
# extensions, a whole 512-token prompt), held in phase 1
SPEC_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal)
    ("7b_spec_draft_step_1x301", 1, 1, 301, 32, 32, 128, True),
    ("7b_spec_draft_extend_8x1509", 1, 8, 1509, 32, 32, 128, True),
    ("7b_spec_prefill_512x512", 1, 512, 512, 32, 32, 128, True),
]
CAUSAL_DQ_SHAPE = (1, 2048, 2048, 32, 32, 128, True)  # B, Sq, Sk, H, Hkv, D
# phases 15 and 16: the reference's Llama block (SiLU gate, its RMSNorm, no
# embedding scale: not Gemma) at the widths of Gemma 2B (arXiv:2403.08295,
# Table 1; google/gemma-2b's published config): hidden 2048, 18 layers, 8
# query heads over 1 KV head of 256 (multi-query), FFN 16384, a tied
# 256000-row head, RMSNorm eps 1e-6; 2.51 B parameters, taken through
# model_config on size "7b" as a user passes it.  Serving at phase 2's
# settings and traffic; training at full width and depth, float32 masters,
# bf16 compute, remat, global batch 8 x 512 (40 GB of masters, gradients
# and adamw moments and ~10 GB of logits and their gradient)
GEMMA2B_WIDTHS = {"vocab_size": 256000, "hidden_size": 2048,
                  "num_layers": 18, "num_heads": 8, "num_kv_heads": 1,
                  "intermediate_size": 16384, "rms_eps": 1e-6}
GEMMA_HEADS = (8, 1, 256)                      # H, Hkv, D
GEMMA_LAYERS, GEMMA_BATCH = 18, 8
GEMMA_LABEL = "llama at Gemma-2B widths"
GEMMA_CONFIG = {"model": "llama",
                "model_config": {"size": "7b", **GEMMA2B_WIDTHS},
                "global_batch": GEMMA_BATCH, "steps": TRAIN_STEPS,
                "log_every": 1, "seed": 0,
                "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
GEMMA_SHAPE = ("gemma2b_train", GEMMA_BATCH, LLAMA_SEQ, LLAMA_SEQ,
               *GEMMA_HEADS, True)
GEMMA_LAUNCHES = {"flash_fwd": 2 * GEMMA_LAYERS,
                  "flash_bwd_dq": GEMMA_LAYERS, "flash_bwd_dkv": GEMMA_LAYERS}
# the D = 256 kernels off the two paths: one causal multi-query sequence of
# 2048, ragged Sq = Sk = 200, non-causal GQA, and (K1) a strided view
D256_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal)
    ("mqa_causal_2048_d256", 1, 2048, 2048, 8, 1, 256, True),
    ("ragged_200_d256", 2, 200, 200, 8, 1, 256, True),
    ("noncausal_gqa_d256", 2, 100, 300, 4, 2, 256, False),
]
# phase 18's layouts, (label, fsdp, tp), the first one process, of a
# Llama-7B-wide global batch of 8 rows; each rank runs K1-K3 at its layout's
# shape: the data ranks' rows, the tp group's heads
MESH_BATCH = 8
MESH_LAYOUTS = (("one process", 1, 1), ("fsdp=2", 2, 1), ("tp=2", 1, 2),
                ("fsdp=2, tp=2", 2, 2))


def mesh_shape(fsdp: int, tp: int) -> tuple:
    return (f"llama7b_mesh_rank_fsdp{fsdp}_tp{tp}", MESH_BATCH // fsdp,
            LLAMA_SEQ, LLAMA_SEQ, 32 // tp, 32 // tp, 128, True)


MESH_SHAPES = [mesh_shape(fsdp, tp) for _, fsdp, tp in MESH_LAYOUTS]
# phase 19: (b) Llama at Llama-2-7B's width, SP_LAYERS layers, a batch of
# SP_BATCH x SP_SEQ tokens (Llama-2's max_seq_len) as one process and on
# sp = 2 (each rank a chunk of SP_SEQ / 2); (a) the ring's check at the
# rank's chunk; (c) pp = 2 over PP_BLOCKS blocks at that width, x
# [PP_BATCH, PP_SEQ, 4096] in PP_MICRO microbatches
SP_RANKS, SP_LAYERS, SP_STEPS, SP_BATCH, SP_SEQ = 2, 2, 2, 2, 4096
PP_BLOCKS, PP_BATCH, PP_SEQ, PP_MICRO = 4, 8, 512, 4
# each rank's ring blocks: the diagonal one (causal at offset 0) and, on
# rank 1, the earlier one (fully visible); one process holds the sequence
SP_BLOCK_SHAPES = [
    ("llama7b_sp_block_diagonal", SP_BATCH, SP_SEQ // SP_RANKS,
     SP_SEQ // SP_RANKS, 32, 32, 128, True),
    ("llama7b_sp_block_earlier", SP_BATCH, SP_SEQ // SP_RANKS,
     SP_SEQ // SP_RANKS, 32, 32, 128, False)]
SP_ONE_SHAPE = ("llama7b_sp_one_process", SP_BATCH, SP_SEQ, SP_SEQ, 32, 32,
                128, True)
PP_SHAPE = ("llama7b_pp_microbatch", PP_BATCH // PP_MICRO, PP_SEQ, PP_SEQ,
            32, 32, 128, True)
SP_SHAPES = [*SP_BLOCK_SHAPES, SP_ONE_SHAPE, PP_SHAPE]
BWD_SHAPES = [TRAIN_SHAPE, GANG_SHAPE, LLAMA_SHAPE, *MESH_SHAPES, *SP_SHAPES,
              # (name, B, Sq, Sk, ...)
              ("causal_d128", 2, 384, 384, 8, 8, 128, True),
              ("ragged_200_causal", 2, 200, 200, 16, 16, 64, True),
              ("gqa_32_over_8", 2, 256, 256, 32, 8, 128, True),
              GEMMA_SHAPE, *D256_SHAPES]
# max |kernel - plain| / max |plain| per gradient (dQ, dK, dV).  f32:
# summation order only.  bf16: the kernels round P and dS to bf16 for
# their products (2^-8 relative per weight) and the gradients to bf16.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# one train step through the kernels against the same step through the
# plain attention route, relative.  Both round the softmax weights to bf16
# before PV; the routes differ in where the backward rounds (the kernels
# round dS, the plain route's autograd rounds the weights' gradient), and
# 24 random-weight bf16 layers amplify such rounding-level differences
# (measured on an H100: 2.5e-5 on the loss, 3.7e-4 on grad_norm).
STEP_TOL = {"loss": 1e-3, "grad_norm": 5e-3}
# |kernel - plain| <= atol + rtol * |plain| per element of O, and <= lse
# absolutely.  f32: summation order only.  bf16: the kernel rounds P to
# bf16 for the PV product (2^-8 relative per weight) and both round O to
# bf16, so a rounding can flip by one ulp (2^-7 relative: 0.0156 at |O| 2)
TOL = {torch.float32: {"atol": 1e-5, "rtol": 1e-5, "lse": 1e-4},
       torch.bfloat16: {"atol": 1e-2, "rtol": 1e-2, "lse": 1e-3}}
# each bf16 kernel call inside the 7B prefill, against the plain version on
# the same activations.  Per element of O: rounding P to bf16 (relative
# 2^-8) moves O by at most 2^-8 sum_j p_j |v_j|, and the two bf16 roundings
# of O differ by at most one ulp (<= 2^-7 |O|); the check allows
# 2^-7 (|O| + sum_j p_j |v_j|), twice the P term, and reports the largest
# |dO| / allowance ("o", <= 1).  lse: |dlse| relative to max(1, |lse|)
# (float32 sums in another order).
IN_MODEL_TOL = {"o": 1.0, "lse": 1e-4}
# prefill logits of 32 bf16 layers, relative to max |logit|.  Against the
# kernel's plain version (same math, other summation order) each layer
# differs only where a bf16 rounding of O flips; against the plain masked
# route also by its rounding of every softmax weight to bf16 before PV.
# A random-weight 32-layer stack amplifies such rounding-level differences
# to a few percent of max |logit| (4.5e-2 for both, measured on an H100);
# a wrong kernel moves the logits by O(1).  The kernel itself is held
# tightly, call by call, by the in-model check above.
LOGITS_REL_TOL = {"kernel_plain_version": 1e-1, "plain_route": 1e-1}


def log(msg: str) -> None:
    """``msg`` after the seconds since the run started (the phases' share
    of the time limit)."""
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def check(ok, what) -> None:
    """Fail the run (a raise, unlike ``assert``, survives ``python -O``)."""
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def chunk_shapes(n: int, pos: int = 0) -> list[tuple[int, int]]:
    """(Sq, Sk) of each flash call per layer of the engine's prefill of an
    ``n``-token prompt from position ``pos`` (a reused prefix): chunks of
    ``PREFILL_CHUNK``, each padded to a prefill bucket that stays inside
    ``MAX_SEQ``."""
    from kubeflow_tpu_torch.serving.engine import PREFILL_BUCKETS

    shapes = []
    while pos < n:
        take = min(n - pos, PREFILL_CHUNK)
        cb = next((b for b in PREFILL_BUCKETS
                   if take <= b <= MAX_SEQ - pos), take)
        shapes.append((cb, pos + cb))
        pos += take
    return shapes


def prefill_shapes() -> list[tuple[int, int]]:
    """(Sq, Sk) of every flash call per layer in phase 2."""
    return [s for n in PROMPT_LENS for s in chunk_shapes(n)]


def prefix_plan() -> list[tuple[int, int]]:
    """(prompt length, reused prefix) of phase 7(a)'s counted requests: a
    miss, two hits on the system prompt, and a full-prefix hit, which
    reuses all but the last token."""
    lens = [PC_SYSTEM + n for n in PC_SUFFIXES]
    return [(lens[0], 0), (lens[1], PC_SYSTEM), (lens[2], PC_SYSTEM),
            (lens[0], lens[0] - 1)]


def prefix_shapes() -> list[tuple[int, int]]:
    """(Sq, Sk) of every flash call per layer in phase 7(a)'s counted run:
    a warm suffix runs K1 causally at offset Sk - Sq >= the reused
    prefix."""
    return [s for n, pos in prefix_plan() for s in chunk_shapes(n, pos)]


def path_shapes(shapes: list[tuple[int, int]], label: str,
                model: str = "7b", heads: tuple = (32, 32, 128)) -> list[tuple]:
    """Distinct prefill shapes of a serving path (``heads``: H, Hkv, D)
    with their launch counts per layer: (name, B, Sq, Sk, H, Hkv, D,
    causal, count)."""
    counts: dict[tuple[int, int], int] = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    return [(f"{model}_{label}_{sq}x{sk}", 1, sq, sk, *heads, True, c)
            for (sq, sk), c in sorted(counts.items())]


def main_path_shapes() -> list[tuple]:
    """Phase 2's distinct prefill shapes (``path_shapes``)."""
    return path_shapes(prefill_shapes(), "prefill")


def prefix_path_shapes() -> list[tuple]:
    """Phase 7(a)'s distinct prefill shapes (``path_shapes``)."""
    return path_shapes(prefix_shapes(), "prefix")


def gemma_path_shapes() -> list[tuple]:
    """Phase 15's distinct prefill shapes: phase 2's chunks at Gemma-2B's
    heads (``path_shapes``)."""
    return path_shapes(prefill_shapes(), "prefill", "gemma2b", GEMMA_HEADS)


def make_qkv(b, sq, sk, h, hkv, d, dtype, seed, strided=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:  # q as a [B, H, S, D] tensor viewed [B, S, H, D]
        q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
        q = q.transpose(1, 2)
    else:
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def check_backward(fa, name, b, sq, sk, h, hkv, d, causal, dtype,
                   seed) -> tuple[float, float]:
    """Hold K2 and K3 against their plain versions on the same q, k, v,
    dO, lse and delta; returns the max abs errors (dQ, dK/dV)."""
    q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    want = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal),
            *fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                        causal=causal))
    torch.cuda.synchronize()
    errs, rels = [], []
    for x, ref in zip(got, want):
        diff = (x.float() - ref.float()).abs().max().item()
        errs.append(diff)
        rels.append(diff / ref.float().abs().max().item())
    ok = all(math.isfinite(r) and r <= BWD_TOL[dtype] for r in rels)
    log(f"flash_bwd {name} {str(dtype)[6:]}: max|d| dQ {errs[0]:.3e} dK "
        f"{errs[1]:.3e} dV {errs[2]:.3e}; / max|ref| {rels[0]:.3e} "
        f"{rels[1]:.3e} {rels[2]:.3e} (tol {BWD_TOL[dtype]:g}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"flash_bwd disagrees at {name} {dtype}")
    return errs[0], max(errs[1:])


def sass_counts(path: Path) -> dict[str, tuple[int, int, int]]:
    """(HGMMA, UTMALDG, highest register) per kernel of a built library,
    from ``cuobjdump -sass``: the wgmma products and the TMA tile loads
    that the compiler kept, and the registers it allocated (ptxas reports
    a warp-specialised kernel's count at entry, 168, where its consumers
    may use up to 232 after setmaxnreg.inc), by the kernel's short name
    (``name<D>``)."""
    from kubeflow_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts: dict[str, list[int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"(?<=\d)(flash_\w+?)ILi(\d+)E", mangled)
            current = f"{m.group(1)}<{m.group(2)}>" if m else mangled
            counts[current] = [0, 0, -1]
        elif current is not None:
            counts[current][0] += "HGMMA" in line
            counts[current][1] += "UTMALDG" in line
            counts[current][2] = max([counts[current][2]] + [
                int(r) for r in re.findall(r"\bR(\d+)\b", line)])
    return {k: tuple(v) for k, v in counts.items()}


def check_build(libs: dict) -> None:
    """Print what ptxas and cuobjdump say of each library; fail on a
    spill, on wgmma products that ptxas serialises, or when a bf16 K1, K2
    or K3 instantiation lost its wgmma products (HGMMA) or its TMA loads
    (UTMALDG)."""
    from kubeflow_tpu_torch.ops import _build

    for name, path in libs.items():
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "Performance Loss")):
                log(f"  nvcc[{name}] {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            check(m is None or m.groups() == ("0", "0"),
                  f"ptxas spills in {name}: {line.strip()}")
            # ptxas runs the wgmma products of such a kernel one by one
            check("Performance Loss" not in line,
                  f"ptxas serialises wgmma in {name}: {line.strip()}")
        for kernel, (hgmma, utmaldg, reg) in sorted(
                sass_counts(path).items()):
            log(f"  sass[{name}] {kernel}: HGMMA {hgmma} UTMALDG {utmaldg} "
                f"registers to R{reg}")
    wgmma = {**sass_counts(libs["flash_fwd"]), **sass_counts(libs["flash_bwd"])}
    for kernel in WGMMA_KERNELS:
        hgmma, utmaldg, _ = wgmma.get(kernel, (0, 0, 0))
        check(hgmma > 0 and utmaldg > 0,
              f"{kernel}: HGMMA {hgmma}, UTMALDG {utmaldg} (wanted > 0)")


def phase_kernels(fa) -> dict:
    """Hold the kernels against their plain versions; returns each
    kernel's max abs error at the bf16 main-path shapes."""
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    check_build(libs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_err = main_err_256 = 0.0
    cases = ([s[:8] for s in main_path_shapes() + prefix_path_shapes()
              + gemma_path_shapes()]
             + [TRAIN_SHAPE, GANG_SHAPE, LLAMA_SHAPE, GEMMA_SHAPE,
                *MESH_SHAPES, *SP_SHAPES, *MOE_SP_SHAPES, *MH_SHAPES,
                *p22_all_shapes()]
             + SPEC_SHAPES
             + EXTRA_SHAPES + D256_SHAPES)
    for i, (name, b, sq, sk, h, hkv, d, causal) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed=i,
                               strided=name.endswith("strided"))
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
            ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            diff = (o.float() - ro.float()).abs()
            e_o = diff.max().item()
            over = (diff - tol["atol"] - tol["rtol"] * ro.float().abs()
                    ).max().item()
            e_l = (lse - rlse).abs().max().item()
            ok = math.isfinite(e_o) and over <= 0 and e_l <= tol["lse"]
            log(f"flash_fwd {name} {str(dtype)[6:]}: max|dO| {e_o:.3e} "
                f"(tol {tol['atol']:g} + {tol['rtol']:g}|O|), max|dlse| "
                f"{e_l:.3e} (tol {tol['lse']:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_fwd disagrees at {name} {dtype}")
            if dtype == torch.bfloat16 and name.startswith(
                    ("7b_prefill", "7b_prefix", "7b_spec", "7b_multihost",
                     "7b_predictor",
                     TRAIN_SHAPE[0],
                     GANG_SHAPE[0], LLAMA_SHAPE[0], "llama7b_mesh",
                     "llama7b_sp", "llama7b_pp")):
                main_err = max(main_err, e_o)
            if dtype == torch.bfloat16 and name.startswith(
                    ("gemma2b_prefill", GEMMA_SHAPE[0])):
                main_err_256 = max(main_err_256, e_o)
    errs = {"flash_fwd": main_err, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
            "flash_fwd<256>": main_err_256, "flash_bwd_dq<256>": 0.0,
            "flash_bwd_dkv<256>": 0.0}
    for i, (name, *shape) in enumerate(BWD_SHAPES + MOE_SP_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            e_dq, e_dkv = check_backward(fa, name, *shape, dtype, seed=50 + i)
            if dtype != torch.bfloat16:
                continue
            if name in (TRAIN_SHAPE[0], GANG_SHAPE[0], LLAMA_SHAPE[0],
                        *(shape[0] for shape in MESH_SHAPES + SP_SHAPES
                          + MOE_SP_SHAPES)):
                errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
                errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e_dkv)
            elif name == GEMMA_SHAPE[0]:
                errs["flash_bwd_dq<256>"] = e_dq
                errs["flash_bwd_dkv<256>"] = e_dkv
    # the plain versions' temporaries (~20 GB at the 4096-token shape)
    # leave cached segments; later phases allocate from a clean cache
    free_memory()
    return errs


def post(port: int, path: str, body: dict,
         headers: dict | None = None) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serving_bodies(vocab: int, seed: int) -> list[dict]:
    """Phase 2's four ``:generate`` bodies: prompts of ``PROMPT_LENS``
    tokens drawn from ``seed``, ``NEW_TOKENS`` each, the last one
    sampled."""
    rng = np.random.default_rng(seed)
    bodies = [{"ids": [rng.integers(1, vocab, n).tolist()],
               "max_new_tokens": NEW_TOKENS} for n in PROMPT_LENS]
    bodies[3].update(temperature=0.8, seed=7)
    return bodies


def concurrent_round(port: int, bodies: list[dict],
                     headers: dict | list | None = None) -> list:
    """The bodies as concurrent ``:generate`` requests (``headers``: for
    every request, or a list of each one's): (status, body) each."""
    results: list = [None] * len(bodies)
    each = headers if isinstance(headers, list) else [headers] * len(bodies)

    def call(i):
        results[i] = post(port, "/v1/models/llama:generate", bodies[i],
                          each[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


@contextlib.contextmanager
def flash_route(replacement):
    """Route the attention dispatcher's flash calls to ``replacement``
    (same signature as ``flash_attention``) for the duration."""
    from kubeflow_tpu_torch.ops import attention

    original = attention.flash_attention
    attention.flash_attention = replacement
    try:
        yield
    finally:
        attention.flash_attention = original


@contextlib.contextmanager
def plain_attention_route(model):
    """Run ``model`` with its attention on the plain masked route
    (use_flash off) for the duration; the weights are shared."""
    attns = [blk.attention for blk in model.layers]
    flash_cfg = attns[0].cfg
    plain_cfg = dataclasses.replace(flash_cfg, use_flash=False)
    for a in attns:
        a.cfg = plain_cfg
    try:
        yield
    finally:
        for a in attns:
            a.cfg = flash_cfg


def checked_flash(fa, worst: dict, shapes: set, calls: list | None = None):
    """A stand-in for ``flash_attention`` that runs the kernel, holds each
    call against the plain version on the same q, k, v, and passes the
    kernel's output on; the worst ratios go to ``worst`` ("o", "lse") and
    each call's (Sq, Sk) to ``shapes`` (and its whole shape to ``calls``,
    as ``recording_flash`` records it, when given)."""
    def checked(q, k, v, *, causal=False):
        if calls is not None:
            calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          k.shape[2], q.shape[3], causal))
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
        sum_pv = fa.flash_attention_reference(q, k, v.abs(),
                                              causal=causal)[0].float()
        allowance = 2.0 ** -7 * (ro.float().abs() + sum_pv) + 1e-6
        e_o = ((o.float() - ro.float()).abs() / allowance).max().item()
        e_l = ((lse - rlse).abs().max()
               / rlse.abs().max().clamp_min(1.0)).item()
        check(math.isfinite(e_o) and math.isfinite(e_l), (e_o, e_l))
        worst["o"], worst["lse"] = max(worst["o"], e_o), max(worst["lse"], e_l)
        shapes.add((q.shape[1], k.shape[1]))
        return o

    return checked


def in_model_ok(worst: dict) -> bool:
    return (worst["o"] <= IN_MODEL_TOL["o"]
            and worst["lse"] <= IN_MODEL_TOL["lse"])


def check_in_model(fa, model, prompt: list[int]) -> None:
    """Chunked prefill of ``prompt`` through a batch-1 cache, as the engine
    runs it, with every flash call held against the plain version on the
    same q, k, v (the kernel's output goes on)."""
    from kubeflow_tpu_torch.models import llama

    worst = {"o": 0.0, "lse": 0.0}
    shapes = set()
    cache = llama.init_cache(model.config, 1, MAX_SEQ)
    with torch.no_grad(), flash_route(checked_flash(fa, worst, shapes)):
        for pos in range(0, len(prompt), PREFILL_CHUNK):
            chunk = prompt[pos:pos + PREFILL_CHUNK]
            for layer in cache["layers"]:
                layer["index"] = pos
            model(torch.tensor([chunk], device="cuda"), cache=cache)
    ok = in_model_ok(worst)
    log(f"in-model check, {len(prompt)}-token prefill (Sq, Sk) "
        f"{sorted(shapes)} x {model.config.num_layers} layers: max "
        f"|dO|/(2^-7 (|O| + P|V|)) {worst['o']:.3e} (tol "
        f"{IN_MODEL_TOL['o']:g}), max|dlse|/max|lse| "
        f"{worst['lse']:.3e} (tol {IN_MODEL_TOL['lse']:g}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, worst)
    del cache


@contextlib.contextmanager
def moe_routing(record: list, replay: list | None = None):
    """Record every MoE block call's top-2 experts ``[B, S, 2]`` into
    ``record`` (the choices the router makes); with ``replay``, route each
    call to the experts of the same call in ``replay`` instead, the gates
    taken from this call's own probabilities at those experts.  Holding
    the routing fixed lets two attention routes be compared without a
    rounding-level difference flipping a discrete expert choice."""
    from kubeflow_tpu_torch.models import moe

    original = moe.route
    pinned = iter(replay) if replay is not None else None

    def routed(probs):
        gates, experts = original(probs)
        record.append(experts)
        if pinned is not None:
            experts = next(pinned)
            g = probs.gather(-1, experts)
            gates = g / g.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return gates, experts

    moe.route = routed
    try:
        yield
    finally:
        moe.route = original


def routing_flips(a: list, b: list) -> int:
    """(layer, token) pairs whose top-2 expert sets differ between two
    recorded runs."""
    return sum(int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                   .any(dim=-1).sum()) for x, y in zip(a, b))


def prefill_logits(model, ids, cached: bool):
    """Logits of one prompt: a cacheless forward, or (``cached``) the
    serving path's batch-1 prefill through a cache (an MoE model routes
    dropless only there)."""
    from kubeflow_tpu_torch.models import llama

    if not cached:
        return model(ids)["logits"]
    cache = llama.init_cache(model.config, 1, ids.shape[1])
    return model(ids, cache=cache)["logits"]


def phase_serving(fa, model_config: dict | None = None,
                  label: str = "llama 7b", extra=None, **pred_kw) -> dict:
    """Phase 2 (with an MoE ``model_config``, phase 9; with ``quantize``,
    phase 12): the 7B predictor over HTTP.  ``extra(pred)`` runs further
    checks on the predictor before it stops; its dict joins the result,
    which holds the counted run's streams."""
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp)

    t0 = time.perf_counter()
    pred = GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                               prefill_chunk=PREFILL_CHUNK, max_batch=4,
                               seed=0, model_config=model_config, **pred_kw)
    torch.cuda.synchronize()
    cfg = pred.cfg
    n_params = sum(t.numel() for t in (*pred.module.parameters(),
                                       *pred.module.buffers()))
    log(f"{label} built in {time.perf_counter() - t0:.1f}s: "
        f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{n_params / 1e9:.2f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    # the default path keeps no prefix cache and holds no page rows
    check(pred.engine.prefix_cache is None and pred.engine.pool.kv is None,
          "the default engine allocated page rows")
    httpd, thread = serve(PredictorApp({"llama": pred}), 0)
    port = httpd.server_port
    try:
        # warm-up round at the same shapes (CUDA module loading, cuBLAS
        # heuristics, allocator), other prompts; not counted
        check(all(r[0] == 200 for r in concurrent_round(
            port, serving_bodies(cfg.vocab_size, 1))), "warm-up round")
        bodies = serving_bodies(cfg.vocab_size, 0)
        prompts = [b["ids"][0] for b in bodies]
        chunks = len(prefill_shapes())
        before = pred.engine.stats()["timing"]

        first: dict = {}
        fa.flash_attention.launches = 0          # the main path starts
        t0 = time.perf_counter()
        with first_logits_by_length(first):
            results = concurrent_round(port, bodies)
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches   # the main path ended
        after = pred.engine.stats()["timing"]

        for i, (status, body) in enumerate(results):
            check(status == 200, (i, status, body))
            out = body["ids"][0]
            check(len(out) == PROMPT_LENS[i] + NEW_TOKENS, (i, len(out)))
            check(out[:PROMPT_LENS[i]] == prompts[i], (i, "prompt echo"))
            check(all(0 <= t < cfg.vocab_size for t in out), (i, "ids"))
        expect = cfg.num_layers * chunks
        log(f"4 concurrent requests in {wall:.2f}s; flash_fwd launches "
            f"{launches} (expected {cfg.num_layers} x {chunks} chunks = "
            f"{expect})")
        check(launches == expect, (launches, expect))
        check(after["prefill_chunks"] - before["prefill_chunks"] == chunks,
              "prefill chunks")

        for i in (1, 3):  # a greedy and the seeded request, alone
            status, body = post(port, "/v1/models/llama:generate", bodies[i])
            check(status == 200 and body["ids"] == results[i][1]["ids"],
                  (i, "re-sent request"))
        log("re-sent greedy and seeded requests reproduce their tokens")

        model = pred.module
        check_in_model(fa, model, prompts[3])

        # prefill logits: kernel route vs the plain routes, same weights
        ids = torch.tensor([prompts[1]], device="cuda")

        def plain_version(q, k, v, *, causal=False):
            return fa.flash_attention_reference(q, k, v, causal=causal)[0]

        cached = bool(model_config)
        moe = cached and cfg.moe_experts > 0
        kernel_routes: list = []
        with torch.no_grad():
            with moe_routing(kernel_routes):
                k_logits = prefill_logits(model, ids, cached)
            check(torch.equal(prefill_logits(model, ids, cached), k_logits),
                  "the kernel route is not deterministic")
            refs = {}
            for name, route in (("kernel_plain_version",
                                 flash_route(plain_version)),
                                ("plain_route", plain_attention_route(model))):
                with route:
                    if moe:
                        # unpinned: each route takes its own routing
                        # decisions; pinned: the kernel run's experts
                        own: list = []
                        with moe_routing(own):
                            free = prefill_logits(model, ids, cached)
                        flips = routing_flips(kernel_routes, own)
                        rel = ((k_logits - free).abs().max()
                               / free.abs().max()).item()
                        log(f"prefill logits kernel vs {name}, each route "
                            f"routing for itself: max rel err {rel:.3e}; "
                            f"{flips} of {len(own) * own[0].shape[1]} "
                            f"(layer, token) top-2 expert sets differ")
                        with moe_routing([], replay=kernel_routes):
                            refs[name] = prefill_logits(model, ids, cached)
                    else:
                        refs[name] = prefill_logits(model, ids, cached)
        check(bool(torch.isfinite(k_logits).all()), "finite logits")
        for name, ref in refs.items():
            rel = ((k_logits - ref).abs().max() / ref.abs().max()).item()
            tol = LOGITS_REL_TOL[name]
            pinned = ", experts pinned to the kernel run's" if moe else ""
            log(f"prefill logits [1, {len(prompts[1])}, {cfg.vocab_size}] "
                f"kernel vs {name}{pinned}: max rel err {rel:.3e} (tol "
                f"{tol:g})")
            check(rel <= tol, (name, rel))

        n_ttft = after["ttft_count"] - before["ttft_count"]
        dec_tok = after["decode_tokens"] - before["decode_tokens"]
        dec_s = after["decode_seconds"] - before["decode_seconds"]
        out = {"launches": launches,
               "ttft_mean_s": (after["ttft_sum"] - before["ttft_sum"])
               / max(n_ttft, 1),
               "decode_tok_per_s": dec_tok / dec_s if dec_s else 0.0,
               "wall_s": wall, "streams": [r[1]["ids"][0] for r in results],
               "first_logits": first}
        if extra is not None:
            out.update(extra(pred))
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        pred.stop(timeout=60)


@contextlib.contextmanager
def first_token_logits(store: list):
    """Record the float32 logits the engine samples each first token from
    (its batch-1 prefill calls of ``sample_rows``) into ``store``."""
    from kubeflow_tpu_torch.serving import engine

    original = engine.sample_rows

    def capture(logits, reqs, gens):
        if logits.shape[0] == 1:
            store.append(logits[0].float().clone())
        return original(logits, reqs, gens)

    engine.sample_rows = capture
    try:
        yield
    finally:
        engine.sample_rows = original


@contextlib.contextmanager
def first_logits_by_length(store: dict):
    """Record the float32 logits (on the host) each first token is sampled
    from, by prompt length, into ``store``."""
    from kubeflow_tpu_torch.serving import engine

    original = engine.sample_rows

    def capture(logits, reqs, gens):
        if logits.shape[0] == 1:
            store[len(reqs[0].ids)] = logits[0].float().cpu()
        return original(logits, reqs, gens)

    engine.sample_rows = capture
    try:
        yield
    finally:
        engine.sample_rows = original


def serve_one(engine, prompt: list[int], store: list, **kw) -> dict:
    """One request through ``engine`` alone: its tokens, TTFT, prefill
    dispatches and tokens, and first-token logits (from ``store``)."""
    from kubeflow_tpu_torch.serving.engine import (PREFILL_DISPATCHES,
                                                   PREFILL_TOKENS)

    d0, t0, n0 = PREFILL_DISPATCHES.get(), PREFILL_TOKENS.get(), len(store)
    req = engine.submit(prompt, NEW_TOKENS, **kw)
    ids = req.result(timeout=600)
    check(len(store) == n0 + 1, "one first-token sample per request")
    return {"ids": ids, "ttft": req.first_token_at - req.submitted_at,
            "dispatches": int(PREFILL_DISPATCHES.get() - d0),
            "tokens": int(PREFILL_TOKENS.get() - t0), "logits": store[-1]}


def scratch_rows(engine) -> list:
    """The engine's batch-1 prefill scratch, (k, v) [max_seq, Hkv, D] per
    layer (views)."""
    return [(l["k"][0], l["v"][0]) for l in engine._scratch()]


def same_rows(rows: list, ref: list, n: int) -> bool:
    """Whether two lists of (k, v) per layer agree bitwise on their first
    ``n`` positions in every layer."""
    return all(torch.equal(k[:n], rk[:n]) and torch.equal(v[:n], rv[:n])
               for (k, v), (rk, rv) in zip(rows, ref))


def page_rows(pool, pages: list[int]) -> list:
    """The pages' KV as contiguous positions, (k, v) per layer."""
    trees = [pool.get(p)["layers"] for p in pages]
    return [tuple(torch.cat([t[li][name] for t in trees])
                  for name in ("k", "v")) for li in range(len(trees[0]))]


def idle_state(engine) -> dict:
    """The pool's stats at idle; fails on an orphaned page or a pin."""
    check(engine.drained(timeout=60), "engine idle")
    st = engine.stats()
    log(f"  kv_pool {json.dumps(st['kv_pool'])}")
    log(f"  prefix_cache {json.dumps(st['prefix_cache'])}")
    check(st["kv_pool"]["orphan_pages"] == 0, st["kv_pool"])
    check(st["prefix_cache"]["pinned"] == 0, st["prefix_cache"])
    return st


def chat_turns(vocab: int, seed: int) -> list[list[int]]:
    """Phase 7(a)'s traffic: a ``PC_SYSTEM``-token system prompt with user
    turns of ``PC_SUFFIXES`` tokens, then the first turn again."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, PC_SYSTEM).tolist()
    users = [rng.integers(1, vocab, n).tolist() for n in PC_SUFFIXES]
    check(len({u[0] for u in users}) == len(users), "distinct turns")
    return [system + u for u in users] + [system + users[0]]


def phase_prefix_cache(fa) -> dict:
    """Phase 7: prefix-cached serving (module docstring)."""
    from kubeflow_tpu_torch.serving.engine import (PREFIX_HITS,
                                                   PREFIX_MISSES,
                                                   ContinuousBatcher)
    from kubeflow_tpu_torch.serving.page_pool import pages_for
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    pred = GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                               prefill_chunk=PREFILL_CHUNK, max_batch=4,
                               seed=0, prefix_cache_mb=PC_CACHE_MB,
                               kv_page_size=PC_PAGE)
    warm, cfg = pred.engine, pred.cfg
    cold = ContinuousBatcher(pred.module, cfg, max_batch=4, max_seq=MAX_SEQ,
                             prefill_chunk=PREFILL_CHUNK)
    rows = warm.pool.kv["layers"][0]["k"].shape[0]
    log(f"phase 7: page pool {rows} rows x {warm.page_nbytes / 2**20:.1f} "
        f"MiB = {rows * warm.page_nbytes / 2**30:.2f} GiB, cache budget "
        f"{warm.prefix_cache.max_pages} pages; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def turns(seed):
        return chat_turns(cfg.vocab_size, seed)

    prompts = turns(70)
    plan = prefix_plan()
    check([len(p) for p in prompts] == [n for n, _ in plan], "plan")
    store: list = []
    with torch.no_grad(), first_token_logits(store):
        # warm-up at the counted run's shapes, off it: on the cache-less
        # engine, the first turn on another system prompt (its own first
        # use; the model's GEMM and kernel shapes are the warm engine's,
        # whose warm-up warms them all; the rest of this engine's round was
        # cut to keep the whole run under half its limit when phase 21
        # joined); on the warm engine, the same traffic on another system
        # prompt with every K1 call held against the plain version on the
        # same inputs
        serve_one(cold, turns(69)[0], store)
        worst, shapes = {"o": 0.0, "lse": 0.0}, set()
        saved = counters(fa)
        with flash_route(checked_flash(fa, worst, shapes)):
            for prompt in turns(71):
                serve_one(warm, prompt, store)
        set_counters(fa, saved)
        ok = in_model_ok(worst) and shapes == set(prefix_shapes())
        log(f"phase 7(a) in-model check, (Sq, Sk) {sorted(shapes)} x "
            f"{cfg.num_layers} layers: max |dO|/(2^-7 (|O| + P|V|)) "
            f"{worst['o']:.3e} (tol {IN_MODEL_TOL['o']:g}), max|dlse|/"
            f"max|lse| {worst['lse']:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, (worst, sorted(shapes)))

        colds = [serve_one(cold, p, store) for p in prompts]
        h0, m0 = PREFIX_HITS.get(), PREFIX_MISSES.get()
        saved = counters(fa)
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        warms, cold_rows = [], None
        for i, ((n, usable), prompt) in enumerate(zip(plan, prompts)):
            warms.append(serve_one(warm, prompt, store))
            if i == 0:
                cold_rows = [(k[:n].clone(), v[:n].clone())
                             for k, v in scratch_rows(warm)]
            else:   # the seeded head: the cold run's rows, bitwise
                check(same_rows(scratch_rows(warm), cold_rows, usable),
                      f"seeded scratch of request {i}")
            if usable < n - 1:   # committed: pages equal their scratch rows
                node, _ = warm.prefix_cache.match(prompt)
                want = pages_for(n, PC_PAGE)
                check(len(node.pages) == want, (i, len(node.pages), want))
                span = want * PC_PAGE
                check(same_rows(page_rows(warm.pool, node.pages),
                                scratch_rows(warm), span),
                      f"committed pages of request {i}")
        launches = counters(fa)                         # the path ended
        set_counters(fa, {k: saved[k] + launches[k] for k in saved})
        hits, misses = PREFIX_HITS.get() - h0, PREFIX_MISSES.get() - m0
        chunks = len(prefix_shapes())
        log(f"phase 7(a): flash_fwd launches {launches['flash_fwd']} "
            f"(expected {cfg.num_layers} x {chunks} chunks); prefix hits "
            f"{hits:.0f}, misses {misses:.0f}")
        check(launches == {"flash_fwd": cfg.num_layers * chunks,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, launches)
        check((hits, misses) == (3, 1), (hits, misses))
        log(f"  {card_line()}")
        same = 0
        for i, (c, w, (n, usable)) in enumerate(zip(colds, warms, plan)):
            rel = ((w["logits"] - c["logits"]).abs().max()
                   / c["logits"].abs().max()).item()
            same += w["ids"] == c["ids"]
            log(f"  request {i}: {n} tokens, reused {usable}: TTFT cold "
                f"{c['ttft'] * 1e3:.2f} ms ({c['dispatches']} dispatches, "
                f"{c['tokens']} tokens), warm {w['ttft'] * 1e3:.2f} ms "
                f"({w['dispatches']} dispatches, {w['tokens']} tokens); "
                f"first-token logits max rel err {rel:.3e} (tol "
                f"{WARM_LOGITS_REL_TOL:g})")
            check(math.isfinite(rel) and rel <= WARM_LOGITS_REL_TOL, (i, rel))
            check(w["tokens"] == n - usable, (i, w["tokens"], n - usable))
        check((warms[3]["dispatches"], warms[3]["tokens"]) == (1, 1),
              "a full-prefix hit is one prefill dispatch of one token")
        log(f"  warm streams token-identical to their cold streams: "
            f"{same} of {len(warms)}")
        idle_state(warm)

        # the seed (gather of the system prompt's pages into the scratch)
        # and a commit (scatter of a turn's new pages), off the path
        node, _ = warm.prefix_cache.match(prompts[1])
        seed_pages = node.pages[:PC_SYSTEM // PC_PAGE]
        new_pages = node.pages[PC_SYSTEM // PC_PAGE:]
        span = len(seed_pages) * PC_PAGE
        scratch = warm._scratch()
        dst = [(torch.empty_like(l["k"][0, :span]),
                torch.empty_like(l["v"][0, :span])) for l in scratch]
        fresh = warm.pool.alloc(len(new_pages))
        check(fresh is not None, "pages for the commit timing")
        src = [(l["k"][0, span:span + len(fresh) * PC_PAGE],
                l["v"][0, span:span + len(fresh) * PC_PAGE])
               for l in scratch]
        seed_ms = time_ms(lambda: warm.pool.gather(seed_pages, dst), reps=5)
        commit_ms = time_ms(lambda: warm.pool.put_many(fresh, src), reps=5)
        warm.pool.decref(fresh)
        seed_bytes = 2 * len(seed_pages) * warm.page_nbytes
        commit_bytes = 2 * len(fresh) * warm.page_nbytes
        log(f"  seed of {len(seed_pages)} pages ({warm.pool.page_nbytes} B "
            f"each, {cfg.num_layers} layers): {seed_ms:.4f} ms, bound "
            f"{seed_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes); commit of "
            f"{len(fresh)} pages: {commit_ms:.4f} ms, bound "
            f"{commit_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
        del dst, src, cold_rows, scratch
    tier = phase_host_tier(pred.module, cfg)
    pred.stop(timeout=60)
    cold.shutdown()
    del pred, cold, warm
    free_memory()
    return {"launches": launches["flash_fwd"], "seed_ms": seed_ms,
            "commit_ms": commit_ms, "same_streams": same,
            "ttft_cold_ms": [c["ttft"] * 1e3 for c in colds],
            "ttft_warm_ms": [w["ttft"] * 1e3 for w in warms], **tier}


def phase_host_tier(model, cfg) -> dict:
    """Phase 7(b): spill to the host arena under the cache budget, and a
    fault back on the next hit, on ``model``'s weights."""
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    eng = ContinuousBatcher(model, cfg, max_batch=4, max_seq=MAX_SEQ,
                            prefill_chunk=PREFILL_CHUNK,
                            prefix_cache_bytes=int(PC_TIER_CACHE_MB
                                                   * (1 << 20)),
                            page_size=PC_PAGE,
                            host_kv_pages=PC_TIER_HOST_PAGES)
    rng = np.random.default_rng(72)
    p1, p2 = (rng.integers(1, cfg.vocab_size, PC_TIER_PROMPT).tolist()
              for _ in range(2))
    store: list = []
    with torch.no_grad(), first_token_logits(store):
        serve_one(eng, p1, store)
        hit = serve_one(eng, p1, store)
        node, _ = eng.prefix_cache.match(p1)
        pages = list(node.pages)
        snapshot = [tuple(t.clone() for t in layer)
                    for layer in page_rows(eng.pool, pages)]
        serve_one(eng, p2, store)
        st = eng.stats()
        spilled = [eng.pool.tier(p) for p in pages].count("host")
        log(f"phase 7(b): cache budget {eng.prefix_cache.max_pages} pages, "
            f"host arena {eng.pool.host_pages}; after a second "
            f"{PC_TIER_PROMPT}-token prompt: spills_total "
            f"{st['kv_pool']['spills_total']}, {spilled} of the first "
            f"prompt's {len(pages)} pages in the host tier")
        check(st["kv_pool"]["spills_total"] > 0 and spilled == len(pages),
              st["kv_pool"])
        again = serve_one(eng, p1, store)
        st = idle_state(eng)
        faulted = same_rows(page_rows(eng.pool, pages), snapshot,
                            len(pages) * PC_PAGE)
        log(f"  the first prompt again: faults_total "
            f"{st['kv_pool']['faults_total']}, pages bitwise equal to the "
            f"snapshot {faulted}, stream identical to the earlier hit "
            f"{again['ids'] == hit['ids']}, TTFT after the fault "
            f"{again['ttft'] * 1e3:.2f} ms (hit before the spill "
            f"{hit['ttft'] * 1e3:.2f} ms)")
        check(st["kv_pool"]["faults_total"] > 0 and faulted
              and again["ids"] == hit["ids"], "spill and fault")
    eng.shutdown()
    del eng, snapshot
    return {"spills": st["kv_pool"]["spills_total"],
            "faults": st["kv_pool"]["faults_total"]}


def time_ms(fn, reps: int = 20, windows: int = 7) -> float:
    """Device time of one call: median over windows of the mean of
    ``reps`` back-to-back calls, from CUDA events, after a warm-up.  Each
    window is enqueued behind a device-side sleep longer than the host
    takes to enqueue it, so the calls run back to back even when the
    Python wrapper is slower than the kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)      # ~10 ms at H100 clocks
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def flash_bound(kernel, b, sq, sk, h, hkv, d, causal,
                dtype) -> tuple[float, float]:
    """Least time the card needs for ``kernel`` (``KERNEL_WORK``), as
    (bytes ms, operations ms): each input read once and each output
    written once over the HBM rate; the FLOPs of the visible (q, k) pairs
    over the dtype's peak rate."""
    n_q, n_k, n_rows, products = KERNEL_WORK[kernel]
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n_q * b * sq * h * d + n_k * b * sk * hkv * d) * item \
        + n_rows * b * h * sq * 4
    if causal:  # query i sees keys [0, i + sk - sq]
        pairs = sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 2.0 * products * d * pairs * b * h
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def bound_fields(kernel, shape, dtype) -> dict:
    t_bytes, t_ops = flash_bound(kernel, *shape, dtype)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def profile_device(label: str, fn, top: int = 6) -> float:
    """Device time of one ``fn()`` by operator (torch.profiler), after a
    warm-up call: prints the total and the ``top`` kernels; returns the
    total in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()                                  # warm
    torch.cuda.synchronize()
    # the device's activity alone: every number here reads device kernels,
    # and recording the host's operators too took seconds a profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device kernels only: operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    log(f"profile {label}: device time {total / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")
    for e in events:
        if "flash_" in e.key:
            log(f"  ours: {e.self_device_time_total / 1e3:9.3f} ms "
                f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
                f"x{e.count:<4d} {e.key[:90]}")
    groups: dict[str, float] = {}
    for e in events:
        group = kernel_group(e.key)
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    log("  by kind: " + ", ".join(
        f"{g} {t / 1e3:.3f} ms ({100 * t / max(total, 1):.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    return total / 1e3


def kernel_group(key: str) -> str:
    """A device kernel's kind, from its name."""
    if "flash_" in key:
        return "flash kernels"
    if ("gpu_kernel_impl<" in key and "MulFunctor" in key
            and "BFloat16" in key):
        # int8 q times a bf16 scale: the one bf16 product that casts an
        # operand (bf16 x bf16 runs gpu_kernel_impl_nocast)
        return "int8 dequantize"
    if any(w in key for w in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolution"
    if "f32f32" in key or "sgemm" in key:
        return "float32 GEMM"
    if "nvjet" in key or "gemm" in key or "cutlass" in key:
        return "bf16 GEMM"
    if "indexing" in key or "index_" in key or "scatter" in key:
        return "gather/scatter"
    if "reduce" in key or "softmax" in key or "norm" in key:
        return "reductions"
    if "elementwise" in key or "copy" in key or "foreach" in key:
        return "elementwise"
    return "other"


def profile_forward(model, label: str, ids, cache) -> float:
    """Device time of one forward by operator, top 6, and the flash
    kernel's share; returns the total in ms."""
    def forward():
        with torch.no_grad():
            model(ids, cache=cache)

    return profile_device(label, forward)


def phase_profile(model=None, label: str = "") -> dict:
    """Where a prefill chunk's and a decode step's device time goes, at
    the 7B serving shapes (random weights, seed 0), on ``model`` or a
    dense 7B built here; returns both totals in ms."""
    from kubeflow_tpu_torch.models import llama, registry

    built = model is None
    if built:
        model = registry.get("llama").make_model(
            size="7b", param_dtype="compute").init_weights(0)
    cfg = model.config
    scratch = llama.init_cache(cfg, 1, MAX_SEQ)
    for layer in scratch["layers"]:
        layer["index"] = 512
    ids = torch.randint(1, cfg.vocab_size, (1, 512), device="cuda")
    chunk_ms = profile_forward(
        model, f"{label}prefill chunk [1, 512] at offset 512", ids, scratch)
    view = llama.init_cache(cfg, 4, MAX_SEQ, per_sequence=True)
    for layer in view["layers"]:
        layer["index"] = torch.tensor([16, 300, 700, 1500], device="cuda")
    tok = torch.randint(1, cfg.vocab_size, (4, 1), device="cuda")
    decode_ms = profile_forward(
        model, f"{label}decode step [4, 1] over a 4 x 2048 view", tok, view)
    del scratch, view
    if built:
        del model
    torch.cuda.empty_cache()
    return {"chunk_ms": chunk_ms, "decode_ms": decode_ms}


KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def counters(fa) -> dict:
    """Each kernel's launch counter, by kernel name."""
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def set_counters(fa, values: dict) -> None:
    fa.flash_attention.launches = values["flash_fwd"]
    fa.flash_bwd_dq.launches = values["flash_bwd_dq"]
    fa.flash_bwd_dkv.launches = values["flash_bwd_dkv"]


def phase_training(fa, config: dict, launches: dict, label: str) -> dict:
    """A training main path: the worker entrypoint in-process with
    ``config``, every step logged (a sync per step).  Every step must
    launch each kernel ``launches[name]`` times and every loss must be
    finite."""
    from kubeflow_tpu_torch.training import __main__ as worker

    losses, stamps, per_step = [], [], []
    seen = dict.fromkeys(KERNEL_NAMES, 0)
    steps, batch = config["steps"], config["global_batch"]

    def hook(step, rec):
        now = counters(fa)
        per_step.append({n: now[n] - seen[n] for n in KERNEL_NAMES})
        seen.update(now)
        losses.append(rec["loss"])
        stamps.append(time.perf_counter())

    saved_env = os.environ.get("JAXJOB_TRAINER_CONFIG")
    os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(config)
    try:
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t0 = time.perf_counter()
        rc = worker.main(["--device", "cuda"], metrics_hook=hook)
        wall = time.perf_counter() - t0
        total = counters(fa)                              # the path ended
    finally:
        if saved_env is None:
            os.environ.pop("JAXJOB_TRAINER_CONFIG", None)
        else:
            os.environ["JAXJOB_TRAINER_CONFIG"] = saved_env
    check(rc == 0, f"{label}: training worker exited {rc}")
    check(len(losses) == steps, f"{label}: {len(losses)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    log(f"{label} training, {steps} steps at batch {batch}: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    for i, got in enumerate(per_step):
        check(got == launches, f"{label} step {i + 1} launches {got}, "
              f"expected {launches}")
    log(f"{label} launches per step {per_step[0]} in each of "
        f"{len(per_step)} steps (expected {launches}); total {total}")
    steady = batch * (len(stamps) - 1) / (stamps[-1] - stamps[0])
    log(f"{label} samples/s: {steady:.2f} over steps 2-{steps} "
        f"({1e3 * batch / steady:.1f} ms per step), "
        f"{batch * steps / wall:.2f} over the whole run including model "
        f"build ({wall:.1f}s)")
    return {"launches": total, "losses": losses, "samples_per_sec": steady,
            "wall_s": wall}


@contextlib.contextmanager
def backward_checked(fa, worst: dict):
    """Route the flash Function's backward through a wrapper that runs it
    (K2 and K3 launch as usual), then runs each kernel's plain version on
    that call's inputs (q, k, v, dO, lse and the same delta) and keeps the
    largest max|kernel - plain| / max|plain| per gradient."""
    backward = fa.flash_attention_backward

    def note(key, x, ref):
        rel = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        check(math.isfinite(rel), (key, rel))
        worst[key] = max(worst.get(key, 0.0), rel)

    def checked(q, k, v, o, lse, do, *, causal=False):
        dq, dk, dv = backward(q, k, v, o, lse, do, causal=causal)
        do = do.to(q.dtype)
        delta = fa.flash_bwd_delta(o, do)
        note("dq", dq, fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                 causal=causal))
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal=causal)
        note("dk", dk, rdk)
        note("dv", dv, rdv)
        worst["calls"] = worst.get("calls", 0) + 1
        return dq, dk, dv

    fa.flash_attention_backward = checked
    try:
        yield
    finally:
        fa.flash_attention_backward = backward


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def build_training(config: dict, optimizer: dict):
    """(model, state, step, batch) of ``config``'s model on the card with
    weights from seed 0 and the first synthetic batch."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.data import to_device
    from kubeflow_tpu_torch.training.optim import make_optimizer

    entry = registry.get(config["model"])
    model = entry.make_model(device="cuda",
                             **config["model_config"]).init_weights(0)
    state = ts.init_train_state(model, make_optimizer(optimizer))
    step = ts.build_train_step(entry.forward_loss, state.tx)
    batch = to_device(entry.make_batch(
        config["global_batch"], torch.Generator().manual_seed(0), model),
        torch.device("cuda"))
    return model, state, step, batch


def profile_step(label: str, state, step, batch) -> None:
    """Wall and device time of one train step, by operator, and the
    device's idle share over it."""
    step(state, batch)                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    device = profile_device(label, lambda: step(state, batch), top=15)
    log(f"train step wall {wall:.3f} ms, device busy {device:.3f} ms, "
        f"idle share {max(0.0, 1 - device / wall):.3f}")


def check_training_step(fa, config: dict, launches: dict,
                        label: str) -> None:
    """One train step of ``config``'s model through the kernels (every K2
    and K3 call held against its plain version) against the same step
    through the plain attention route; then the device time by operator
    of a step with the main path's optimizer."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.optim import make_optimizer

    # learning rate 0: each step computes loss, gradients and grad_norm and
    # leaves the weights as they were, so both routes see the same ones
    model, state, step, batch = build_training(
        config, {"name": "sgd", "learning_rate": 0.0, "momentum": 0.0})

    def run() -> dict:
        _, metrics = step(state, batch)
        return {k: v.item() for k, v in metrics.items()}

    worst: dict = {}
    before = counters(fa)
    with backward_checked(fa, worst):
        kern = run()
    launched = {n: counters(fa)[n] - before[n] for n in KERNEL_NAMES}
    check(launched == launches, f"checked step launched {launched}")
    with plain_attention_route(model):
        plain = run()
    calls = worst.pop("calls")
    ok_calls = (calls == model.config.num_layers
                and max(worst.values()) <= BWD_TOL[torch.bfloat16])
    log(f"in-step check: {calls} K2 and K3 calls of one {label} step vs "
        f"plain: max|d|/max|ref| dQ {worst['dq']:.3e} dK {worst['dk']:.3e} "
        f"dV {worst['dv']:.3e} (tol {BWD_TOL[torch.bfloat16]:g}) "
        f"{'ok' if ok_calls else 'FAIL'}")
    check(ok_calls, (calls, worst))
    for key in ("loss", "grad_norm"):
        rel = abs(kern[key] - plain[key]) / abs(plain[key])
        ok = math.isfinite(rel) and rel <= STEP_TOL[key]
        log(f"{label} train step {key}: kernels {kern[key]:.6f}, plain "
            f"route {plain[key]:.6f}, rel diff {rel:.3e} (tol "
            f"{STEP_TOL[key]:g}) {'ok' if ok else 'FAIL'}")
        check(ok, (key, kern, plain))

    # the main path's step (its optimizer), by operator
    del state, step
    free_memory()
    state = ts.init_train_state(model, make_optimizer(config["optimizer"]))
    step = ts.build_train_step(registry.get(config["model"]).forward_loss,
                               state.tx)
    profile_step(f"{label} {config['optimizer']['name']} train step "
                 f"{list(batch['input_ids'].shape)}", state, step, batch)
    del model, state, step, batch
    free_memory()


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


def phase_numbers(fa, shapes: list[tuple], num_layers: int) -> list[dict]:
    """K1's kernel, plain and library times with the bound, at each of a
    serving path's ``shapes`` (``path_shapes``); rows carry the shape's
    launches per layer and in the whole run of the path."""
    rows = []
    for name, b, sq, sk, h, hkv, d, causal, count in shapes:
        dtype = torch.bfloat16
        ms, plain_ms, library_ms = k1_times(fa, b, sq, sk, h, hkv, d, causal)
        row = {"shape": name, "per_layer": count,
               "launches": count * num_layers, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **bound_fields("flash_fwd", (b, sq, sk, h, hkv, d, causal),
                              dtype)}
        log(f"flash_fwd {name} bf16 (x{count} per layer): kernel {ms:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
        rows.append(row)
    return rows


def training_numbers(fa, shape_row: tuple, launches: dict,
                     per_step: dict | None,
                     plain_reps: int = 5) -> dict[str, dict]:
    """Each kernel's times at a training shape: kernel, plain version,
    bound, and the library yardstick (SDPA forward for K1; SDPA's
    backward, which computes dQ, dK and dV in one call, for K2 and K3).
    Rows carry the main path's ``launches`` of each kernel (``per_step``
    None: a phase whose launches are not per step)."""
    name, b, sq, sk, h, hkv, d, causal = shape_row
    shape = (b, sq, sk, h, hkv, d, causal)
    ms, plain, library = kernel_times(fa, shape, seed=12,
                                      plain_reps=plain_reps)
    rows = {}
    for kernel in KERNEL_NAMES:
        rows[kernel] = row = {
            "shape": name, "launches": launches[kernel], "ms": ms[kernel],
            "plain_ms": plain[kernel], "library_ms": library[kernel],
            **bound_fields(kernel, shape, torch.bfloat16)}
        count = (f"x{per_step[kernel]} per step" if per_step is not None
                 else f"x{launches[kernel]} in the phase")
        log(f"{kernel} {name} bf16 ({count}): "
            f"kernel {row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.5f} ms, "
            f"library {row['library_ms']:.5f} ms")
    log(f"sdpa {name} bf16: forward {library['flash_fwd']:.5f} ms, backward "
        f"(dQ, dK, dV) {library['flash_bwd_dq']:.5f} ms; flash kernels: "
        f"forward {ms['flash_fwd']:.5f} ms, backward "
        f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.5f} ms")
    return rows


def kernel_times(fa, shape: tuple, seed: int, plain_too: bool = True,
                 plain_reps: int = 5):
    """({kernel: ms}, {kernel: plain ms}, {kernel: SDPA ms}) of K1, K2 and
    K3 on bf16 inputs of ``shape`` (B, Sq, Sk, H, Hkv, D, causal); the
    launches made here are not counted.  ``plain_reps``: calls per timing
    window of the plain versions, in 3 windows below 20 (a plain call at a
    training shape takes 2-50 ms: 20 calls in 7 windows took ~9 s of the
    numbers over the training shapes; cut to keep the whole run under half
    its limit)."""
    from torch.nn.attention.bias import causal_lower_right
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, sq, sk, h, hkv, d, causal = shape
    dtype = torch.bfloat16
    q, k, v = make_qkv(b, sq, sk, h, hkv, d, dtype, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    saved = counters(fa)
    ms = {"flash_fwd": time_ms(
              lambda: fa.flash_attention_with_lse(q, k, v, causal=causal)),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
              q, k, v, do, lse, delta, causal=causal)),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(
              q, k, v, do, lse, delta, causal=causal))}
    set_counters(fa, saved)                      # timing is not the path
    if not plain_too:
        return ms, {}, {}
    windows = 7 if plain_reps >= 20 else 3
    plain = {"flash_fwd": time_ms(
                 lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                 plain_reps, windows),
             "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq_reference(
                 q, k, v, do, lse, delta, causal=causal), plain_reps,
                 windows),
             "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(
                 q, k, v, do, lse, delta, causal=causal), plain_reps,
                 windows)}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = causal_lower_right(sq, sk) if causal else None
    gqa = h != hkv              # SDPA's own grouped route, no repeat
    sdpa_fwd = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                    enable_gqa=gqa))
    ot = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
    dot = do.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    return ms, plain, {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                       "flash_bwd_dkv": sdpa_bwd}


def causal_numbers(fa) -> None:
    """K1, K2 and K3 under the causal mask at D = 128 (Llama-2-7B's heads,
    one sequence of 2048), off the main paths, beside their bounds."""
    ms, _, _ = kernel_times(fa, CAUSAL_DQ_SHAPE, seed=15, plain_too=False)
    for kernel in KERNEL_NAMES:
        bound = bound_fields(kernel, CAUSAL_DQ_SHAPE, torch.bfloat16)
        log(f"{kernel} causal {CAUSAL_DQ_SHAPE} bf16: kernel "
            f"{ms[kernel]:.5f} ms, bound {bound['bound_ms']:.5f} ms "
            f"({bound['bound_by']})")


def per_launch(rows: list[dict], key: str) -> float:
    """Mean over the main paths' launches (each shape weighted by its
    launches)."""
    n = sum(r["launches"] for r in rows)
    return sum(r[key] * r["launches"] for r in rows) / n


def kernel_entry(name: str, rows: list[dict], max_err: float) -> dict:
    """One kernel's object of the ``kernels`` line; times per launch over
    the main paths' mix of shapes.  ``name<256>`` is the D = 256
    instantiation, on phases 15 and 16."""
    source, replaces = {
        "flash_fwd": ("flash_fwd.cu", ":136"),
        "flash_bwd_dq": ("flash_bwd.cu", ":264"),
        "flash_bwd_dkv": ("flash_bwd.cu", ":282"),
    }[name.removesuffix("<256>")]
    bytes_ms, ops_ms = (per_launch(rows, k) for k in ("bytes_ms",
                                                       "operations_ms"))
    ms = per_launch(rows, "ms")
    return {
        "name": name, "route": "cuda",
        "source": f"kubeflow_tpu_torch/ops/csrc/{source}",
        "replaces": f"kubeflow_tpu/ops/flash_attention.py{replaces}",
        "launches": sum(r["launches"] for r in rows), "max_abs_err": max_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": per_launch(rows, "plain_ms"),
        "bound_ms": per_launch(rows, "bound_ms"),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_launch(rows, "library_ms"), "shapes": rows,
    }


def check_moe_block() -> dict:
    """One MoE block (``MOE_BLOCK``, ``MOE_EXPERTS`` experts, float32,
    a router bias that overflows expert 0) on the card against the same
    block on the CPU, in both modes: y and aux within 1e-5 relative, and
    the capacity drops equal (TF32 is off)."""
    from kubeflow_tpu_torch.models import moe

    cfg = moe.MoEConfig(hidden_size=MOE_BLOCK["hidden_size"],
                        ffn_size=MOE_BLOCK["ffn_size"],
                        num_experts=MOE_EXPERTS, dtype="float32")
    cpu = moe.MoEBlock(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    cpu.router.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():   # favour expert 0, so its capacity overflows
        cpu.router.bias[0] = 1.5
    card = moe.MoEBlock(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(*MOE_BLOCK["tokens"], cfg.hidden_size,
                    generator=torch.Generator().manual_seed(2))
    out = {}
    for dropless in (True, False):
        with torch.no_grad():
            y, aux = cpu(x, dropless=dropless)
            yc, auxc = card(x.cuda(), dropless=dropless)
        rel_y = ((yc.cpu() - y).abs().max() / y.abs().max()).item()
        rel_aux = abs(auxc.item() - aux.item()) / aux.item()
        mode = "dropless" if dropless else "capacity"
        drops = ("" if dropless else
                 f"; capacity drops card {int(card.dropped)}, cpu "
                 f"{int(cpu.dropped)} of {2 * x.shape[0] * x.shape[1]} "
                 f"(capacity {moe.capacity(cfg, x.shape[0] * x.shape[1])})")
        ok = rel_y <= 1e-5 and rel_aux <= 1e-5 and (
            dropless or int(card.dropped) == int(cpu.dropped))
        log(f"MoE block hidden {cfg.hidden_size} x {MOE_EXPERTS} experts "
            f"{mode}, card vs cpu (f32): y rel {rel_y:.3e}, aux rel "
            f"{rel_aux:.3e} (tol 1e-5){drops} {'ok' if ok else 'FAIL'}")
        check(ok, (mode, rel_y, rel_aux))
        if not dropless:
            check(int(card.dropped) > 0, "the block check dropped nothing")
            out["moe_block_drops"] = int(card.dropped)
    return out


def moe_serving_extras(pred) -> dict:
    """Phase 9's checks beyond phase 2's: float32 routers, the block check,
    and the device time of a chunk and a decode step on the MoE model."""
    routers = {n: p.dtype for n, p in pred.module.named_parameters()
               if ".moe.router." in n}
    n_moe = sum(1 for blk in pred.module.layers if blk.use_moe)
    log(f"phase 9: {n_moe} MoE layers x {MOE_EXPERTS} experts; router "
        f"parameters {sorted(set(map(str, routers.values())))}")
    check(len(routers) == 2 * n_moe and set(routers.values())
          == {torch.float32}, routers)
    out = check_moe_block()
    out.update(phase_profile(pred.module, "MoE "))
    return out


def phase_moe_training(fa) -> dict:
    """Phase 10: MoE Llama training through the worker entrypoint, the
    in-step check and the step profile; peak memory under 90%."""
    auxes: list = []

    def note_aux(module, args, output):
        if isinstance(output, dict) and "moe_aux" in output \
                and torch.is_grad_enabled():
            auxes.append(output["moe_aux"].detach())

    label = f"MoE Llama-7B-width x{MOE_LAYERS} layers"
    torch.cuda.reset_peak_memory_stats()
    handle = torch.nn.modules.module.register_module_forward_hook(note_aux)
    try:
        run = phase_training(fa, MOE_TRAIN_CONFIG, MOE_LAUNCHES, label)
    finally:
        handle.remove()
    values = [a.item() for a in auxes]
    log(f"{label} moe_aux per step: {' '.join(f'{a:.4f}' for a in values)}")
    check(len(values) == MOE_TRAIN_STEPS
          and all(math.isfinite(a) and a > 0 for a in values), values)
    free_memory()
    check_training_step(fa, MOE_TRAIN_CONFIG, MOE_LAUNCHES, label)
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"MoE phase peak memory (max_memory_allocated over the counted run "
        f"and its checks): {peak / 1e9:.2f} GB, {100 * peak / card:.1f}% of "
        f"the card's {card / 1e9:.2f} GB")
    check(peak < 0.9 * card, "MoE training peak memory over 90% of the card")
    return {**run, "moe_aux": values, "peak_gb": peak / 1e9,
            "peak_share": peak / card}


def phase_gemma_serving(fa) -> dict:
    """Phase 15: phase 2 on the Llama at Gemma-2B's widths (head_dim 256,
    multi-query), K1 at D = 256 in every prefill chunk."""
    t0 = time.perf_counter()
    out = phase_serving(fa, GEMMA2B_WIDTHS, GEMMA_LABEL)
    log(f"phase 15 ({GEMMA_LABEL}): {time.perf_counter() - t0:.1f}s")
    return out


def phase_gemma_training(fa) -> dict:
    """Phase 16: the Llama at Gemma-2B's widths and full depth through the
    worker entrypoint (K1 36, K2 and K3 18 launches a step at D = 256),
    the in-step check and the step profile; peak memory under 90%."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = phase_training(fa, GEMMA_CONFIG, GEMMA_LAUNCHES, GEMMA_LABEL)
    free_memory()
    check_training_step(fa, GEMMA_CONFIG, GEMMA_LAUNCHES, GEMMA_LABEL)
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 16 peak memory (max_memory_allocated over the counted run "
        f"and its checks): {peak / 1e9:.2f} GB, {100 * peak / card:.1f}% of "
        f"the card's {card / 1e9:.2f} GB; {time.perf_counter() - t0:.1f}s")
    check(peak < 0.9 * card, "phase 16 peak memory over 90% of the card")
    free_memory()
    return {**run, "peak_gb": peak / 1e9, "peak_share": peak / card}


def gemma_numbers(fa, serving: dict | None, training: dict | None) -> dict:
    """K1's rows at phase 15's shapes and K1, K2 and K3's at phase 16's,
    with the launches of those runs (None: the phase did not run)."""
    out = {}
    if serving is not None:
        out["serving"] = phase_numbers(fa, gemma_path_shapes(),
                                       num_layers=GEMMA_LAYERS)
        check(serving["launches"]
              == sum(r["launches"] for r in out["serving"]),
              "phase 15 launches")
    if training is not None:
        out["training"] = training_numbers(fa, GEMMA_SHAPE,
                                           training["launches"],
                                           GEMMA_LAUNCHES)
    return out


def spec_prompts(vocab: int) -> list[list[int]]:
    """Phase 2's four prompts (the same seed) and one 64-token block
    repeated ``SPEC_REPEATS`` times."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]
    block = np.random.default_rng(11).integers(1, vocab, SPEC_BLOCK).tolist()
    return prompts + [block * SPEC_REPEATS]


def capture_rounds(engine, rounds: list) -> None:
    """Record each verify round of ``engine``: the rows, their generated
    lengths before and after the round, the verified tokens and the
    round's choices ``[s][B]``."""
    verify, step = engine._verify, engine._spec_step
    last: dict = {}

    def verify_and_note(reqs, toks):
        out = verify(reqs, toks)
        last["round"] = (toks, out[0])
        return out

    def step_and_note():
        reqs = list(engine.slots)
        before = [len(r.generated) if r else 0 for r in reqs]
        ran = step()
        if ran:
            after = [len(r.generated) if r else 0 for r in reqs]
            rounds.append((reqs, before, after, *last.pop("round")))
        return ran

    engine._verify, engine._spec_step = verify_and_note, step_and_note


def check_rounds(rounds: list) -> tuple[int, int]:
    """Every token a round kept is that round's own choice at its
    position, and every accepted draft token equals it; returns (rows
    checked, tokens kept)."""
    rows = kept = 0
    for reqs, before, after, toks, choices in rounds:
        for i, req in enumerate(reqs):
            if req is None:
                continue
            k = after[i] - before[i]
            start = len(req.ids) + before[i]
            col = [choices[j][i] for j in range(len(toks[i]))]
            stream = req.ids + req.generated
            check(k >= 1 and stream[start:start + k] == col[:k]
                  and toks[i][1:k] == col[:k - 1], ("round", i, k))
            rows += 1
            kept += k
    return rows, kept


def verify_vs_sequential(model, prompt: list[int], stream: list[int],
                         rows: int = 4) -> tuple[float, float]:
    """Verify forwards of ``s`` tokens (the prompt's first generated token
    and the ones after it) at index ``n`` against ``s`` sequential decode
    steps from the same cache, at the engine's shapes: ``rows`` rows (the
    engine's ``max_batch``; every row holds the prompt) and each ``s`` a
    verify round can have (gamma + 1 for gamma in the buckets 1, 2 and
    ``SPEC_TOKENS``).  Returns (max abs logit difference, max |sequential
    logit|) over them."""
    from kubeflow_tpu_torch.models import llama

    n = len(prompt)
    cache = llama.init_cache(model.config, rows, MAX_SEQ, per_sequence=True)
    diff = scale = 0.0
    with torch.no_grad():
        model(torch.tensor([prompt] * rows, device="cuda"), cache=cache)
        start = torch.full((rows,), n, device="cuda")
        for s in sorted({2, 3, SPEC_TOKENS + 1}):
            toks = torch.tensor([stream[n:n + s]] * rows, device="cuda")
            copy = {"layers": [dict(k=l["k"].clone(), v=l["v"].clone())
                               for l in cache["layers"]]}
            for layer in cache["layers"]:
                layer["index"] = start
            verify = model(toks, cache=cache)["logits"]
            steps = []
            for j in range(s):
                for layer in copy["layers"]:
                    layer["index"] = start + j
                steps.append(model(toks[:, j:j + 1], cache=copy)["logits"])
            seq = torch.cat(steps, dim=1)
            diff = max(diff, (verify - seq).abs().max().item())
            scale = max(scale, seq.abs().max().item())
            del copy
    return diff, scale


def top2_margins(model, stream: list[int], n: int) -> list[float]:
    """Top-1 minus top-2 logit at each generated position of ``stream``
    (prompt of ``n`` tokens), from one forward over the whole stream."""
    with torch.no_grad():
        logits = model(torch.tensor([stream[:-1]], device="cuda"))["logits"]
    top = logits[0, n - 1:].topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def serve_mode(engine, prompts, post_fn=None) -> dict:
    """The prompts one at a time (speculation's case: a stream decoding
    alone), SPEC_NEW greedy tokens each, through ``post_fn`` (one HTTP
    request) or the engine; the streams and the engine's deltas."""
    before = engine.stats()
    t0 = time.perf_counter()
    streams = [post_fn(p) if post_fn is not None
               else engine.submit(p, SPEC_NEW).result(timeout=600)
               for p in prompts]
    wall = time.perf_counter() - t0
    after = engine.stats()
    tb, ta = before["timing"], after["timing"]
    dec_s = ta["decode_seconds"] - tb["decode_seconds"]
    out = {"streams": streams, "wall_s": wall,
           "prefill_chunks": ta["prefill_chunks"] - tb["prefill_chunks"],
           "tok_per_s": len(prompts) * SPEC_NEW / wall,
           "decode_tok_per_s": ((ta["decode_tokens"] - tb["decode_tokens"])
                                / dec_s if dec_s else 0.0)}
    if "speculative" in after:
        sb, sa = before["speculative"], after["speculative"]
        out.update({k: sa[k] - sb[k] for k in ("rounds", "proposed",
                                                "accepted")})
        out["accept_rate"] = (out["accepted"] / out["proposed"]
                              if out["proposed"] else 0.0)
    return out


def oracle_drafter(streams: list[list[int]]):
    """A drafter that proposes the continuation of whichever of
    ``streams`` the tokens are a prefix of (the ceiling of speculation on
    this traffic: every draft is the stream without speculation)."""
    def draft(tokens, n):
        for st in streams:
            if len(st) > len(tokens) and st[:len(tokens)] == tokens:
                return st[len(tokens):len(tokens) + n]
        return []

    return draft


def draft_cache_bytes(draft) -> int:
    return sum(t.nbytes for cache, _ in draft._ctx.values()
               for l in cache["layers"] for t in (l["k"], l["v"]))


def phase_speculation(fa) -> dict:
    """Phase 11 (module docstring)."""
    from kubeflow_tpu_torch.serving.draft_model import DraftModel
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp)

    pred = GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                               prefill_chunk=PREFILL_CHUNK, max_batch=4,
                               seed=0, speculative_tokens=SPEC_TOKENS,
                               draft_layers=DRAFT_LAYERS)
    model, cfg, draft = pred.module, pred.cfg, pred.engine.draft_fn
    check(isinstance(draft, DraftModel), "the predictor built no drafter")
    m0 = torch.cuda.memory_allocated()
    probe = DraftModel(model, DRAFT_LAYERS)
    added = torch.cuda.memory_allocated() - m0
    shared = all(any(p is q for q in model.parameters())
                 for p in probe.model.parameters())
    del probe
    check(shared, "the drafter holds parameters of its own")
    off_streams: list = []         # the oracle drafts the off streams
    engines = {"draft": pred.engine}
    for m, kw in (("off", {}), ("ngram", {"speculative_tokens": SPEC_TOKENS}),
                  ("oracle", {"speculative_tokens": SPEC_TOKENS,
                              "draft_fn": oracle_drafter(off_streams)})):
        engines[m] = ContinuousBatcher(model, cfg, max_batch=4,
                                       max_seq=MAX_SEQ,
                                       prefill_chunk=PREFILL_CHUNK, **kw)
    httpd, thread = serve(PredictorApp({"llama": pred}), 0)

    def over_http(prompt):
        status, body = post(httpd.server_port, "/v1/models/llama:generate",
                            {"ids": [prompt], "max_new_tokens": SPEC_NEW})
        check(status == 200, (status, body))
        return body["ids"][0]

    forwards = [0]
    hook = draft.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    prompts = spec_prompts(cfg.vocab_size)
    rounds = {m: [] for m in SPEC_MODES[1:]}
    try:
        with torch.no_grad():
            # warm-up at the counted run's shapes, other prompts, off it
            warm = [np.random.default_rng(12).integers(
                1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS[:2]]
            saved = counters(fa)
            for eng in engines.values():
                eng.generate_sync(warm, max_new_tokens=16)
            set_counters(fa, saved)
            draft.reset()
            for m, rs in rounds.items():
                capture_rounds(engines[m], rs)
            shapes: list = []
            forwards[0] = 0
            saved = counters(fa)
            set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # path starts
            # one pass a mode, then the last prompt off again (its stream
            # must repeat).  The second pass of every mode (off's whole
            # second pass too) was cut to keep the whole run under half its
            # limit (PERF.md section 4)
            runs = {m: [] for m in SPEC_MODES}
            with flash_route(recording_flash(fa, shapes)):
                for m in SPEC_MODES:
                    runs[m].append(serve_mode(
                        engines[m], prompts,
                        over_http if m == "draft" else None))
                    if m == "off":
                        off_streams.extend(runs[m][0]["streams"])
                again = serve_mode(engines["off"], prompts[-1:])
            launches = counters(fa)                          # path ended
            set_counters(fa, {k: saved[k] + launches[k] for k in saved})
        chunks = again["prefill_chunks"] + sum(
            r["prefill_chunks"] for rs in runs.values() for r in rs)
        total = {m: {k: sum(r.get(k, 0) for r in rs)
                     for k in ("rounds", "proposed", "accepted")}
                 for m, rs in runs.items()}
        expect = cfg.num_layers * chunks + DRAFT_LAYERS * forwards[0]
        log(f"phase 11: flash_fwd launches {launches['flash_fwd']} (expected "
            f"{cfg.num_layers} x {chunks} prefill chunks + {DRAFT_LAYERS} x "
            f"{forwards[0]} drafter forwards = {expect})")
        check(launches == {"flash_fwd": expect, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}, launches)
        check(len(shapes) == expect, (len(shapes), expect))
        for m, rs in rounds.items():
            n_rows, kept = check_rounds(rs)
            log(f"  {m}: {len(rs)} verify rounds, {n_rows} row-rounds, "
                f"{kept} kept tokens, each the round's own choice")
            check(len(rs) == total[m]["rounds"], (m, len(rs)))
        # the costed drafter's exploration runs every 4th declined round,
        # so the draft model's path verifies whatever its accept rate; the
        # oracle's drafts are the off streams, so its rounds accept
        check(total["draft"]["rounds"] > 0, "no draft-model round ran")
        check(total["oracle"]["accepted"] > 0, "no oracle draft accepted")
        off = off_streams
        for i, (p, stream) in enumerate(zip(prompts, off)):
            check(len(stream) == len(p) + SPEC_NEW and stream[:len(p)] == p,
                  ("off stream", i))
        check(again["streams"] == off[-1:], "the off stream repeats")
        # verify logits against sequential decode, on the repeated prompt
        with torch.no_grad():
            diff, scale = verify_vs_sequential(model, prompts[-1], off[-1])
        rel = diff / scale
        log(f"verify forwards [4, 2|3|{SPEC_TOKENS + 1}] vs sequential "
            f"decode steps [4, 1]: max|d logits| {diff:.4f}, rel {rel:.3e} "
            f"(tol {VERIFY_REL_TOL:g})")
        check(rel <= VERIFY_REL_TOL, rel)
        saved = counters(fa)
        margins = [top2_margins(model, st, len(p))
                   for p, st in zip(prompts, off)]
        set_counters(fa, saved)
        same = {}
        for m, k in ((m, k) for m in SPEC_MODES[1:]
                     for k in range(len(runs[m]))):
            same[m] = same.get(m, 0)
            for i, (p, ref, got, mg) in enumerate(zip(
                    prompts, off, runs[m][k]["streams"], margins)):
                n = len(p)
                first = next((g for g, x in enumerate(mg) if x < 2 * diff),
                             SPEC_NEW)
                differ = next((g for g in range(SPEC_NEW)
                               if got[n + g] != ref[n + g]), None)
                same[m] += differ is None
                where = ("identical to the off stream" if differ is None
                         else f"first differs at generated position "
                         f"{differ}, where the margin is {mg[differ]:.4f}")
                log(f"  {m} pass {k + 1} prompt {i} ({n} tokens): first "
                    f"top-1/top-2 margin under {2 * diff:.4f} at generated "
                    f"position {first}; {where}")
                check(differ is None or differ >= first,
                      (m, i, "stream before the first small margin", first))
        log(f"  {card_line()}")
        for m in SPEC_MODES:
            t = total[m]
            t["accept_rate"] = (t["accepted"] / t["proposed"]
                                if t["proposed"] else 0.0)
            spec = ("" if m == "off" else
                    f"rounds {t['rounds']}, proposed {t['proposed']}, "
                    f"accepted {t['accepted']}, accept rate "
                    f"{t['accept_rate']:.3f}; ")
            rates = " and ".join(
                f"{r['tok_per_s']:.2f} ({r['wall_s']:.2f} s wall; decode "
                f"{r['decode_tok_per_s']:.2f})" for r in runs[m])
            passes = " and ".join(str(k + 1) for k in range(len(runs[m])))
            n = len(runs[m]) * len(prompts)
            log(f"phase 11 {m}: {spec}tok/s over the {len(prompts)} requests "
                f"one at a time, pass{'es' if len(runs[m]) > 1 else ''} "
                f"{passes}: {rates}; streams identical to off "
                f"{same.get(m, n)} of {n}")
        cache_bytes = draft_cache_bytes(draft)
        log(f"draft model: {DRAFT_LAYERS} of {cfg.num_layers} layers, "
            f"parameters shared with the target; memory added by building "
            f"one {added} bytes; its {len(draft._ctx)} cached contexts "
            f"{cache_bytes / 2**20:.1f} MiB")
    finally:
        hook.remove()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        pred.stop(timeout=60)
        for m, eng in engines.items():
            if m != "draft":
                eng.shutdown()
    return {"launches": launches["flash_fwd"], "shapes": shapes,
            "draft_added_bytes": added, "draft_cache_bytes": cache_bytes,
            **{m: {**total[m], "tok_per_s": [r["tok_per_s"] for r in rs]}
               for m, rs in runs.items()}}


def recording_flash(fa, shapes: list):
    """A stand-in for ``flash_attention`` that launches the kernel through
    its wrapper (which counts the launch) and records each call's
    (B, Sq, Sk, H, Hkv, D, causal)."""
    def recorded(q, k, v, *, causal=False):
        shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       k.shape[2], q.shape[3], causal))
        return fa.flash_attention(q, k, v, causal=causal)

    return recorded


# k1_times by shape: phases 2, 7, 11 and 14 share most of their prefill
# shapes, each timed once (the whole run's numbers took ~38 s)
K1_TIMES: dict[tuple, tuple[float, float, float]] = {}


def k1_times(fa, b, sq, sk, h, hkv, d, causal) -> tuple[float, float, float]:
    """(kernel, plain version, SDPA) ms of K1 at one bf16 shape, measured
    once per shape in a run (``K1_TIMES``); the launches made here are not
    counted."""
    key = (b, sq, sk, h, hkv, d, causal)
    if key not in K1_TIMES:
        K1_TIMES[key] = _k1_times(fa, *key)
    return K1_TIMES[key]


def _k1_times(fa, b, sq, sk, h, hkv, d, causal) -> tuple[float, float, float]:
    from torch.nn.attention.bias import causal_lower_right
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, k, v = make_qkv(b, sq, sk, h, hkv, d, torch.bfloat16, seed=11)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = causal_lower_right(sq, sk) if causal else None
    saved = counters(fa)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    set_counters(fa, saved)                      # timing is not the path
    plain_ms = time_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=causal))
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                      enable_gqa=h != hkv))
    return ms, plain_ms, library_ms


def spec_numbers(fa, shapes: list) -> list[dict]:
    """K1 rows of phase 11's counted run: launches grouped by (Sq, Sk),
    with the drafter's short calls (Sq <= 16) grouped at Sk rounded up to
    a multiple of 256 and timed there; bounds from each call's shape."""
    groups: dict[tuple[int, int], list] = {}
    for _, sq, sk, _, _, _, causal in shapes:
        check(causal, "phase 11 runs K1 causal only")
        key = (sq, sk if sq > 16 else min(-(-sk // 256) * 256, MAX_SEQ))
        groups.setdefault(key, []).append(sk)
    rows = []
    for (sq, sk_t), sks in sorted(groups.items()):
        ms, plain_ms, library_ms = k1_times(fa, 1, sq, sk_t, 32, 32, 128,
                                            True)
        bounds = {}
        for sk in set(sks):
            bounds[sk] = flash_bound("flash_fwd", 1, sq, sk, 32, 32, 128,
                                     True, torch.bfloat16)
        bytes_ms = sum(bounds[sk][0] for sk in sks) / len(sks)
        ops_ms = sum(bounds[sk][1] for sk in sks) / len(sks)
        bound = sum(max(bounds[sk]) for sk in sks) / len(sks)
        row = {"shape": f"7b_spec_{sq}x{sk_t}", "launches": len(sks),
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes_ms": bytes_ms, "operations_ms": ops_ms}
        log(f"flash_fwd {row['shape']} bf16 (x{len(sks)} in phase 11, Sk "
            f"{min(sks)}-{max(sks)}): kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms")
        rows.append(row)
    return rows


def with_launches(row: dict, launches: int, label: str) -> dict:
    """``row``'s shape and times, carrying another path's launches."""
    return {**row, "shape": f"{row['shape']} ({label})", "launches": launches}


def phase_vision(fa) -> dict:
    """Phase 6: ``VISION_RUNS`` through the worker entrypoint (no flash
    kernel: every step must launch none), then one ResNet-50 adamw step by
    operator."""
    results = {}
    for model, steps in VISION_RUNS:
        config = {"model": model, "model_config": {},
                  "global_batch": VISION_BATCH, "steps": steps,
                  "log_every": 1, "seed": 0, "prefetch": 2,
                  "optimizer": {"name": "adamw", "learning_rate": 1e-3}}
        results[model] = phase_training(
            fa, config, dict.fromkeys(KERNEL_NAMES, 0), model)
        free_memory()
    model, state, step, batch = build_training(config, config["optimizer"])
    profile_step(f"ResNet-50 adamw train step {list(batch['image'].shape)}",
                 state, step, batch)
    del model, state, step, batch
    free_memory()
    return results


# -- phases 17-20: gangs of processes on the card ---------------------------

# Every 2-rank layout of phases 17-20 runs in ONE gang of GANG_RANKS
# processes from spawn_local_gang on this card (gloo: NCCL refuses two
# ranks on one device), one section after the other, and phase 18's
# fsdp=2 x tp=2 in a gang of 4.  Each spawn paid ~9 s of imports and
# CUDA start-up and ~15-19 s more before its first step (the flash
# library's load, cuBLAS handles, gloo's first connections): three gangs
# of 2 became one to keep the whole run under half its limit (PERF.md
# section 4).  Each phase's one-process reference runs in this process
# first (its CUDA start-up is paid already).
# the gang of 2 (start-up and every section) must end in this
GANG_TIMEOUT_S = 900.0
# the gang against one process, relative, every step: the same rows and
# weights, but each rank's bf16 GEMMs and convolutions run at half the
# rows (other cuBLAS and cuDNN kernels, other rounding) and the gradients
# are summed in another order; as STEP_TOL, 24 random-weight bf16 layers
# amplify rounding-level differences (measured on an H100: BERT-large
# 2.5e-5 on the loss and 1.3e-3 on grad_norm over 5 steps, ResNet-50
# 3.1e-5 and 9.9e-5 over 3)
GANG_TOL = STEP_TOL

# -- phase 17: data-parallel training ---------------------------------------

# (a) phase 4's BERT-large and optimizer at global batch 24 x 512 for
# GANG_BERT's steps, from an .npz made from the seed; (b) ResNet-50 at
# 224 x 224, global batch 128, GANG_RESNET's steps of the ImageNet
# recipe's momentum sgd (lr 0.1 x 128 / 256), its BatchNorms on the
# gang's global statistics.  Each runs
# through the worker entrypoint as one process (this one) and in the gang
# of 2.  (c) The Trainer on BERT-large under RESIZE_SCHEDULE.
# BERT-large's steps cut from 5 to 2 (~1.75 s each in the gang, 86%
# all-reduce) and ResNet-50's from 3 to 2 when phase 20 grew; samples/s of
# step 2, as phases 18-20 take it
GANG_BERT = {**TRAIN_CONFIG, "steps": 2}
GANG_RESNET = {"model": "resnet50", "model_config": {},
               "global_batch": VISION_BATCH, "steps": 2, "log_every": 1,
               "seed": 0, "optimizer": {"name": "sgd", "learning_rate": 0.05,
                                        "momentum": 0.9}}
# (c)'s membership schedule, the reference test's (world 2 -> 1 at step 6
# of 12) cut to a third of its steps when phase 20 grew: one resize all
# the same
RESIZE_STEPS, RESIZE_AT = 4, 2
RESIZE_SCHEDULE = {0: (0, (0, 1)),                 # step: (epoch, members)
                   RESIZE_AT: (1, (0,))}

# -- phase 18: fsdp and tp training -----------------------------------------

# Llama at Llama-2-7B's width (phase 5's model_config) cut to MESH_LAYERS of
# its 32 layers: the gangs' gathers and reduce-scatters cross host memory
# through gloo (a layer's float32 weights alone are ~0.8 GB); global batch
# 8 x 512, MESH_STEPS adamw steps from an .npz made from the seed, through
# the worker entrypoint as one process and as gangs on each layout below.
# Steps cut from 3 to 2 to keep the whole run under half its limit (the
# phase took 118.7 s of a 628.0 s run on an H100 at 3 steps, and about
# 15 s of each spawn is start-up); the last layout's checkpoint is the
# save at its end, which one process restores: every parameter bitwise
# the gang's gathered one (SHA-256 of each tensor's bytes)
MESH_LAYERS, MESH_STEPS = 2, 2
MESH_CONFIG = {"model": "llama",
               "model_config": {"size": "7b", "num_layers": MESH_LAYERS},
               "global_batch": MESH_BATCH, "steps": MESH_STEPS,
               "log_every": 1, "seed": 0,
               "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
MESH_LAUNCHES = {"flash_fwd": 2 * MESH_LAYERS, "flash_bwd_dq": MESH_LAYERS,
                 "flash_bwd_dkv": MESH_LAYERS}
# each layout is held to one process by gang_compare within GANG_TOL (the
# rows and heads of each rank's bf16 GEMMs differ, the row-parallel
# products are summed over tp in bf16, gradients in another order)

# -- phase 19: sequence and pipeline parallelism ----------------------------

# (b): phase 18's model at SP_LAYERS layers, a global batch of SP_BATCH rows
# of SP_SEQ tokens, SP_STEPS adamw steps from an .npz made from seed 0,
# through the worker entrypoint as one process (here) and with sp = 2 (each
# rank holds SP_SEQ / 2 tokens of every row; ring attention joins them)
SP_CONFIG = {"model": "llama",
             "model_config": {"size": "7b", "num_layers": SP_LAYERS},
             "global_batch": SP_BATCH, "steps": SP_STEPS, "log_every": 1,
             "seed": 0,
             "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
SP_ONE_LAUNCHES = {"flash_fwd": 2 * SP_LAYERS, "flash_bwd_dq": SP_LAYERS,
                   "flash_bwd_dkv": SP_LAYERS}
# (c): the pipeline's output against the blocks in sequence, relative to max
# |out| (the bf16 whole-model bound, LOGITS_REL_TOL's reasoning: the
# microbatches' bf16 GEMMs run at a quarter of the rows), and its stage
# gradients within BWD_TOL's bf16 bound of max |ref|
PP_OUT_REL_TOL = 1e-1

# -- phase 20: MoE training under dp and ep ---------------------------------

# phase 10's MoE Llama at Llama-2-7B's width (8 GELU experts, top-2, on every
# second layer: Mixtral's routing, arXiv:2401.04088) cut to MOE_EP_LAYERS of
# its 32 layers (layer 0 MoE, layer 1 dense), global batch 8 x 512,
# MOE_EP_STEPS adamw steps from an .npz made from seed 0: one process (here,
# build_train_step), then in the gang of 2 dp = 2 through the worker
# entrypoint and ep = 2 (4 experts a rank; the reference's Trainer has no ep
# axis, so build_train_step on make_mesh(dp=1, ep=2)).  All three see the
# global batch a gang of 2 assembles: each rank's strided NpzDataset rows,
# rank-major, as the reference's make_array_from_process_local_data
# assembles them; capacity priority follows that order (one process in
# the file's order keeps another set: 7.4e-05 of the loss apart on an
# H100).  Each rank's K1-K3 shapes are phase 18's (dp = 2: fsdp=2's 4
# rows; ep = 2: all 8 rows)
MOE_EP_LAYERS, MOE_EP_STEPS = 2, 2
MOE_EP_CONFIG = {"model": "llama",
                 "model_config": {"size": "7b", "num_layers": MOE_EP_LAYERS,
                                  "moe_experts": MOE_EXPERTS},
                 "global_batch": MESH_BATCH, "steps": MOE_EP_STEPS,
                 "log_every": 1, "seed": 0,
                 "optimizer": {"name": "adamw", "learning_rate": 1e-4}}
MOE_EP_LAUNCHES = {"flash_fwd": 2 * MOE_EP_LAYERS,
                   "flash_bwd_dq": MOE_EP_LAYERS,
                   "flash_bwd_dkv": MOE_EP_LAYERS}
# lamb's run: at lr 5e-3 two steps move each tensor by ~1e-2 of its norm,
# as two adamw steps at 1e-4 move these weights (MOE_EP_EXPERT_TOL's teeth)
MOE_LAMB = {"name": "lamb", "learning_rate": 5e-3, "weight_decay": 0.01}
# (label, data ranks) and each layout's rank shape (phase 18's); the
# layouts past dp = 2 run build_train_step on make_mesh(dp=1, **axes)
# with their optimizer, against the one-process run with it
MOE_EP_LAYOUTS = (("one process", 1), ("dp=2", 2), ("ep=2", 1),
                  ("tp=2", 1), ("sp=2", 1), ("tp=2 lamb", 1))
MOE_EP_MESHES = {"ep=2": ({"ep": 2}, "adamw"), "tp=2": ({"tp": 2}, "adamw"),
                 "sp=2": ({"sp": 2}, "adamw"),
                 "tp=2 lamb": ({"tp": 2}, "lamb")}
MOE_EP_SHAPES = {label: mesh_shape(dp, 2 if label.startswith("tp") else 1)
                 for label, dp in MOE_EP_LAYOUTS}
MOE_EP_SHAPES["one process lamb"] = MOE_EP_SHAPES["one process"]
# sp = 2: each rank's ring blocks of 8 rows x 256 tokens, the diagonal one
# (causal) and on rank 1 the earlier one (fully visible)
MOE_SP_SHAPES = [
    ("llama7b_sp_moe_block_diagonal", MESH_BATCH, LLAMA_SEQ // 2,
     LLAMA_SEQ // 2, 32, 32, 128, True),
    ("llama7b_sp_moe_block_earlier", MESH_BATCH, LLAMA_SEQ // 2,
     LLAMA_SEQ // 2, 32, 32, 128, False)]
# ep's expert blocks after the last step against one process's rows of the
# same experts: ||w_ep - w_one|| / ||w_one|| within the loss's GANG_TOL (two
# adamw steps move the weights by ~1e-2 of their norm, so a wrong block or
# a missing update is that far off, while adam's lr-sized steps on gradient
# elements that round to the other sign stay far below it)
MOE_EP_EXPERT_TOL = GANG_TOL["loss"]
# tp's expert columns after the last step against one process's, by the
# norm of one process's update of them (||w_tp - w_one|| / ||w_one -
# w_0||): tp's bf16 partial sums route some near-tie (token, choice)
# assignments to another expert at step 1 (29 of 8192 on an H100 80GB
# HBM3, counted by the phase), which moves those experts' gradients, and
# adam's sign-like first steps turn the elements whose sign flipped into
# lr-sized differences (4.6e-03 of ||w|| there, with 2.8 M elements of
# w_in apart by more than lr/2: 0.164 of the update's norm with adamw,
# 0.131 with lamb).  A missing update is 1, a wrong block ~40 (the blocks
# differ by ~sqrt(2) ||w||)
MOE_TP_EXPERT_TOL = 0.3

# -- phase 21: multi-host serving --------------------------------------------

# phase 2's Llama-2-7B (bf16, random weights from seed 0) at
# MH_SHALLOW_LAYERS layers (phase 22 carries tp at full depth), max_seq
# MAX_SEQ, through MultiHostPredictor: one process (here), tp = 2 in the
# gang of 2 and dp = 2 x tp = 2 in phase 18's gang of 4.  Traffic: 4
# prompts that pad to one bucket of MH_PAD positions, MH_NEW greedy tokens
# each, held by rank 0 alone and broadcast (a chat service whose model is
# sharded over cards).  (d): int8 weights at tp = 2
MH_PROMPT_LENS, MH_NEW, MH_PAD = (17, 128, 300, 500), 16, 512
MH_LAYOUTS = (("one process", 1, 1), ("tp=2", 1, 2), ("dp=2 x tp=2", 2, 2))
MH_SHALLOW_LAYERS = MESH_LAYERS
# (label, its one-process reference, int8 weights) of the further layouts:
# one process here, tp = 2 in the gang of 2
MH_SHALLOW = (("int8 tp=2", "int8 one process", True),)
# each rank's memory after loading over one process's weight bytes: a tp=2
# rank holds half of every matmul weight and of the embedding, the norms
# whole (0.5000 of the bytes and a little)
MH_WEIGHT_SHARE = 0.55
# prefill logits against one process's, relative to max |logit|: the rank's
# GEMMs run at other shapes and the row-parallel products are summed over
# tp in bf16; 32 random-weight bf16 layers amplify such rounding
# (LOGITS_REL_TOL's reasoning)
MH_LOGITS_REL_TOL = 1e-1
# the same at MH_SHALLOW_LAYERS layers, where little amplifies the rounding:
# about 3x the gaps an H100 showed there (tp = 2 9.432e-03 of max |logit|
# in bf16, 9.491e-03 in int8); the int8 layout's every token is held to one
# process's (the bf16 one's 300-token row is a near-tie there: a top-2
# margin of 5.1e-03).  The bf16 tp layouts are held bitwise to one process
# under tp2_partial_sums (what an H100 showed for tp = 2 at 2 and 32 layers
# and dp = 2 x tp = 2: the tp split changes the logits only by those sums)
MH_SHALLOW_REL_TOL = 3e-2


def mh_shape(dp: int, tp: int) -> tuple:
    """K1's shape on a rank of the (dp, tp) layout: its rows and heads."""
    return (f"7b_multihost_rank_dp{dp}_tp{tp}", len(MH_PROMPT_LENS) // dp,
            MH_PAD, MH_PAD, 32 // tp, 32 // tp, 128, True)


MH_SHAPES = [mh_shape(dp, tp) for _, dp, tp in MH_LAYOUTS]

# -- phase 22: the predictor's tp= and ep= ------------------------------------

# (a) phase 2's Llama-2-7B (32 layers, bf16, seed 0) behind
# GenerativePredictor(tp=2) in the gang of 2: rank 0 serves HTTP, the
# follower replays its step records.  Traffic: phase 2's four concurrent
# prompts (PROMPT_LENS, greedy, NEW_TOKENS each), then the 700-token one
# again (a prefix hit of all but its last token).  The same at
# MH_SHALLOW_LAYERS layers, held bitwise to one process under
# tp2_partial_sums.  (b) phase 9's MoE (MOE_EXPERTS GELU experts, top-2,
# every second layer) at 7B width, cut to MH_SHALLOW_LAYERS layers: ep=2 in
# the gang of 2, tp=2 x ep=2 in the gang of 4, four prompts of
# P22_MOE_LENS tokens.  A chat service whose model is sharded over cards
P22_CACHE_MB = PC_CACHE_MB          # 256 pages: the whole traffic fits
P22_HEADS, P22_VOCAB = (32, 32, 128), 32000      # H, Hkv, D of the 7B
P22_WARM = 2                                   # index of the re-sent prompt
P22_MOE_LENS = (17, 128, 300, 500)
P22_LAYOUTS = (  # label, tp, ep, layers, MoE, HTTP
    ("tp=2", 2, 1, None, False, True),
    ("2-layer tp=2", 2, 1, MH_SHALLOW_LAYERS, False, False),
    ("MoE ep=2", 1, 2, MH_SHALLOW_LAYERS, True, False),
    ("MoE tp=2 x ep=2", 2, 2, MH_SHALLOW_LAYERS, True, False))
# the one-process references run here: phase 2's engine for tp=2 (its
# first-token logits), and these at MH_SHALLOW_LAYERS layers
P22_ONE = {"2-layer tp=2": "2-layer one process (tp2_partial_sums)",
           "MoE ep=2": "MoE one process", "MoE tp=2 x ep=2": "MoE one process"}
# first-token logits against one process's, relative to max |logit|:
# tp=2 at 32 layers as phase 21's (MH_LOGITS_REL_TOL: the row-parallel
# bf16 partial sums, amplified by 32 random-weight layers); tp=2 x ep=2 at
# 2 layers as phase 21's shallow layouts (MH_SHALLOW_REL_TOL), the
# experts' float32 partial sums adding ~1e-7 (a routing flip at the read
# position would exceed it: ROADMAP queue C item 7)
P22_REL_TOL = {"tp=2": MH_LOGITS_REL_TOL,
               "MoE tp=2 x ep=2": MH_SHALLOW_REL_TOL}
# (c) residency in the gang of 2: a (the dense Llama at tp=2) and b (the
# MoE at ep=2), both at MH_SHALLOW_LAYERS layers, under one weight budget
# between the larger model's whole bytes and their sum, served over HTTP
# from rank 0's ModelPool.  An operator packing several sharded models
# onto one slice, and scale-from-zero warm starts.  a's prefix cache:
# P22_RES_CACHE_MB (128 pages of 0.5 MiB); its prompts are phase 2's
# P22_RES_A (cold), b's the MoE layouts' first
P22_RES_CACHE_MB = 64
P22_RES_A = (0, 2)                  # indices into PROMPT_LENS: 17, 700
# each rank's memory falls at a park by at least this share of its blocks
P22_RES_PARK_SHARE = 0.9
# (d) disaggregated prefill and decode in the gang of 2: the 2-layer dense
# model as a prefill-role and a decode-role tp=2 predictor (a group each);
# phase 2's four prompts prefilled on the prefill gang and handed to the
# decode gang through the prefill's handoff_post seam (rank 0 to rank 0,
# the body's JSON round trip standing for the POST), then one prompt with
# no decode peer (it resumes on the prefill gang).  A service that puts a
# sharded model's prefill and decode on cards of their own.  And the MoE
# in int8 at ep=2 through one colocated request of P22_MOE_LENS[0]
# tokens, against one process's int8 MoE (its expert blocks cut in
# P22_INT8_EP)
P22_NO_PEER = 0                                # index into PROMPT_LENS
P22_INT8_EP = 2


def p22_chunks(layout: str) -> list[tuple[int, int]]:
    """(Sq, Sk) of every K1 call per layer of a phase 22 layout's traffic:
    its prompts' chunks, and for the dense layouts the re-sent prompt's
    one-token warm suffix."""
    if layout.startswith("MoE"):
        return [s for n in P22_MOE_LENS for s in chunk_shapes(n)]
    n = PROMPT_LENS[P22_WARM]
    return prefill_shapes() + chunk_shapes(n, n - 1)


def p22_shapes(layout: str, tp: int) -> list[tuple]:
    """A phase 22 layout's distinct K1 shapes at the rank's heads
    (``path_shapes``)."""
    slug = re.sub(r"\W+", "_", layout).strip("_").lower()
    h, hkv, d = P22_HEADS
    return path_shapes(p22_chunks(layout), f"predictor_{slug}",
                       heads=(h // tp, hkv // tp, d))


def p22_all_shapes() -> list[tuple]:
    """Phase 22's distinct K1 shapes (phase 1 holds K1 at each)."""
    seen: dict[tuple, tuple] = {}
    for label, tp, *_ in P22_LAYOUTS:
        for s in p22_shapes(label, tp):
            seen.setdefault(s[1:8], s[:8])
    return list(seen.values())

GANG_WORKER = r"""
import os, time
T0 = float(os.environ["GANG_SPAWNED"])
import dataclasses, gc, hashlib, json
import torch
import torch.distributed as dist
from torch.func import functional_call
from kubeflow_tpu_torch.models import llama, registry
from kubeflow_tpu_torch.models import moe as tmoe
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import ring_attention as ring
from kubeflow_tpu_torch.parallel import distributed as pd
from kubeflow_tpu_torch.parallel import pipeline as pipe
from kubeflow_tpu_torch.parallel import sharding as sh
from kubeflow_tpu_torch.parallel import train_step as ts
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.training import __main__ as worker
from kubeflow_tpu_torch.training.data import NpzDataset, to_device
from kubeflow_tpu_torch.training.optim import make_optimizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
spec = json.loads(os.environ["GANG_SPEC"])
KERNELS = {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv}
comm, trail, dropped, digests, stamps, snaps, peaks = ({}, [], [], {}, [],
                                                       [], [])


def timed(kind, fn, nbytes):
    # the call alone, from an idle card to its result on the card
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec = comm.setdefault(kind, {"s": 0.0, "bytes": 0, "calls": 0})
        rec["s"] += time.perf_counter() - t0
        rec["bytes"] += nbytes(*args)
        rec["calls"] += 1
        return out
    return call


def size(t):
    return t.numel() * t.element_size()


dist.all_reduce = timed("all_reduce", dist.all_reduce,
                        lambda t, *a: size(t))
dist.all_gather_into_tensor = timed(
    "all_gather", dist.all_gather_into_tensor, lambda out, x, *a: size(out))
dist.reduce_scatter_tensor = timed(
    "reduce_scatter", dist.reduce_scatter_tensor, lambda out, x, *a: size(x))
# the bytes this rank sends (and receives) in a neighbour exchange
pd.ppermute = timed("exchange", pd.ppermute,
                    lambda tensors, *a: sum(size(t) for t in tensors))
_full_state_dict = sh.full_state_dict


def full_state_dict(model):
    # the checkpoint's own gather: what rank 0's file must hold
    full = _full_state_dict(model)
    if dist.get_rank() == 0:
        digests.update({k: hashlib.sha256(v.cpu().contiguous().view(
            torch.uint8).numpy()).hexdigest() for k, v in full.items()})
    return full


sh.full_state_dict = full_state_dict
_build_step = ts.build_train_step


def build_step(*args, **kwargs):
    step = _build_step(*args, **kwargs)

    def recorded(state, batch):
        state, m = step(state, batch)
        trail.append((m["loss"], m["grad_norm"]))
        if getattr(getattr(state.model, "config", None), "moe_experts", 0):
            dropped.append([blk.moe.dropped for blk in state.model.layers
                            if blk.use_moe])
        return state, m

    return recorded


ts.build_train_step = build_step


def logged(step=None, rec=None):
    # the sync that logs a step (the Trainer's metrics hook)
    stamps.append(time.time() - T0)
    snaps.append(json.loads(json.dumps(comm)))
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)


def launched():
    return {n: k.launches for n, k in KERNELS.items()}


def job(run):
    # one path: counts set to 0 just before it, read just after
    for kept in (comm, trail, dropped, digests, stamps, snaps, peaks):
        kept.clear()
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS.values():
        kernel.launches = 0                          # the path starts
    start = time.time() - T0
    rc, extra = run()
    launches = launched()                            # it ended
    out = {"rc": rc, "launches": launches,
           "trail": [[float(loss), float(norm)] for loss, norm in trail],
           "dropped": [[int(d) for d in step] for step in dropped],
           "stamps": list(stamps), "snaps": list(snaps),
           "peaks": list(peaks), "comm": json.loads(json.dumps(comm)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "digests": dict(digests), "extra": extra,
           "times": {"start": start, "ended": time.time() - T0}}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def trainer(config):
    def run():
        os.environ["JAXJOB_TRAINER_CONFIG"] = json.dumps(config)
        return worker.main(["--device", "cuda"], metrics_hook=logged), None
    return run


def rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def ring_check(sp):
    # (a) the ring at this rank's chunk, against the plain ring on it
    mesh = make_mesh(dp=1, sp=sp["sp"])
    group = mesh.group("sp")
    rank = dist.get_rank()
    b, s, h, d = sp["block"]
    g = torch.Generator(device="cuda").manual_seed(190 + rank)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ring.ring_attention(q, k, v, group=group, causal=True)
    got = [o.detach(), *torch.autograd.grad(o, (q, k, v), do)]
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    exchange = dict(comm.get("exchange", {}))
    launches = launched()           # the check's own, before the plain ring
    ref = ring.ring_attention_reference(q, k, v, group=group, causal=True)
    want = [ref.detach(), *torch.autograd.grad(ref, (q, k, v), do)]
    with torch.no_grad():   # P|V|: the plain ring of |V|, the same weights
        pv = ring.ring_attention_reference(q, k, v.abs(), group=group,
                                           causal=True).float()
    allow = 2 ** -7 * (want[0].float().abs() + pv)
    return 0, {"launches": launches, "s": ring_s, "exchange": exchange,
               "o_ratio": ((got[0].float() - want[0].float()).abs()
                           / allow).max().item(),
               "grad_rel": [rel(a, w) for a, w in zip(got[1:], want[1:])]}


def pipeline_check(sp):
    # (c) pp = 2: the blocks of a model at that width, 2 per stage,
    # pipelined, against all of them in sequence on this rank
    pmesh = make_mesh(dp=1, pp=sp["sp"])
    cfg = dataclasses.replace(llama.llama2_7b(), num_layers=sp["pp_blocks"])
    model = llama.LlamaModel(cfg, device="cuda").init_weights(0)
    blocks = list(model.layers)
    stacked = pipe.stack_layer_params([
        {k: v.detach() for k, v in blk.named_parameters()} for blk in blocks])
    template = blocks[0]
    del model, blocks
    g = torch.Generator(device="cuda").manual_seed(191)
    x = torch.randn(sp["pp_batch"], sp["pp_seq"], cfg.hidden_size,
                    generator=g, device="cuda").to(torch.bfloat16)

    def block(layer, h):
        positions = torch.arange(h.shape[1], device="cuda")[None].expand(
            h.shape[0], -1)
        return functional_call(template, layer, (h, positions))[0]

    mine = {k: v.clone().requires_grad_() for k, v in
            pipe.stage_slice(stacked, pmesh).items()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipe.pipeline_forward(block, mine, x, mesh=pmesh,
                              num_microbatches=sp["pp_micro"])
    grads = torch.autograd.grad(y.float().pow(2).mean(), list(mine.values()))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = launched()        # the path's own, before the blocks in turn
    pp_comm = json.loads(json.dumps(comm))
    full = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    h = x
    for i in range(sp["pp_blocks"]):
        h = block({k: v[i] for k, v in full.items()}, h)
    ref_grads = dict(zip(full, torch.autograd.grad(h.float().pow(2).mean(),
                                                   list(full.values()))))
    ref_mine = pipe.stage_slice(ref_grads, pmesh)
    return 0, {"launches": launches, "s": pipe_s, "comm": pp_comm,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "out_rel": rel(y, h),
               "grad_rel": max(rel(a, ref_mine[k])
                               for k, a in zip(mine, grads))}


def moe_layout(moe, layout):
    # one layout of phase 20 through build_train_step on the global batch
    # one process sees; then this rank's expert blocks (split over ep or
    # tp) against one process's rows or columns of them
    config = moe["config"]
    axes, optimizer = layout["axes"], layout["optimizer"]
    mesh = make_mesh(dp=1, **axes)
    entry = registry.get(config["model"])
    model = entry.make_model(**config["model_config"],
                             device=torch.device("cuda"))
    model.init_weights(config["seed"])
    sh.shard_model(model, mesh)
    state = ts.init_train_state(model, make_optimizer(optimizer))
    step = ts.build_train_step(
        entry.forward_loss, state.tx, mesh, loss_weight=entry.loss_weight,
        sequence_keys=entry.sequence_keys if axes.get("sp", 1) > 1 else ())
    # the global batch a data-parallel gang of moe["ranks"] assembles: its
    # ranks' rows, rank-major (each rank's NpzDataset shard)
    shards = [NpzDataset(config["data_path"], config["global_batch"],
                         seed=config["seed"], process_index=r,
                         process_count=moe["ranks"]).iter_from(0)
              for r in range(moe["ranks"])]
    # the expert blocks as initialised, for the size of each update
    start = {name: p.detach().clone() for name, p in model.named_parameters()
             if name.endswith(("moe.w_in", "moe.w_out"))}
    # step 1's routing: each MoE layer's router logits of its forward
    routed = []
    hooks = [blk.moe.router.register_forward_hook(
        lambda mod, args, logits: routed.append(logits.detach()))
        for blk in model.layers if blk.use_moe]
    for i in range(config["steps"]):
        rows = [next(shard) for shard in shards]
        batch = {k: torch.cat([torch.as_tensor(r[k]) for r in rows])
                 for k in rows[0]}
        state, m = step(state, to_device(batch, torch.device("cuda")))
        float(m["loss"])
        logged(i + 1)
        for hook in hooks if i == 0 else ():
            hook.remove()
    # (token, choice) assignments of this rank's tokens routed to another
    # expert than one process routed them at step 1, per MoE layer
    n = routed[0].shape[1]
    cols = slice(mesh.coordinate("sp") * n, (mesh.coordinate("sp") + 1) * n)
    flips = [int((tmoe.route(torch.softmax(logits.float(), -1))[1].cpu()
                  != want[:, cols]).sum())
             for logits, want in zip(routed, torch.load(
                 layout["routing"], weights_only=True))]
    one = torch.load(layout["experts"], mmap=True, weights_only=True)
    out = {}
    for name, p in model.named_parameters():
        splits = [s for s in (getattr(p, "ep_split", None),
                              getattr(p, "tp_split", None)) if s is not None]
        if name not in one or not splits:
            continue
        want = sh.local_block(one[name], p).to(p.device)
        diff = (p.detach() - want).float()
        out[name] = {"experts": [f"{s.axis} {s.index} of {s.size} on dim "
                                 f"{s.dim}" for s in splits],
                     "norm_rel": (diff.norm() / want.norm()).item(),
                     "update_rel": (diff.norm()
                                    / (want - start[name]).norm()).item(),
                     "max_rel": (diff.abs().max()
                                 / want.abs().max()).item(),
                     "lr_steps": int((diff.abs()
                                      > optimizer["learning_rate"] / 2).sum())}
    return 0, {"blocks": out, "flips": flips}


pd.initialize_from_env()
out = {}
times = {"imported": time.time() - T0}
# phase 17 (a, b) and 18's 2-rank layouts: the worker entrypoint
for phase in ("17", "18"):
    if phase in spec:
        out[phase] = [job(trainer(config)) for config in spec[phase]]
        times[phase] = time.time() - T0
if "19" in spec:
    sp = spec["19"]
    # (b) first: its first step pays the process's first launches and
    # exchanges
    out["19"] = {"sp": job(trainer(sp["config"])),
                 "ring": job(lambda: ring_check(sp)),
                 "pp": job(lambda: pipeline_check(sp))}
    times["19"] = time.time() - T0
if "20" in spec:
    moe = spec["20"]
    out["20"] = {"dp=2": job(trainer({**moe["config"], "dp": 2}))}
    for label, layout in moe["layouts"].items():
        out["20"][label] = job(lambda layout=layout: moe_layout(moe, layout))
    times["20"] = time.time() - T0
if "21" in spec:
    # phase 21's runs, shared with the one-process runs of chip_smoke.py
    import chip_smoke as smoke
    out["21"] = [job(lambda run=run: (0, smoke.multihost_run(fa, run, comm)))
                 for run in spec["21"]]
    times["21"] = time.time() - T0
if "22" in spec:
    # phase 22's predictor gangs: rank 0 leads each engine, the others
    # follow its step records
    import chip_smoke as smoke
    out["22"] = [job(lambda run=run: (0, (
        smoke.residency_run if run.get("residency")
        else smoke.disagg_run if run.get("disagg")
        else smoke.predictor_run)(fa, run, comm))) for run in spec["22"]]
    times["22"] = time.time() - T0
print(json.dumps({
    "device": torch.cuda.current_device(), "backend": dist.get_backend(),
    "world": dist.get_world_size(), "times": times, **out}))
"""


def gang_path() -> str:
    """PYTHONPATH for a gang's workers: this checkout first."""
    return os.pathsep.join([str(ROOT)] + [p for p in [
        os.environ.get("PYTHONPATH")] if p])


def spawn_gang(spec: dict, ranks: int) -> list[dict]:
    """``GANG_WORKER`` with ``spec``'s sections in a gang of ``ranks`` on
    this card; every rank's output."""
    from kubeflow_tpu_torch.parallel.distributed import spawn_local_gang

    outs = spawn_local_gang(
        GANG_WORKER, ranks, timeout=GANG_TIMEOUT_S,
        extra_env={"GANG_SPEC": json.dumps(spec),
                   "GANG_SPAWNED": repr(time.time()),
                   "PYTHONPATH": gang_path()})
    for r, out in enumerate(outs):
        check(out["backend"] == "gloo" and out["device"] == 0
              and out["world"] == ranks, (r, out["backend"], out["device"]))
    return outs


def step2(job: dict) -> dict:
    """A job's collectives of step 2 alone: between the syncs that log
    steps 1 and 2 (a checkpoint may follow the last)."""
    first, second = job["snaps"][:2]
    return {kind: {k: v - first.get(kind, {}).get(k, 0)
                   for k, v in rec.items()}
            for kind, rec in second.items()}


def comm_line(comm: dict) -> str:
    return ", ".join(f"{kind} {c['s']:.4f} s in {c['calls']} calls of "
                     f"{c['bytes']} B" for kind, c in sorted(comm.items()))


def gang_data(home: Path) -> tuple[str, str]:
    """The .npz files of phase 17 from seed 0: GANG_BERT's global batches
    of 24 BERT rows (15% of positions weighted) and GANG_RESNET's of 128
    ResNet images (float16: the model rounds them to bf16)."""
    rng = np.random.default_rng(0)
    n, vocab = TRAIN_BATCH * GANG_BERT["steps"], 30522
    bert = home / "bert.npz"
    np.savez(bert,
             input_ids=rng.integers(0, vocab, (n, TRAIN_SEQ), dtype=np.int32),
             labels=rng.integers(0, vocab, (n, TRAIN_SEQ), dtype=np.int32),
             weights=(rng.random((n, TRAIN_SEQ)) < 0.15).astype(np.float32))
    n = VISION_BATCH * GANG_RESNET["steps"]
    resnet = home / "resnet.npz"
    np.savez(resnet,
             image=rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
             .astype(np.float16),
             label=rng.integers(0, 1000, (n,), dtype=np.int32))
    return str(bert), str(resnet)


def gang_compare(label: str, one: dict, ranks: list[dict],
                 phase: int = 17) -> None:
    """Every rank's trail bitwise equal to rank 0's, rank 0's within
    GANG_TOL of one process's at every step."""
    trails = [r["trail"] for r in ranks]
    check(all(t == trails[0] for t in trails),
          f"{label}: the ranks' losses differ: {trails}")
    worst = dict.fromkeys(GANG_TOL, 0.0)
    for i, (got, want) in enumerate(zip(trails[0], one["trail"],
                                        strict=True)):
        rel = {k: abs(g - w) / abs(w)
               for k, g, w in zip(("loss", "grad_norm"), got, want)}
        log(f"phase {phase} {label} step {i + 1}: loss gang {got[0]:.6f} one "
            f"{want[0]:.6f} (rel {rel['loss']:.3e}), grad_norm gang "
            f"{got[1]:.6f} one {want[1]:.6f} (rel {rel['grad_norm']:.3e})")
        check(all(math.isfinite(x) for x in got + want), (label, got, want))
        worst = {k: max(worst[k], rel[k]) for k in worst}
    ok = all(worst[k] <= GANG_TOL[k] for k in worst)
    log(f"phase {phase} {label}: {len(ranks)} ranks bitwise equal; gang vs "
        f"one process max rel loss {worst['loss']:.3e} grad_norm "
        f"{worst['grad_norm']:.3e} (tol {GANG_TOL['loss']:g}, "
        f"{GANG_TOL['grad_norm']:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: gang vs one process {worst}")


def gang_resize(fa, data: str, home: Path) -> dict:
    """(c) The Trainer on BERT-large under ``RESIZE_SCHEDULE`` (world 2
    -> 1 at step ``RESIZE_AT`` of ``RESIZE_STEPS``), index 0 and then
    index 1, in this process: the resize record, monotone steps, index 1
    resigning at ``RESIZE_AT``.  Launches by shape: rows per worker
    change at the barrier."""
    from kubeflow_tpu_torch.elastic import Membership, ResizeCheckpoint
    from kubeflow_tpu_torch.elastic.runtime import ScriptedMembership
    from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

    schedule = {step: Membership(epoch, members)
                for step, (epoch, members) in RESIZE_SCHEDULE.items()}
    launches = {GANG_SHAPE[0]: dict.fromkeys(KERNEL_NAMES, 0),
                TRAIN_SHAPE[0]: dict.fromkeys(KERNEL_NAMES, 0)}
    out = {}
    for index in (0, 1):
        ck = home / f"resize-{index}"
        cfg = TrainerConfig.from_dict({
            **TRAIN_CONFIG, "steps": RESIZE_STEPS, "data_path": data,
            "checkpoint_dir": str(ck), "checkpoint_every": 100,
            "optimizer": {"name": "sgd", "learning_rate": 1e-2}})
        seen = dict.fromkeys(KERNEL_NAMES, 0)

        def hook(step, rec, seen=seen):
            now = counters(fa)
            shape = GANG_SHAPE[0] if step <= RESIZE_AT else TRAIN_SHAPE[0]
            for n in KERNEL_NAMES:
                launches[shape][n] += now[n] - seen[n]
            seen.update(now)

        set_counters(fa, seen)                           # the path starts
        t0 = time.perf_counter()
        trainer = Trainer(cfg, hook, ScriptedMembership(index, schedule),
                          device="cuda")
        summary = trainer.run()
        wall = time.perf_counter() - t0
        steps = [h["step"] for h in trainer.history]
        losses = [h["loss"] for h in trainer.history]
        record = ResizeCheckpoint(str(ck)).load()
        log(f"phase 17(c) index {index}: {summary}, resizes "
            f"{trainer.resizes}, steps {steps}, record {record}, losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}; {wall:.1f}s")
        check(all(math.isfinite(x) for x in losses), (index, losses))
        check(record == {"step": RESIZE_AT, "epoch": 1, "members": [0]},
              f"resize record {record}")
        if index == 0:
            check(summary["resizes"] == 1 and trainer.resizes == [
                {"step": RESIZE_AT, "epoch": 1, "world": 1, "rank": 0}],
                (summary, trainer.resizes))
            check(steps == list(range(1, RESIZE_STEPS + 1)), f"steps {steps}")
        else:
            check(summary.get("resigned") is True
                  and summary["start_step"] == RESIZE_AT, summary)
            check(steps == list(range(1, RESIZE_AT + 1)), f"steps {steps}")
        out[index] = {"summary": summary, "wall_s": wall}
        del trainer
        free_memory()
    per_step = {n: launches[GANG_SHAPE[0]][n] / (2 * RESIZE_AT)
                for n in KERNEL_NAMES}
    check(per_step == {n: float(v) for n, v in TRAIN_LAUNCHES.items()}
          and launches[TRAIN_SHAPE[0]] == {
              n: (RESIZE_STEPS - RESIZE_AT) * v
              for n, v in TRAIN_LAUNCHES.items()},
          f"phase 17(c) launches {launches}")
    return {"workers": out, "launches": launches}


def gang_prepare(fa, home: Path) -> tuple[dict, list]:
    """Phase 17's data and one-process runs; its section of the gang."""
    bert_npz, resnet_npz = gang_data(home)
    configs = [{**GANG_BERT, "data_path": bert_npz},
               {**GANG_RESNET, "data_path": resnet_npz}]
    one = [one_process(fa, configs[0], TRAIN_LAUNCHES,
                       "phase 17 BERT-large one process"),
           one_process(fa, configs[1], dict.fromkeys(KERNEL_NAMES, 0),
                       "phase 17 ResNet-50 one process")]
    return {"one": one, "bert_npz": bert_npz}, configs


def gang_finish(fa, prep: dict, ranks: list[list], home: Path) -> dict:
    """Phase 17's checks on the gang's jobs, then (c)."""
    results = {}
    for j, (label, config) in enumerate(
            (("BERT-large", GANG_BERT), ("ResNet-50", GANG_RESNET))):
        steps, batch = config["steps"], config["global_batch"]
        jobs = []
        for rank in ranks:
            job, stamps = rank[j], rank[j]["stamps"]
            reduced = job["comm"].get("all_reduce",
                                      {"s": 0.0, "bytes": 0, "calls": 0})
            jobs.append({
                "rc": job["rc"], "launches": job["launches"],
                "trail": job["trail"], "peak_gb": job["peak_gb"],
                "samples_per_s": batch * (len(stamps) - 1)
                / (stamps[-1] - stamps[0]),
                "allreduce_s": reduced["s"] / steps,
                "allreduce_bytes": reduced["bytes"] / steps,
                "allreduce_calls": reduced["calls"] / steps})
        one = prep["one"][j]
        want = ({n: steps * v for n, v in TRAIN_LAUNCHES.items()} if j == 0
                else dict.fromkeys(KERNEL_NAMES, 0))
        for r, job in enumerate(jobs + [one]):
            who = f"rank {r}" if r < len(jobs) else "one process"
            log(f"phase 17 {label} {who}: launches {job['launches']} "
                f"(expected {want}), peak memory {job['peak_gb']:.2f} "
                f"GB, samples/s {job['samples_per_s']:.2f}, all-reduce "
                f"{job['allreduce_s']:.4f} s per step in "
                f"{job['allreduce_calls']:.0f} calls of "
                f"{job['allreduce_bytes']:.0f} bytes in all")
            check(job["rc"] == 0 and job["launches"] == want,
                  (label, who, job["launches"]))
        gang_compare(label, one, jobs)
        results[label] = {
            "one_samples_per_s": one["samples_per_s"],
            "gang_samples_per_s": min(j_["samples_per_s"] for j_ in jobs),
            "allreduce_s": max(j_["allreduce_s"] for j_ in jobs),
            "allreduce_bytes": jobs[0]["allreduce_bytes"],
            "peak_gb": max(j_["peak_gb"] for j_ in jobs),
            "launches": {n: sum(j_["launches"][n] for j_ in jobs)
                         for n in KERNEL_NAMES}}
    return {**results, "resize": gang_resize(fa, prep["bert_npz"], home)}


def gang_numbers(fa, gang: dict, bert_rows: dict) -> dict[str, list[dict]]:
    """K1-K3 rows of phase 17: the gang's launches at each rank's shape,
    and (c)'s at the shapes before and after the barrier (after it: phase
    4's shape, whose times ``bert_rows`` holds)."""
    per_rank = training_numbers(fa, GANG_SHAPE, gang["BERT-large"]["launches"],
                                TRAIN_LAUNCHES)
    resize = gang["resize"]["launches"]
    return {n: [per_rank[n],
                with_launches(per_rank[n], resize[GANG_SHAPE[0]][n],
                              "17(c) world 2"),
                with_launches(bert_rows[n], resize[TRAIN_SHAPE[0]][n],
                              "17(c) world 1")]
            for n in KERNEL_NAMES}


def mesh_data(home: Path) -> str:
    """Phase 18's .npz from seed 0: MESH_STEPS global batches of 8 Llama
    rows of 512 tokens (labels: the ids shifted by one)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32000, (MESH_BATCH * MESH_STEPS, LLAMA_SEQ + 1),
                       dtype=np.int32)
    path = home / "llama.npz"
    np.savez(path, input_ids=ids[:, :-1], labels=ids[:, 1:])
    return str(path)


def mesh_restore(home: Path, digests: dict) -> None:
    """One process restores the last layout's checkpoint on the card:
    every parameter bitwise the gang's gathered one (``digests``: SHA-256
    of each tensor the gang's save gathered)."""
    import hashlib

    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.training.optim import make_optimizer

    model = registry.get("llama").make_model(
        device="cuda", **MESH_CONFIG["model_config"])
    state = ts.init_train_state(model, make_optimizer(
        MESH_CONFIG["optimizer"]))
    state = CheckpointManager(str(home / "ckpt")).restore(state)
    got = {k: hashlib.sha256(v.cpu().contiguous().view(torch.uint8)
                             .numpy()).hexdigest()
           for k, v in model.state_dict().items()}
    same = got == digests
    log(f"phase 18: the fsdp=2, tp=2 checkpoint of step {state.step} "
        f"restored by one process: {len(got)} tensors "
        f"{'bitwise equal' if same else 'DIFFER'} to the gang's gathered "
        "ones")
    check(same and state.step == MESH_STEPS, "phase 18 restore")


def one_process(fa, config: dict, launches: dict, label: str) -> dict:
    """The one-process reference of a gang phase: ``phase_training`` in
    this process (its CUDA start-up is paid already) with every step's
    loss and grad_norm recorded, shaped like a gang worker's job."""
    from kubeflow_tpu_torch.parallel import train_step as ts

    trail = []
    build = ts.build_train_step

    def recorded_build(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, batch):
            state, m = step(state, batch)
            trail.append((m["loss"], m["grad_norm"]))
            return state, m

        return recorded

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    ts.build_train_step = recorded_build
    try:
        run = phase_training(fa, config, launches, label)
    finally:
        ts.build_train_step = build
    return {"rc": 0, "launches": run["launches"],
            "trail": [[float(loss), float(norm)] for loss, norm in trail],
            "samples_per_s": run["samples_per_sec"], "allreduce_s": 0.0,
            "allreduce_bytes": 0, "allreduce_calls": 0, "comm": {},
            "steps_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_prepare(fa, home: Path) -> tuple[dict, list]:
    """Phase 18's data and one-process run; its section of the gang of 2
    (fsdp=2, then tp=2)."""
    data = mesh_data(home)
    configs = {label: {**MESH_CONFIG, "data_path": data, "fsdp": fsdp,
                       "tp": tp}
               for label, fsdp, tp in MESH_LAYOUTS}
    last = MESH_LAYOUTS[-1][0]
    configs[last]["checkpoint_dir"] = str(home / "ckpt")
    one = MESH_LAYOUTS[0][0]
    results = {one: one_process(fa, configs[one], MESH_LAUNCHES,
                                f"phase 18 {one}")}
    twos = [label for label, *_ in MESH_LAYOUTS[1:-1]]
    return ({"configs": configs, "results": results, "twos": twos},
            [configs[label] for label in twos])


def mesh_jobs(labels: list[str], ranks: list[list], gang: int) -> dict:
    """Phase 18's layouts ``labels`` from the gang's jobs (one list per
    rank, in ``labels``' order): launches, trails, collectives of step 2,
    peak memory, samples/s of step 2, rank 0's checkpoint digests."""
    want = {n: MESH_STEPS * v for n, v in MESH_LAUNCHES.items()}
    results = {}
    for j, label in enumerate(labels):
        jobs = [rank[j] for rank in ranks]
        for r, job in enumerate(jobs):
            job["samples_per_s"] = MESH_BATCH / (job["stamps"][1]
                                                 - job["stamps"][0])
            job["steps_peak_gb"] = job["peaks"][-1]
            log(f"phase 18 {label} rank {r} (gang of {gang}): seconds after "
                f"the spawn start {job['times']['start']:.1f}, step1 "
                f"{job['stamps'][0]:.1f}, last {job['stamps'][-1]:.1f}, "
                f"ended {job['times']['ended']:.1f}; launches "
                f"{job['launches']} (expected {want}), peak memory "
                f"{job['steps_peak_gb']:.2f} GB over the steps, "
                f"{job['peak_gb']:.2f} GB over the run, samples/s "
                f"{job['samples_per_s']:.2f}; step 2: "
                f"{comm_line(step2(job))}")
            check(job["rc"] == 0 and job["launches"] == want,
                  (label, r, job["launches"]))
        results[label] = {
            "trail": jobs[0]["trail"], "trails": [j_["trail"] for j_ in jobs],
            "digests": jobs[0]["digests"],
            "samples_per_s": min(j_["samples_per_s"] for j_ in jobs),
            "steps_peak_gb": max(j_["steps_peak_gb"] for j_ in jobs),
            "peak_gb": max(j_["peak_gb"] for j_ in jobs),
            "comm": step2(jobs[0]),
            "launches": {n: sum(j_["launches"][n] for j_ in jobs)
                         for n in KERNEL_NAMES}}
    return results


def mesh_finish(prep: dict, ranks: list[list], fours: list[list],
                home: Path) -> dict:
    """Phase 18: the 2-rank layouts' results, the last layout's from the
    gang of 4, every layout against one process, the last layout's
    checkpoint restored by one process."""
    results = dict(prep["results"])
    results.update(mesh_jobs(prep["twos"], ranks, GANG_RANKS))
    last = MESH_LAYOUTS[-1][0]
    results.update(mesh_jobs([last], fours, 4))
    one = MESH_LAYOUTS[0][0]
    for label, *_ in MESH_LAYOUTS[1:]:
        gang_compare(label, results[one],
                     [{"trail": t} for t in results[label]["trails"]],
                     phase=18)
    mesh_restore(home, results[last]["digests"])
    return results


def mesh_numbers(fa, mesh: dict) -> dict[str, list[dict]]:
    """K1-K3 rows of phase 18: each layout's launches at its rank shape."""
    rows = {n: [] for n in KERNEL_NAMES}
    for label, fsdp, tp in MESH_LAYOUTS:
        got = training_numbers(fa, mesh_shape(fsdp, tp),
                               mesh[label]["launches"], MESH_LAUNCHES)
        for n in KERNEL_NAMES:
            rows[n].append(got[n])
    return rows


def sp_data(home: Path) -> str:
    """Phase 19's .npz from seed 0: SP_STEPS global batches of SP_BATCH
    Llama rows of SP_SEQ tokens (labels: the ids shifted by one)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32000, (SP_BATCH * SP_STEPS, SP_SEQ + 1),
                       dtype=np.int32)
    path = home / "llama_sp.npz"
    np.savez(path, input_ids=ids[:, :-1], labels=ids[:, 1:])
    return str(path)


def sp_expected(rank: int) -> dict:
    """Rank ``rank``'s launches of phase 19: its ring blocks (the diagonal
    one and ``rank`` earlier ones; a later block launches nothing) per
    check, per layer and pass of (b), and (c)'s blocks per microbatch."""
    blocks = rank + 1
    return {
        "ring": dict.fromkeys(KERNEL_NAMES, blocks),
        "sp": {"flash_fwd": 2 * blocks * SP_LAYERS * SP_STEPS,
               "flash_bwd_dq": blocks * SP_LAYERS * SP_STEPS,
               "flash_bwd_dkv": blocks * SP_LAYERS * SP_STEPS},
        "pp": dict.fromkeys(KERNEL_NAMES,
                            PP_BLOCKS // SP_RANKS * PP_MICRO)}


def sp_prepare(fa, home: Path) -> tuple[dict, dict]:
    """Phase 19's data and (b)'s one process; its section of the gang."""
    config = {**SP_CONFIG, "data_path": sp_data(home)}
    one = one_process(fa, config, SP_ONE_LAUNCHES, "phase 19 one process")
    return {"one": one}, {
        "sp": SP_RANKS, "block": SP_BLOCK_SHAPES[0][1:3] + (32, 128),
        "config": {**config, "sp": SP_RANKS}, "pp_blocks": PP_BLOCKS,
        "pp_batch": PP_BATCH, "pp_seq": PP_SEQ, "pp_micro": PP_MICRO}


def sp_finish(prep: dict, outs: list[dict]) -> dict:
    """Phase 19's checks on the gang's (a), (b) and (c)."""
    one = prep["one"]
    ticks = PP_MICRO + SP_RANKS - 1
    for r, out in enumerate(outs):
        want = sp_expected(r)
        sp, pp = out["sp"], out["pp"]["extra"]
        ring = {**out["ring"]["extra"]}
        sp["samples_per_s"] = SP_BATCH / (sp["stamps"][1] - sp["stamps"][0])
        log(f"phase 19 rank {r}: seconds after the spawn: (b) "
            f"{sp['times']['start']:.1f} to {sp['times']['ended']:.1f}, (a) "
            f"to {out['ring']['times']['ended']:.1f}, (c) to "
            f"{out['pp']['times']['ended']:.1f}")
        log(f"phase 19(a) rank {r}: ring on {SP_BLOCK_SHAPES[0][1:3]} x 32 "
            f"heads of 128, causal, bf16: launches {ring['launches']} "
            f"(expected {want['ring']}); O within "
            f"{ring['o_ratio']:.3f} of 2^-7 (|O| + P|V|) (tol "
            f"{IN_MODEL_TOL['o']:g}); dQ, dK, dV / max|ref| "
            + " ".join(f"{x:.3e}" for x in ring["grad_rel"])
            + f" (tol {BWD_TOL[torch.bfloat16]:g}); forward and backward "
            f"{ring['s']:.4f} s with "
            f"{ring['exchange']['calls']} exchanges "
            f"of {ring['exchange']['bytes']} B in "
            f"{ring['exchange']['s']:.4f} s")
        check(out["ring"]["rc"] == 0 and ring["launches"] == want["ring"]
              and ring["o_ratio"] <= IN_MODEL_TOL["o"]
              and max(ring["grad_rel"]) <= BWD_TOL[torch.bfloat16],
              f"phase 19(a) rank {r}: {ring}")
        log(f"phase 19(b) sp={SP_RANKS} rank {r}: launches "
            f"{sp['launches']} (expected {want['sp']}), peak memory "
            f"{sp['peak_gb']:.2f} GB, samples/s {sp['samples_per_s']:.3f} "
            f"({sp['samples_per_s'] * SP_SEQ:.0f} tokens/s); step 2: "
            f"{comm_line(step2(sp))}")
        check(sp["rc"] == 0 and sp["launches"] == want["sp"],
              f"phase 19(b) rank {r}: {sp['rc']} {sp['launches']}")
        log(f"phase 19(c) pp={SP_RANKS} rank {r}: {PP_BLOCKS} blocks, x "
            f"[{PP_BATCH}, {PP_SEQ}, 4096] bf16 in {PP_MICRO} microbatches: "
            f"{ticks} ticks, bubble share {(SP_RANKS - 1) / ticks:.3f}, "
            f"forward and backward {pp['s']:.4f} s ({comm_line(pp['comm'])}"
            f"); launches {pp['launches']} (expected {want['pp']}); out vs "
            f"in sequence / max|ref| {pp['out_rel']:.3e} (tol "
            f"{PP_OUT_REL_TOL:g}), stage gradients {pp['grad_rel']:.3e} "
            f"(tol {BWD_TOL[torch.bfloat16]:g}); peak memory "
            f"{pp['peak_gb']:.2f} GB")
        check(out["pp"]["rc"] == 0 and pp["launches"] == want["pp"]
              and pp["out_rel"] <= PP_OUT_REL_TOL
              and pp["grad_rel"] <= BWD_TOL[torch.bfloat16],
              f"phase 19(c) rank {r}: {pp}")
    gang_compare(f"sp={SP_RANKS}", one,
                 [{"trail": out["sp"]["trail"]} for out in outs], phase=19)
    sp_rate = min(out["sp"]["samples_per_s"] for out in outs)
    log(f"phase 19(b): samples/s one process {one['samples_per_s']:.3f} "
        f"({one['samples_per_s'] * SP_SEQ:.0f} tokens/s), sp={SP_RANKS} "
        f"{sp_rate:.3f} ({sp_rate * SP_SEQ:.0f} tokens/s); peak memory one "
        f"process {one['steps_peak_gb']:.2f} GB")
    total = {"sp": {n: sum(out["sp"]["launches"][n] for out in outs)
                    for n in KERNEL_NAMES},
             "pp": {n: sum(out["pp"]["extra"]["launches"][n] for out in outs)
                    for n in KERNEL_NAMES}}
    # (b)'s launches by block: every rank one diagonal block per layer and
    # pass, the rest earlier ones
    diagonal = {n: sum(v // (r + 1) for r, v in enumerate(
        out["sp"]["launches"][n] for out in outs)) for n in KERNEL_NAMES}
    return {"one": one, "sp_samples_per_s": sp_rate,
            "launches": {SP_BLOCK_SHAPES[0][0]: diagonal,
                         SP_BLOCK_SHAPES[1][0]: {
                             n: total["sp"][n] - diagonal[n]
                             for n in KERNEL_NAMES},
                         SP_ONE_SHAPE[0]: one["launches"],
                         PP_SHAPE[0]: total["pp"]}}


def sp_numbers(fa, sp: dict) -> dict[str, list[dict]]:
    """K1-K3 rows of phase 19: its launches at each of its shapes (the
    ring's blocks, one process's whole sequence, the pipeline's
    microbatch)."""
    rows = {n: [] for n in KERNEL_NAMES}
    for shape in SP_SHAPES:
        # the plain versions of the ring's blocks and of the whole sequence
        # take 6-50 ms a call: a few calls a window
        got = training_numbers(fa, shape, sp["launches"][shape[0]], None,
                               plain_reps=5 if shape is PP_SHAPE else 2)
        for n in KERNEL_NAMES:
            rows[n].append(got[n])
    return rows


def moe_ep_data(home: Path) -> str:
    """Phase 20's .npz from seed 0: MOE_EP_STEPS global batches of 8 Llama
    rows of 512 tokens (labels: the ids shifted by one)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32000, (MESH_BATCH * MOE_EP_STEPS, LLAMA_SEQ + 1),
                       dtype=np.int32)
    path = home / "llama_moe.npz"
    np.savez(path, input_ids=ids[:, :-1], labels=ids[:, 1:])
    return str(path)


def moe_one_process(fa, config: dict, optimizer: dict, experts: Path,
                    routing: Path) -> dict:
    """Phase 20's model as one process here through ``build_train_step``
    with ``optimizer``, on the global batches a data-parallel gang of 2
    assembles (its ranks' strided ``NpzDataset`` shards, rank-major:
    capacity positions follow the rows' order, so this is the batch the
    gang's layouts see): every step's loss, grad_norm, launches and MoE
    layers' dropped counts; its expert weights after the last step are
    written to ``experts`` and step 1's routing to ``routing`` for the
    ranks' checks."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.models.moe import route
    from kubeflow_tpu_torch.parallel import train_step as ts
    from kubeflow_tpu_torch.training.data import NpzDataset, to_device
    from kubeflow_tpu_torch.training.optim import make_optimizer

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    entry = registry.get(config["model"])
    model = entry.make_model(**config["model_config"], device="cuda")
    model.init_weights(config["seed"])
    state = ts.init_train_state(model, make_optimizer(optimizer))
    step = ts.build_train_step(entry.forward_loss, state.tx)
    shards = [NpzDataset(config["data_path"], config["global_batch"],
                         seed=config["seed"], process_index=r,
                         process_count=GANG_RANKS).iter_from(0)
              for r in range(GANG_RANKS)]
    trail, dropped, stamps, launches, routed = [], [], [], [], []
    # step 1's routing: each MoE layer's top-2 experts [B, S, 2] of its
    # forward (the gang's layouts count their assignments routed otherwise)
    hooks = [blk.moe.router.register_forward_hook(
        lambda mod, args, logits: routed.append(
            route(torch.softmax(logits.float(), -1))[1].cpu()))
        for blk in model.layers if blk.use_moe]
    set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))     # the path starts
    for i in range(config["steps"]):
        rows = [next(shard) for shard in shards]
        batch = to_device({k: torch.cat([torch.as_tensor(r[k]) for r in rows])
                           for k in rows[0]}, torch.device("cuda"))
        seen = counters(fa)
        state, m = step(state, batch)
        for hook in hooks if i == 0 else ():
            hook.remove()
        trail.append([m["loss"].item(), m["grad_norm"].item()])
        stamps.append(time.perf_counter())
        now = counters(fa)
        launches.append({n: now[n] - seen[n] for n in KERNEL_NAMES})
        dropped.append([int(b.moe.dropped) for b in model.layers
                        if b.use_moe])
    total = counters(fa)                                 # the path ended
    for i, got in enumerate(launches):
        check(got == MOE_EP_LAUNCHES, f"phase 20 one process "
              f"{optimizer['name']} step {i + 1} launches {got}, expected "
              f"{MOE_EP_LAUNCHES}")
    check(all(math.isfinite(x) for t in trail for x in t), trail)
    torch.save({k: p.detach().cpu() for k, p in model.named_parameters()
                if k.endswith(("moe.w_in", "moe.w_out"))}, experts)
    torch.save(routed[:len(hooks)], routing)
    del model, state, step
    return {"rc": 0, "launches": total, "trail": trail, "dropped": dropped,
            "samples_per_s": config["global_batch"] / (stamps[1]
                                                       - stamps[0]),
            "steps_peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def moe_ep_prepare(fa, home: Path) -> tuple[dict, dict]:
    """Phase 20's one-process runs here (adamw, and lamb for tp=2 lamb);
    its section of the gang: dp = 2 through the worker entrypoint, each
    of ``MOE_EP_MESHES`` through ``build_train_step``."""
    config = {**MOE_EP_CONFIG, "data_path": moe_ep_data(home)}
    optimizers = {"adamw": config["optimizer"], "lamb": MOE_LAMB}
    one = {name: moe_one_process(fa, config, opt, home / f"experts-{name}.pt",
                                 home / f"routing-{name}.pt")
           for name, opt in optimizers.items()}
    layouts = {label: {"axes": axes, "optimizer": optimizers[opt],
                       "experts": str(home / f"experts-{opt}.pt"),
                       "routing": str(home / f"routing-{opt}.pt"),
                       "one": opt}
               for label, (axes, opt) in MOE_EP_MESHES.items()}
    return ({"one": one["adamw"], "one lamb": one["lamb"],
             "layouts": layouts},
            {"config": config, "ranks": GANG_RANKS, "layouts": layouts})


def moe_ep_expected(label: str, rank: int) -> dict:
    """Rank ``rank``'s launches in a phase 20 layout: ``MOE_EP_LAUNCHES``
    a step, at sp = 2 once per visible ring block (``sp_expected``)."""
    blocks = rank + 1 if label.startswith("sp") else 1
    return {n: MOE_EP_STEPS * v * blocks for n, v in MOE_EP_LAUNCHES.items()}


def moe_ep_finish(prep: dict, outs: list[dict]) -> dict:
    """Phase 20's checks: every layout's launches, dropped counts and
    trail against one process with its optimizer, ep's and tp's expert
    blocks against its rows or columns."""
    results = {"one process": prep["one"],
               "one process lamb": prep["one lamb"]}
    flipped: dict[str, list[int]] = {}
    for label in ("one process", "one process lamb"):
        one = results[label]
        log(f"phase 20 {label}: launches {one['launches']} (expected "
            f"{moe_ep_expected(label, 0)}), samples/s "
            f"{one['samples_per_s']:.3f}, peak memory "
            f"{one['steps_peak_gb']:.2f} GB, dropped (token, choice) per MoE "
            f"layer and step {one['dropped']}")
    for label, _ in MOE_EP_LAYOUTS[1:]:
        layout = prep["layouts"].get(label, {})
        one = results["one process lamb" if layout.get("one") == "lamb"
                      else "one process"]
        jobs = [out["20"][label] for out in outs]
        if jobs[0]["extra"]:
            # the ranks' tokens: every sp rank its chunk, else all of them
            ranks = jobs if label.startswith("sp") else jobs[:1]
            flipped[label] = [sum(f) for f in zip(
                *(job["extra"]["flips"] for job in ranks))]
            log(f"phase 20 {label}: (token, choice) assignments of step 1 "
                f"routed to another expert than one process's, per MoE "
                f"layer: {flipped[label]}")
        for r, job in enumerate(jobs):
            want = moe_ep_expected(label, r)
            job["samples_per_s"] = MESH_BATCH / (job["stamps"][1]
                                                 - job["stamps"][0])
            log(f"phase 20 {label} rank {r}: seconds after the spawn start "
                f"{job['times']['start']:.1f}, step1 {job['stamps'][0]:.1f},"
                f" last {job['stamps'][-1]:.1f}, ended "
                f"{job['times']['ended']:.1f}; launches {job['launches']} "
                f"(expected {want}), peak memory {job['peak_gb']:.2f} GB, "
                f"samples/s {job['samples_per_s']:.3f}; dropped per MoE "
                f"layer and step {job['dropped']} (one process "
                f"{one['dropped']}); step 2: {comm_line(step2(job))}")
            check(job["rc"] == 0 and job["launches"] == want,
                  (label, r, job["launches"]))
            # step 1 routes the same rows with the same weights, so every
            # MoE layer's dropped count is one process's unless capacity or
            # positions differ, or (tp, sp) bf16 rounding at the rank's
            # shapes flipped a near-tie of the router (ROADMAP queue C item
            # 7): each (token, choice) routed otherwise moves the count by
            # at most one, so it is held to one process's within the
            # layouts' counted flips (zero for dp, and where none flipped);
            # later steps route with weights that adam's lr-sized steps on
            # rounding-level gradient elements moved apart (printed, not
            # held)
            flips = flipped.get(label, [0] * len(one["dropped"][0]))
            check(all(abs(g - w) <= f for g, w, f in zip(
                job["dropped"][0], one["dropped"][0], flips)),
                  f"phase 20 {label} rank {r}: step 1 dropped "
                  f"{job['dropped'][0]} against one process's "
                  f"{one['dropped'][0]}, {flips} assignments routed "
                  "otherwise")
            experts = (job["extra"] or {}).get("blocks", {})
            for name, e in experts.items():
                # ep's blocks by the norm of the weights, tp's by the norm
                # of one process's update (MOE_TP_EXPERT_TOL)
                key, tol = (("update_rel", MOE_TP_EXPERT_TOL)
                            if label.startswith("tp")
                            else ("norm_rel", MOE_EP_EXPERT_TOL))
                log(f"phase 20 {label} rank {r}: {name} block "
                    f"{', '.join(e['experts'])} after step {MOE_EP_STEPS} "
                    f"against one process's: ||d||/||w|| "
                    f"{e['norm_rel']:.3e}, ||d||/||update|| "
                    f"{e['update_rel']:.3e} ({key} tol {tol:g}), "
                    f"max|d|/max|w| {e['max_rel']:.3e}, {e['lr_steps']} "
                    f"elements apart by more than lr/2")
                check(e[key] <= tol, (label, r, name, e))
            if label.startswith(("ep", "tp")):
                check(sorted(experts) == [f"layers.0.moe.{w}"
                                          for w in ("w_in", "w_out")],
                      (label, r, sorted(experts)))
        gang_compare(label, one, jobs, phase=20)
        launched = {n: sum(job["launches"][n] for job in jobs)
                    for n in KERNEL_NAMES}
        results[label] = {
            "samples_per_s": min(job["samples_per_s"] for job in jobs),
            "peak_gb": max(job["peak_gb"] for job in jobs),
            "comm": step2(jobs[0]), "launches": launched}
        if label.startswith("sp"):
            # by block: every rank one diagonal block per layer and pass,
            # the rest earlier ones
            diagonal = {n: sum(job["launches"][n] // (r + 1)
                               for r, job in enumerate(jobs))
                        for n in KERNEL_NAMES}
            results[label]["by_shape"] = {
                MOE_SP_SHAPES[0][0]: diagonal,
                MOE_SP_SHAPES[1][0]: {n: launched[n] - diagonal[n]
                                      for n in KERNEL_NAMES}}
    log(f"phase 20: samples/s of step 2: " + ", ".join(
        f"{label} {r['samples_per_s']:.3f}" for label, r in results.items()))
    return results


def moe_ep_numbers(fa, moe_ep: dict,
                   mesh_rows: dict | None = None) -> dict[str, list[dict]]:
    """K1-K3 rows of phase 20: each layout's launches at its rank shape,
    whose times phase 18's rows hold (``mesh_rows``; timed here without
    them), and sp's at its ring blocks, timed here."""
    if mesh_rows is None:
        mesh_rows = {n: [] for n in KERNEL_NAMES}
        for shape in {v[0]: v for v in MOE_EP_SHAPES.values()}.values():
            got = training_numbers(fa, shape, dict.fromkeys(KERNEL_NAMES, 0),
                                   None)
            for n in KERNEL_NAMES:
                mesh_rows[n].append(got[n])
    rows = {n: [] for n in KERNEL_NAMES}
    for label, rec in moe_ep.items():
        if "by_shape" in rec:
            for shape in MOE_SP_SHAPES:
                got = training_numbers(fa, shape, rec["by_shape"][shape[0]],
                                       None, plain_reps=2)
                for n in KERNEL_NAMES:
                    rows[n].append(with_launches(got[n], got[n]["launches"],
                                                 f"phase 20 {label}"))
            continue
        shape = MOE_EP_SHAPES[label][0]
        for n in KERNEL_NAMES:
            row = next(r for r in mesh_rows[n] if r["shape"] == shape)
            rows[n].append(with_launches(row, rec["launches"][n],
                                         f"phase 20 {label}"))
    return rows


def sha256_of(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy()).hexdigest()


def tp_block_digests(module, tp: int) -> dict[str, list[list[str]]]:
    """Per int8 ``QTensor`` of a whole (one-process) model, the SHA-256 of
    the ``q`` and ``scale`` blocks tp rank r must hold: ``q`` cut where
    its kernel's serving spec says tp, ``scale`` where ``_scale_spec``
    of it does."""
    from kubeflow_tpu_torch.serving import sharded
    from kubeflow_tpu_torch.serving.quant import QTensor

    out = {}
    for name, qt in module.named_modules():
        if not isinstance(qt, QTensor):
            continue
        spec = sharded.SERVING_RULES.spec(qt.logical_axes)
        blocks = []
        for r in range(tp):
            parts = []
            for t, t_spec in ((qt.q, spec),
                              (qt.scale, sharded._scale_spec(
                                  spec, tuple(qt.scale.shape)))):
                for d, axis in enumerate(t_spec):
                    if axis == "tp":
                        n = t.shape[d] // tp
                        t = t.narrow(d, r * n, n)
                parts.append(sha256_of(t))
            blocks.append(parts)
        out[name] = blocks
    return out


@contextlib.contextmanager
def tp2_partial_sums(model, columns: bool = False):
    """Every row-parallel product of a whole (one-process) bf16 ``model``
    computed as tp = 2 computes it: the two halves of the contraction each
    a bf16 product, summed in bf16 (gloo's sum of two bf16 tensors rounds
    their float sum once), as long as the block lasts.  With ``columns``
    every product runs at a tp = 2 rank's shapes: each column-parallel
    kernel (and the tied head's vocabulary) as two products of half the
    columns, and every half's operands contiguous, as a rank holds them
    (a GEMM's algorithm, and with it its rounding, may depend on N)."""
    from kubeflow_tpu_torch.models.layers import DenseGeneral, weight
    from kubeflow_tpu_torch.ops.matmul import matmul_f32
    from kubeflow_tpu_torch.serving import sharded

    specs = sharded.param_specs(model)
    split = {m: specs.get(f"{name}.kernel", ())
             for name, m in model.named_modules()
             if isinstance(m, DenseGeneral)}
    patched = [m for m, spec in split.items() if spec[:1] == ("tp",)]
    cols = ([m for m, spec in split.items() if "tp" in spec[1:]]
            if columns else [])

    def halves(m):
        def forward(x):
            w = weight(m.kernel, m.dtype)
            w2, xs = w.reshape(w.shape[0], -1), x.to(m.dtype)
            k = w2.shape[0] // 2
            if columns:
                y = (xs[..., :k].contiguous() @ w2[:k]
                     + xs[..., k:].contiguous() @ w2[k:])
            else:
                y = xs[..., :k] @ w2[:k] + xs[..., k:] @ w2[k:]
            return y.reshape(x.shape[:-1] + w.shape[1:])
        return forward

    def column_halves(m):
        def forward(x):
            w = weight(m.kernel, m.dtype)
            w2, xs = w.reshape(w.shape[0], -1), x.to(m.dtype)
            n = w2.shape[1] // 2
            y = torch.cat([xs @ w2[:, :n].contiguous(),
                           xs @ w2[:, n:].contiguous()], dim=-1)
            return y.reshape(x.shape[:-1] + w.shape[1:])
        return forward

    emb = model.tok_embeddings

    def attend(x):
        common = torch.promote_types(x.dtype, emb.dtype)
        table = weight(emb.embedding, emb.dtype).to(common)
        x2, v = x.to(common).reshape(-1, x.shape[-1]), table.shape[0] // 2
        y = torch.cat([matmul_f32(x2, table[:v].T),
                       matmul_f32(x2, table[v:].T)], dim=-1)
        return y.reshape(*x.shape[:-1], -1)

    for m in patched:
        m.forward = halves(m)
    for m in cols:
        m.forward = column_halves(m)
    if columns:
        emb.attend = attend
    try:
        yield patched
    finally:
        for m in patched + cols:
            del m.forward
        if columns:
            del emb.attend


def multihost_run(fa, run: dict, comm: dict | None = None) -> dict:
    """One run of phase 21 in this process (one process, or a rank of a
    gang whose collectives ``comm`` records): ``MultiHostPredictor`` of
    ``run``'s layout, rank 0's prompts through ``broadcast_prompts``, and
    one ``generate`` with the kernels' counts set to 0 just before it and
    read just after, each forward entered after a ``synchronize``.
    Writes the rank's first-token logits to ``run["out"]`` (and, where
    ``run`` names ``emulated_out``, those of one more prefill under
    ``tp2_partial_sums`` there); returns the tokens, launches, K1 calls,
    times, memory and, with int8 weights, each ``QTensor`` block's
    SHA-256."""
    from kubeflow_tpu_torch.parallel import distributed as pd
    from kubeflow_tpu_torch.serving.multihost import (MultiHostPredictor,
                                                      broadcast_prompts)
    from kubeflow_tpu_torch.serving.quant import QTensor, quantized_bytes

    rank = pd.rank_of(pd.default_group())
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    config = {} if run["layers"] is None else {"num_layers": run["layers"]}
    t0 = time.perf_counter()
    mh = MultiHostPredictor("llama", size="7b", tp=run["tp"], dp=run["dp"],
                            max_seq=MAX_SEQ, seed=0,
                            quantize=run["quantize"], model_config=config)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = torch.cuda.memory_allocated() - base
    prompts = broadcast_prompts(run["prompts"] if rank == 0 else None,
                                max_items=len(MH_PROMPT_LENS),
                                max_len=MH_PAD)
    stamps, calls = [], []
    forward = mh.module.forward

    def entered(*args, **kwargs):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), json.loads(json.dumps(
            comm or {}))))
        return forward(*args, **kwargs)

    mh.module.forward = entered
    with flash_route(recording_flash(fa, calls)):
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t1 = time.perf_counter()
        ids = mh.generate(prompts, max_new_tokens=MH_NEW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = counters(fa)                           # it ended
    mh.module.forward = forward
    torch.save(mh.prefill_logits.float().cpu(),
               run["out"].format(rank=rank))
    if run.get("emulated_out"):
        saved = counters(fa)
        with tp2_partial_sums(mh.module):
            mh.generate(prompts, max_new_tokens=1)
        set_counters(fa, saved)                  # a diagnosis, not the path
        torch.save(mh.prefill_logits.float().cpu(), run["emulated_out"])
    (s1, c1), (_, c2) = stamps[1], stamps[2]
    out = {"rank": rank, "prompts": prompts, "ids": ids,
           "launches": launches, "calls": sorted(set(map(tuple, calls))),
           "n_calls": len(calls), "load_s": load_s, "loaded": loaded,
           "weight_bytes": quantized_bytes(mh.module),
           "prefill_s": s1 - t1, "decode_s": t2 - s1,
           "decode_tokens": len(prompts) * (MH_NEW - 1),
           "step_comm": {kind: {k: v - c1.get(kind, {}).get(k, 0)
                                for k, v in rec.items()}
                         for kind, rec in c2.items()},
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "rows": [mh.rows.start, mh.rows.stop],
           "digests": {n: [sha256_of(m.q), sha256_of(m.scale)]
                       for n, m in mh.module.named_modules()
                       if isinstance(m, QTensor)}}
    if run["quantize"] and run["tp"] == 1:
        out["tp2_digests"] = tp_block_digests(mh.module, 2)
    del mh
    free_memory()
    return out


def mh_prepare(fa, home: Path) -> tuple[dict, list]:
    """Phase 21's runs and prompts, one process's three (7B, and bf16 and
    int8 at MH_SHALLOW_LAYERS layers) here, the bf16 ones with their
    ``tp2_partial_sums`` prefill; the gang of 2's section (tp = 2, then
    the MH_SHALLOW layouts) and the gang of 4's (dp = 2 x tp = 2)."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 32000, n).tolist() for n in MH_PROMPT_LENS]

    def run(label, dp, tp, layers=None, quantize=False):
        slug = re.sub(r"\W+", "_", label)
        return {"label": label, "dp": dp, "tp": tp, "quantize": quantize,
                "layers": layers, "prompts": prompts,
                "out": str(home / f"mh_{slug}_rank{{rank}}.pt")}

    runs = {label: run(label, dp, tp, MH_SHALLOW_LAYERS)
            for label, dp, tp in MH_LAYOUTS}
    for label, ref, int8 in MH_SHALLOW:
        runs[label] = run(label, 1, 2, MH_SHALLOW_LAYERS, int8)
        runs[ref] = run(ref, 1, 1, MH_SHALLOW_LAYERS, int8)
    one = {}
    for label in ("one process", *(ref for _, ref, _ in MH_SHALLOW)):
        if not runs[label]["quantize"]:
            runs[label]["emulated_out"] = runs[label]["out"].format(
                rank="_tp2_partial_sums")
        one[label] = r = multihost_run(fa, runs[label])
        mh_log(label, [r])
        layers = runs[label]["layers"] or 32
        check(r["launches"]["flash_fwd"] == r["n_calls"] == layers
              and r["calls"] == [mh_shape(1, 1)[1:]], (label, r["calls"]))
    return ({"runs": runs, "one": one, "fours": [runs["dp=2 x tp=2"]]},
            [runs["tp=2"], *(runs[label] for label, _, _ in MH_SHALLOW)])


def mh_log(label: str, ranks: list[dict]) -> None:
    for r in ranks:
        comm = r["step_comm"]
        log(f"phase 21 {label} rank {r['rank']}: load {r['load_s']:.2f} s "
            f"({r['loaded']} B allocated, weight_bytes {r['weight_bytes']}),"
            f" prefill {r['prefill_s']:.3f} s, decode "
            f"{r['decode_tokens'] / r['decode_s']:.1f} tok/s "
            f"({r['decode_tokens']} tokens in {r['decode_s']:.3f} s), peak "
            f"{r['peak_gb']:.2f} GB over the run; one decode step's "
            f"collectives: {comm_line(comm) if comm else 'none'}; K1 "
            f"{r['launches']['flash_fwd']} launches at {r['calls']}")


def mh_check(label: str, run: dict, ranks: list[dict], one: dict,
             emulated: str | None = None) -> dict:
    """One layout of phase 21 against one process (``one``, at the same
    depth and weights): identical tokens on every rank, K1 once per layer
    at the rank's shape, logits within MH_LOGITS_REL_TOL at 32 layers and
    MH_SHALLOW_REL_TOL at fewer, first tokens equal where one process's
    top-2 margin exceeds twice the logit gap (int8: every token), weight
    memory within MH_WEIGHT_SHARE, int8 blocks bitwise.  ``emulated``: one
    process's logits under ``tp2_partial_sums``, whose gap to the
    layout's is printed beside one process's and must be 0."""
    mh_log(label, ranks)
    layers = run["layers"] or 32
    shallow = run["layers"] is not None
    tol = MH_SHALLOW_REL_TOL if shallow else MH_LOGITS_REL_TOL
    dp, tp = run["dp"], run["tp"]
    rows = len(MH_PROMPT_LENS) // dp
    ids = ranks[0]["ids"]
    check(all(r["ids"] == ids for r in ranks), f"phase 21 {label}: ranks' "
          "tokens differ")
    want_call = (rows, MH_PAD, MH_PAD, 32 // tp, 32 // tp, 128, True)
    for r in ranks:
        check(r["launches"] == {"flash_fwd": layers, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}
              and [tuple(c) for c in r["calls"]] == [want_call]
              and r["n_calls"] == layers,
              (label, r["rank"], r["launches"], r["calls"]))
        share = r["loaded"] / one["weight_bytes"]
        log(f"phase 21 {label} rank {r['rank']}: memory after loading "
            f"{share:.4f} of one process's weight bytes (at most "
            f"{MH_WEIGHT_SHARE})")
        check(share <= MH_WEIGHT_SHARE, (label, r["rank"], share))
    whole = torch.load(one["out"], weights_only=True)
    emu = (torch.load(emulated, weights_only=True) if emulated is not None
           else None)
    worst = worst_emu = 0.0
    for r in ranks:
        start, stop = r["rows"]
        got = torch.load(run["out"].format(rank=r["rank"]), weights_only=True)
        want = whole[start:stop]
        gap = (got - want).abs().amax(dim=-1)
        rel = (gap.max() / want.abs().max()).item()
        worst = max(worst, rel)
        if emu is not None:
            worst_emu = max(worst_emu, ((got - emu[start:stop]).abs().max()
                                        / want.abs().max()).item())
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        for i in range(stop - start):
            row = start + i
            n = MH_PROMPT_LENS[row]
            agree = next((j for j, (a, b) in enumerate(zip(
                ids[row][n:], one["ids"][row][n:])) if a != b), MH_NEW)
            held = margin[i].item() > 2 * gap[i].item()
            log(f"  {label} rank {r['rank']} row {row} ({n} tokens): max "
                f"|d logit| {gap[i].item():.4e}, one process's top-2 "
                f"margin {margin[i].item():.4e}; first token "
                f"{ids[row][n]} against {one['ids'][row][n]} "
                f"({'held' if held else 'not held: margin under 2 gaps'});"
                f" stream agrees with one process for {agree} of {MH_NEW}")
            check(not held or ids[row][n] == one["ids"][row][n],
                  (label, row, ids[row][n], one["ids"][row][n]))
    log(f"phase 21 {label}: {len(ranks)} ranks' tokens identical; prefill "
        f"logits max rel err {worst:.3e} against one process (tol "
        f"{tol:g})" + ("" if emu is None else
                       f", {worst_emu:.3e} against one process with tp = "
                       "2's bf16 partial sums (tp2_partial_sums)"))
    check(math.isfinite(worst) and worst <= tol, (label, worst))
    if emu is not None:
        check(worst_emu == 0.0, (label, "against tp2_partial_sums", worst_emu))
    if shallow and run["quantize"]:
        same = sum(ids[row] == one["ids"][row]
                   for row in range(len(MH_PROMPT_LENS)))
        log(f"phase 21 {label}: {same} of {len(MH_PROMPT_LENS)} streams "
            f"equal one process's at {layers} layers (held: all, int8)")
        check(same == len(MH_PROMPT_LENS), (label, "streams", same))
    if run["quantize"]:
        want = one["tp2_digests"]
        same = all(r["digests"][n] == blocks[r["rank"]]
                   for r in ranks for n, blocks in want.items())
        log(f"phase 21 {label}: the int8 q and scale blocks of "
            f"{len(want)} kernels on {len(ranks)} ranks "
            f"{'bitwise equal' if same else 'DIFFER from'} the local blocks "
            "of one process's whole-tensor quantization (SHA-256)")
        check(same and all(set(r["digests"]) == set(want) for r in ranks),
              f"phase 21 {label}: int8 blocks")
    return {"ranks": ranks, "launches": sum(r["launches"]["flash_fwd"]
                                            for r in ranks),
            "decode_tok_s": min(r["decode_tokens"] / r["decode_s"]
                                for r in ranks),
            "load_s": max(r["load_s"] for r in ranks),
            "prefill_s": max(r["prefill_s"] for r in ranks)}


def mh_finish(prep: dict, twos: list[list], fours: list[list]) -> dict:
    """Phase 21's checks: tp = 2 and the MH_SHALLOW layouts from the gang
    of 2, dp = 2 x tp = 2 from the gang of 4, each against one process at
    its depth and weights."""
    runs, one = prep["runs"], prep["one"]
    jobs = {"tp=2": ([r[0] for r in twos], "one process"),
            **{label: ([r[i] for r in twos], ref)
               for i, (label, ref, _) in enumerate(MH_SHALLOW, 1)},
            "dp=2 x tp=2": ([r[0] for r in fours], "one process")}
    out = {"one process": {"launches": one["one process"]["launches"][
                               "flash_fwd"],
                           "load_s": one["one process"]["load_s"],
                           "prefill_s": one["one process"]["prefill_s"],
                           "decode_tok_s": one["one process"]["decode_tokens"]
                           / one["one process"]["decode_s"]},
           **{ref: {"launches": one[ref]["launches"]["flash_fwd"]}
              for _, ref, _ in MH_SHALLOW}}
    for label, (ranks, ref) in jobs.items():
        for j in ranks:
            check(j["rc"] == 0, (label, j["rc"]))
        out[label] = mh_check(label, runs[label], [j["extra"] for j in ranks],
                              {**one[ref],
                               "out": runs[ref]["out"].format(rank=0)},
                              runs[ref].get("emulated_out"))
    return out


def mh_numbers(fa, mh: dict) -> list[dict]:
    """K1 rows of phase 21: each layout's rank shape with its launches
    (the MH_SHALLOW layouts' at the same shapes, MH_SHALLOW_LAYERS
    layers)."""
    rows = []
    for (label, dp, tp), shape in zip(MH_LAYOUTS, MH_SHAPES):
        name, *dims = shape
        ms, plain_ms, library_ms = k1_times(fa, *dims)
        row = {"shape": name, "launches": mh[label]["launches"], "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **bound_fields("flash_fwd", tuple(dims), torch.bfloat16)}
        log(f"flash_fwd {name} bf16 (x{row['launches']} in phase 21 "
            f"{label}): kernel {ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms")
        rows.append(row)
        if dp == 1:
            for label, ref, _ in MH_SHALLOW:
                shallow = label if tp == 2 else ref
                rows.append(with_launches(row, mh[shallow]["launches"],
                                          f"phase 21 {shallow}"))
    return rows


@contextlib.contextmanager
def held_admission(engine):
    """Hold ``engine``'s scheduling loop at the top of its next step until
    the block ends, so that every request submitted inside it is admitted
    in one step: a run's co-batching (and with it each decode GEMM's M)
    does not depend on when the client threads got there.  A gang's
    leader is woken first (its loop may sit in the idle wait)."""
    entered, gate = threading.Event(), threading.Event()
    step = engine._step

    def held():
        entered.set()
        gate.wait()
        engine._step = step
        return step()

    engine._step = held
    if engine._gang:
        with engine._work:
            engine._work.notify_all()
        check(entered.wait(60), "the leader's loop reached its next step")
    try:
        yield
    finally:
        gate.set()


def predictor_run(fa, run: dict, comm: dict | None = None) -> dict:
    """One run of phase 22 in this process (one process, or a rank of a
    gang whose collectives ``comm`` records): ``GenerativePredictor`` of
    ``run``'s layout, rank 0 driving the traffic (over HTTP when ``run``
    says so) while the others ``follow``, with the kernels' counts set to
    0 just before the traffic and read just after.  Each forward is
    entered after a ``synchronize``.  With ``run["emulate"]`` (one
    process) the traffic runs under ``tp2_partial_sums``.  Writes the
    rank's first-token logits by prompt length to ``run["out"]``;
    returns the streams (every request the rank's engine ran, in arrival
    order), launches, K1 calls, TTFTs, decode rate, the step records'
    broadcasts and one decode step's collectives, load time, memory and
    the cache's heads.  ``run["quantize"]`` serves int8 weights, and
    ``run["digests"]`` returns their expert blocks' digests
    (``int8_expert_digests``); ``run["pages_out"]`` saves each cold
    prompt's committed pages (every KV head, by prompt length) there."""
    from kubeflow_tpu_torch.parallel import distributed as pd
    from kubeflow_tpu_torch.serving import engine as eng
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp)
    from kubeflow_tpu_torch.serving.quant import quantized_bytes

    rank = pd.rank_of(pd.default_group())
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    config = {} if run["layers"] is None else {"num_layers": run["layers"]}
    if run["moe"]:
        config["moe_experts"] = MOE_EXPERTS
    t0 = time.perf_counter()
    pred = GenerativePredictor(
        "llama", size="7b", tp=run["tp"], ep=run["ep"], max_seq=MAX_SEQ,
        prefill_chunk=PREFILL_CHUNK, max_batch=4, seed=0,
        prefix_cache_mb=run["cache_mb"], model_config=config,
        quantize=run.get("quantize", False))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = torch.cuda.memory_allocated() - base
    e = pred.engine
    kv = [t for l in e.view for t in l.values()]
    if e.pool.kv is not None:
        kv += [t for l in e.pool.kv["layers"] for t in l.values()]
    cache_bytes = sum(t.numel() * t.element_size() for t in kv)
    seen, logits, stamps, calls = [], {}, [], []
    enqueue, forward = e._enqueue_locked, pred.module.forward
    sample = eng.sample_rows

    def enqueued(req):
        enqueue(req)
        seen.append(req)

    def sampled(x, reqs, gens):
        if x.shape[0] == 1:   # a prefill's first token (a repeat's: not kept)
            logits.setdefault(len(reqs[0].ids), x[0].float().cpu())
        return sample(x, reqs, gens)

    def entered(ids, *args, **kwargs):
        torch.cuda.synchronize()
        stamps.append((tuple(ids.shape), time.perf_counter(),
                       json.loads(json.dumps(comm or {}))))
        return forward(ids, *args, **kwargs)

    e._enqueue_locked, eng.sample_rows = enqueued, sampled
    pred.module.forward = entered
    pages, commit = {}, e._commit_and_insert

    def committed(ids, usable, node, scratch, for_handoff=False):
        got = commit(ids, usable, node, scratch, for_handoff)
        if node is None and len(ids) not in pages:
            # a cold prompt's pages: the scratch rows they were cut from
            end = -(-len(ids) // e.page_size) * e.page_size
            pages[len(ids)] = [{n: l[n][0, :end].reshape(
                (-1, e.page_size) + tuple(l[n].shape[2:])).to(
                    "cpu", copy=True) for n in ("k", "v")} for l in scratch]
        return got

    if run.get("pages_out"):
        e._commit_and_insert = committed
    emulate = (tp2_partial_sums(pred.module, columns=True)
               if run.get("emulate") else contextlib.nullcontext())
    records0 = dict(e.record_tally)
    with flash_route(recording_flash(fa, calls)), emulate:
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t1 = time.perf_counter()
        if rank == 0:
            bodies = [{"ids": [p], "max_new_tokens": NEW_TOKENS}
                      for p in run["prompts"]]
            if run["http"]:
                httpd, thread = serve(PredictorApp({"llama": pred}), 0)
                port = httpd.server_port
                results: list = []
                with held_admission(e):
                    client = threading.Thread(target=lambda: results.extend(
                        concurrent_round(port, bodies)))
                    client.start()
                    while len(e._pending) + len(e.queue) < len(bodies):
                        time.sleep(0.001)
                client.join(timeout=600)
                results.append(post(port, "/v1/models/llama:generate",
                                    bodies[P22_WARM]))
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=10)
                check(all(r[0] == 200 for r in results),
                      [r[0] for r in results])
            else:
                with held_admission(e):
                    reqs = [e.submit(p, NEW_TOKENS) for p in run["prompts"]]
                for r in reqs:
                    r.result(timeout=600)
                if run["warm"]:
                    e.submit(run["prompts"][P22_WARM],
                             NEW_TOKENS).result(timeout=600)
            stats = e.stats()
            e.shutdown()
        else:
            pred.follow()
            stats = e.stats()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = counters(fa)                           # it ended
    e._enqueue_locked, eng.sample_rows = enqueue, sample
    pred.module.forward = forward
    e._commit_and_insert = commit
    torch.save(logits, run["out"].format(rank=rank))
    if run.get("pages_out"):
        torch.save(pages, run["pages_out"])
    # one decode step's collectives: between the second and third forwards
    # of 4 rows by one token (the first decode chunk)
    steps = [(t, c) for shape, t, c in stamps if shape == (4, 1)]
    step_comm = {}
    if len(steps) >= 3:
        (_, c1), (_, c2) = steps[1], steps[2]
        step_comm = {kind: {k: v - c1.get(kind, {}).get(k, 0)
                            for k, v in rec.items()}
                     for kind, rec in c2.items()}
    timing = stats["timing"]
    records = {k: v - records0.get(k, 0) for k, v in e.record_tally.items()}
    out = {"rank": rank, "launches": launches,
           "calls": sorted(set(map(tuple, calls))), "n_calls": len(calls),
           "streams": [[r._seq, r.ids + r.generated, r.outcome]
                       for r in seen],
           "ttft_s": {len(r.ids): r.first_token_at - r.submitted_at
                      for r in seen if r.first_token_at is not None},
           "decode_tok_s": (timing["decode_tokens"] / timing["decode_seconds"]
                            if timing["decode_seconds"] else 0.0),
           "records": records, "wall_s": t2 - t1, "load_s": load_s,
           "loaded": loaded, "cache_bytes": cache_bytes,
           "weight_bytes": quantized_bytes(pred.module),
           "kv_heads": sorted({t.shape[2] for t in kv}),
           "pool_rows": (None if e.pool.kv is None else
                         e.pool.kv["layers"][0]["k"].shape[0]),
           "kv_pool": stats["kv_pool"], "step_comm": step_comm,
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    if run.get("digests"):
        out["int8_digests"] = int8_expert_digests(pred.module)
    del pred, e, kv
    free_memory()
    return out


def residency_run(fa, run: dict, comm: dict | None = None) -> dict:
    """Phase 22(c) on one rank of the gang of 2: a (dense, tp=2, a small
    prefix cache) and b (MoE, ep=2) under ``run["budget"]``; rank 0 wires
    the ``ModelPool``, serves both over HTTP and sends a, then b (the
    budget parks a), then with b pinned a's load, then a's long prompt
    with every free page of a's pool held on every rank (page pressure:
    b, idle, parks and its bytes become a's page slots), then b again
    (the budget parks a, b's load reclaims a's free donated slots).  b's
    never-parked stream is taken first, on b directly.  The followers
    follow a and b in a thread each, and hold and free the same pages
    between the same barriers.  Every rank logs its parks (bytes freed,
    its blocks' bytes, the fall of ``memory_allocated``), warms
    (seconds, whether weights loaded), donations, reclaims and finished
    requests with their page pool's statistics, and K1's calls."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import distributed as pd
    from kubeflow_tpu_torch.serving import model_pool as mp
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp,
                                                      wire_model_pool)

    rank = pd.rank_of(pd.default_group())
    free_memory()
    events: list = []
    lock = threading.Lock()

    def note(*rec):
        with lock:
            events.append(list(rec))

    def pool_stats(e):
        stats = e.pool.stats()
        stats.pop("fault_wait_seconds")
        return stats

    def build(name, tp, ep, config, cache_mb):
        t0 = time.perf_counter()
        pred = GenerativePredictor(
            "llama", size="7b", tp=tp, ep=ep, max_seq=MAX_SEQ,
            prefill_chunk=PREFILL_CHUNK, max_batch=4, seed=0,
            prefix_cache_mb=cache_mb, model_config=config)
        torch.cuda.synchronize()
        note(name, "built", time.perf_counter() - t0, pred.weight_bytes,
             pred.rank_weight_bytes)
        pred.name = name
        e = pred.engine
        park, warm = pred._park_here, pred._warm_here

        def parked():
            torch.cuda.synchronize()
            block = pred.rank_weight_bytes
            before = torch.cuda.memory_allocated()
            freed = park()
            torch.cuda.synchronize()
            note(name, "park", freed, block,
                 before - torch.cuda.memory_allocated())
            return freed

        def warmed():
            torch.cuda.synchronize()
            t, loads = time.perf_counter(), pred.parked
            out = warm()
            torch.cuda.synchronize()
            note(name, "warm", out, loads, time.perf_counter() - t,
                 pred.rank_weight_bytes)
            return out

        pred._park_here, pred._warm_here = parked, warmed
        for what in ("donate", "reclaim"):
            def counted(n, fn=getattr(e.pool, what), what=what):
                out = fn(n)
                note(name, what, n, out, pool_stats(e))
                return out
            setattr(e.pool, what, counted)
        finish = e._finish_if_done

        def finished(slot):
            req = e.slots[slot]
            finish(slot)
            if req is not None and e.slots[slot] is None:
                note(name, "done", req.ids + req.generated, pool_stats(e))

        e._finish_if_done = finished
        return pred

    a = build("a", 2, 1, {"num_layers": run["layers"]}, P22_RES_CACHE_MB)
    b = build("b", 1, 2, {"num_layers": run["layers"],
                          "moe_experts": MOE_EXPERTS}, 0)
    preds = {"a": a, "b": b}
    held: list = []

    def hold(pages: bool) -> None:
        # every rank holds (then frees) the same pages of a's pool: the
        # pools are in lockstep, and a's engine is idle between the
        # barriers once it has finished a's first request here too
        while sum(e[:2] == ["a", "done"] for e in events) < 1:
            time.sleep(0.001)
        dist.barrier()
        if pages:
            held.extend(a.engine.pool.alloc(a.engine.pool.free_count))
        else:
            a.engine.pool.decref(held)
        dist.barrier()

    calls: list = []
    out: dict = {"rank": rank}
    with flash_route(recording_flash(fa, calls)):
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t1 = time.perf_counter()
        if rank == 0:
            k0 = counters(fa)["flash_fwd"]
            out["b_never_parked"] = b.generate(
                [run["prompt_b"]], max_new_tokens=NEW_TOKENS)["ids"][0]
            out["b_never_parked_k1"] = counters(fa)["flash_fwd"] - k0
            pool = wire_model_pool(preds, run["budget"])
            httpd, thread = serve(PredictorApp(preds, model_pool=pool), 0)
            port = httpd.server_port
            results = out["requests"] = []

            def request(label, name, prompt):
                k0, t = counters(fa)["flash_fwd"], time.perf_counter()
                status, body = post(port, f"/v1/models/{name}:generate",
                                    {"ids": [prompt],
                                     "max_new_tokens": NEW_TOKENS})
                results.append({
                    "label": label, "model": name, "status": status,
                    "ids": body.get("ids", [None])[0],
                    "error": body.get("error"),
                    "s": time.perf_counter() - t,
                    "k1": counters(fa)["flash_fwd"] - k0,
                    "pool": pool.stats(),
                    "residency": {n: pool.state_of(n) for n in preds}})

            try:
                request("a", "a", run["prompts_a"][0])
                request("b (parks a)", "b", run["prompt_b"])
                pool.acquire("b")          # b pinned while a loads
                pool.acquire("a")
                pool.release("b")
                hold(True)
                request("a under page pressure (parks b, donates)", "a",
                        run["prompts_a"][1])
                pool.release("a")
                request("b again (parks a, reclaims, warms)", "b",
                        run["prompt_b"])
                hold(False)
                out["pool"] = pool.stats()
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=10)
                for p in preds.values():
                    p.engine.shutdown()
                mp.set_model_pool(None)
        else:
            errors: list = []

            def follow(p):
                try:
                    p.follow()
                except Exception as err:  # noqa: BLE001 - reported
                    errors.append(f"{p.name}: {type(err).__name__}: {err}")

            threads = [threading.Thread(target=follow, args=(p,))
                       for p in preds.values()]
            for t in threads:
                t.start()
            hold(True)
            hold(False)
            for t in threads:
                t.join()
            out["errors"] = errors
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t1
        out["launches"] = counters(fa)                    # it ended
    out.update(events=events, calls=[list(c) for c in calls],
               tally={n: dict(p.engine.record_tally)
                      for n, p in preds.items()},
               bytes={n: p.weight_bytes for n, p in preds.items()})
    del a, b, preds
    free_memory()
    return out


def int8_expert_digests(module) -> dict[str, list[str]]:
    """SHA-256 of every int8 expert weight's ``q`` and ``scale`` by ep
    block (``"<name> ep <i>"``): a whole (one-process) model's
    ``P22_INT8_EP`` slices along the experts dim, a gang rank's own
    block.  The blocks hash in threads (the copy to the host and
    ``hashlib`` release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from kubeflow_tpu_torch.serving.quant import QTensor

    blocks = {}
    for name, qt in module.named_modules():
        if not (isinstance(qt, QTensor)
                and name.endswith(("moe.w_in", "moe.w_out"))):
            continue
        split = qt.ep_split
        if split is not None:
            blocks[f"{name} ep {split.index}"] = [qt.q, qt.scale]
            continue
        n = qt.q.shape[0] // P22_INT8_EP
        for i in range(P22_INT8_EP):
            blocks[f"{name} ep {i}"] = [qt.q[i * n:(i + 1) * n],
                                        qt.scale[i * n:(i + 1) * n]]
    with ThreadPoolExecutor(4) as pool:
        hashed = {k: [pool.submit(sha256_of, t) for t in ts]
                  for k, ts in blocks.items()}
    return {k: [f.result() for f in fs] for k, fs in hashed.items()}


def disagg_run(fa, run: dict, comm: dict | None = None) -> dict:
    """Phase 22(d) on one rank of the gang of 2: the 2-layer dense model
    as a decode-role and a prefill-role tp=2 predictor, built in that
    order on every rank.  Rank 0 sends ``run["prompts"]`` to the prefill
    gang with a decode peer: each handoff's body crosses the prefill's
    ``handoff_post`` seam (a JSON round trip, then the decode predictor's
    ``:resume``); then ``run["no_peer"]`` without one.  The follower
    follows both models, a thread each.  Returns each handoff's hops on
    rank 0 (the gather's seconds and bytes, ``serialize_handoff``'s
    seconds, the body's JSON bytes, the POST's wall seconds, the decode
    leader's deserialize seconds and its page broadcast's seconds and
    bytes), the streams, K1's launches and calls, both engines' step
    records and page pools at the end; rank 0 saves every body's pages
    (decoded, every KV head, by prompt length) to ``run["pages_out"]``."""
    from kubeflow_tpu_torch.parallel import distributed as pd
    from kubeflow_tpu_torch.serving import disagg
    from kubeflow_tpu_torch.serving.page_pool import NULL_PAGE
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    rank = pd.rank_of(pd.default_group())
    free_memory()
    bodies, hops, states = {}, {}, []

    def build(role, **kw):
        return GenerativePredictor(
            "llama", size="7b", tp=2, max_seq=MAX_SEQ,
            prefill_chunk=PREFILL_CHUNK, max_batch=4, seed=0, role=role,
            model_config={"num_layers": run["layers"]}, **kw)

    def post(addr, path, payload, timeout=300.0):
        # the POST: the body through JSON, to the decode gang's :resume
        t0 = time.perf_counter()
        raw = json.dumps(payload)
        body = json.loads(raw)
        got = dec.resume(body)
        n = len(body["ids"])
        bodies[n] = body["pages"]
        hops[n] = {"body_bytes": len(raw),
                   "resume_s": time.perf_counter() - t0,
                   **{k: got[k] for k in ("deserialize_s", "broadcast_s",
                                          "broadcast_bytes")}}
        return got

    t0 = time.perf_counter()
    dec = build("decode")
    pre = build("prefill", handoff_post=post)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    capture = pre.engine.handoff_fn

    def captured(req, state):
        states.append(state)
        capture(req, state)

    pre.engine.handoff_fn = captured
    calls: list = []
    out: dict = {"rank": rank, "load_s": load_s}
    with flash_route(recording_flash(fa, calls)):
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
        t1 = time.perf_counter()
        if rank == 0:
            try:
                out["streams"] = pre.generate(
                    run["prompts"], max_new_tokens=NEW_TOKENS,
                    decode_peer="decode:0")["ids"]
                out["no_peer"] = pre.generate(
                    [run["no_peer"]], max_new_tokens=NEW_TOKENS)["ids"][0]
                out["stats"] = {"prefill": pre.engine.stats(),
                                "decode": dec.engine.stats()}
            finally:
                for p in (pre, dec):
                    p.engine.shutdown()
        else:
            errors: list = []

            def follow(p):
                try:
                    p.follow()
                except Exception as err:  # noqa: BLE001 - reported
                    errors.append(f"{p.role}: {type(err).__name__}: {err}")

            threads = [threading.Thread(target=follow, args=(p,))
                       for p in (pre, dec)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["errors"] = errors
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t1
        out["launches"] = counters(fa)                    # it ended
    out["calls"] = [list(c) for c in calls]
    # the forwarded handoffs, in prompt order, then the one resumed here
    out["hops"] = [{"prompt": len(st.ids), **st.timing,
                    **(hops.get(len(st.ids), {}) if i < len(run["prompts"])
                       else {})} for i, st in enumerate(states)]
    pools = {}
    for label, p in (("prefill", pre), ("decode", dec)):
        stats = p.engine.pool.stats()
        stats.pop("fault_wait_seconds")
        pools[label] = {"stats": stats, "held": len(p.engine._held),
                        "used": [i for i, r in enumerate(p.engine.pool._refs)
                                 if r > 0 and i != NULL_PAGE]}
    out.update(pools=pools, tally={"prefill": dict(pre.engine.record_tally),
                                   "decode": dict(dec.engine.record_tally)})
    if rank == 0:
        torch.save({n: [{name: torch.stack([disagg._decode_array(
            page[li][name]) for page in pages]) for name in pages[0][li]}
            for li in range(len(pages[0]))] for n, pages in bodies.items()},
            run["pages_out"])
    del pre, dec, states, bodies
    free_memory()
    return out


def whole_weight_bytes(config: dict) -> int:
    """Bytes of one process's bf16 weights of the 7B Llama of
    ``config`` (a storage-less build)."""
    from kubeflow_tpu_torch.models import registry

    model = registry.get("llama").make_model(size="7b", device="meta",
                                             param_dtype="compute", **config)
    return sum(p.numel() * p.element_size() for p in model.parameters())


def p22_keyed(streams: list) -> dict:
    """A run's streams by (prompt length, occurrence): the re-sent prompt
    is ``(n, 1)``."""
    out: dict = {}
    for _, ids, outcome in streams:
        n = len(ids) - NEW_TOKENS
        key = (n, sum(1 for k in out if k[0] == n))
        out[key] = (ids, outcome)
    return out


def p22_prepare(fa, home: Path, phase2: dict) -> tuple[dict, list]:
    """Phase 22's runs: the one-process references here (the dense model
    at MH_SHALLOW_LAYERS layers under ``tp2_partial_sums`` and the MoE
    one), phase 2's first-token logits; the gang of 2's section (tp=2,
    its 2-layer twin, MoE ep=2) and the gang of 4's (MoE tp=2 x ep=2)."""
    rng = np.random.default_rng(22)
    dense = [b["ids"][0] for b in serving_bodies(P22_VOCAB, 0)]
    moe = [rng.integers(1, P22_VOCAB, n).tolist() for n in P22_MOE_LENS]

    def run(label, tp, ep, layers, is_moe, http, **kw):
        slug = re.sub(r"\W+", "_", label)
        return {"label": label, "tp": tp, "ep": ep, "layers": layers,
                "moe": is_moe, "http": http, "warm": not is_moe,
                "cache_mb": 0 if is_moe else P22_CACHE_MB,
                "prompts": moe if is_moe else dense,
                "out": str(home / f"p22_{slug}_rank{{rank}}.pt"), **kw}

    runs = {label: run(label, *rest) for label, *rest in P22_LAYOUTS}
    # (d)'s int8 MoE: one request, at ep=2 in the gang and here
    int8 = dict(quantize=True, digests=True, prompts=moe[:1], warm=False)
    runs["MoE int8 ep=2"] = run("MoE int8 ep=2", 1, 2, MH_SHALLOW_LAYERS,
                                True, False, **int8)
    one = {}
    for label, is_moe, kw in (
            ("2-layer one process (tp2_partial_sums)", False,
             {"emulate": True,
              "pages_out": str(home / "p22_one_pages.pt")}),
            ("2-layer one process", False, {}),
            ("MoE one process", True, {}),
            ("MoE int8 one process", True, int8)):
        runs[label] = run(label, 1, 1, MH_SHALLOW_LAYERS, is_moe, False,
                          **kw)
        one[label] = predictor_run(fa, runs[label])
        p22_log(label, [one[label]])
        free_memory()
    phase2_out = str(home / "p22_phase2.pt")
    torch.save({n: t for n, t in phase2["first_logits"].items()}, phase2_out)
    one["phase 2"] = {"out": phase2_out, "streams": phase2["streams"]}
    sizes = [whole_weight_bytes(config) for config in (
        {"num_layers": MH_SHALLOW_LAYERS},
        {"num_layers": MH_SHALLOW_LAYERS, "moe_experts": MOE_EXPERTS})]
    residency = {"residency": True, "layers": MH_SHALLOW_LAYERS,
                 "prompts_a": [dense[i] for i in P22_RES_A],
                 "prompt_b": moe[0], "sizes": sizes,
                 "budget": (max(sizes) + sum(sizes)) // 2}
    log(f"phase 22(c): a {sizes[0]} B, b {sizes[1]} B of weights (whole "
        f"models), weight budget {residency['budget']} B "
        f"({residency['budget'] / (1 << 20):.1f} MB)")
    disagg = {"disagg": True, "layers": MH_SHALLOW_LAYERS, "prompts": dense,
              "no_peer": dense[P22_NO_PEER],
              "pages_out": str(home / "p22_disagg_pages.pt")}
    return ({"runs": runs, "one": one, "residency": residency,
             "disagg": disagg, "fours": [runs["MoE tp=2 x ep=2"]]},
            [runs[label] for label in ("tp=2", "2-layer tp=2", "MoE ep=2")]
            + [residency, runs["MoE int8 ep=2"], disagg])


def p22_log(label: str, ranks: list[dict]) -> None:
    for r in ranks:
        rec = r["records"]
        per = (f"{rec['seconds'] / rec['records'] * 1e3:.3f} ms and "
               f"{rec['calls'] / rec['records']:.2f} broadcasts per step "
               f"over {rec['records']} steps" if rec.get("records")
               else "none (one process)")
        log(f"phase 22 {label} rank {r['rank']}: load {r['load_s']:.2f} s "
            f"({r['loaded']} B allocated: weights {r['weight_bytes']} B, KV "
            f"view and pool {r['cache_bytes']} B at {r['kv_heads']} KV "
            f"heads); TTFT ms " + " ".join(
                f"{n}:{t * 1e3:.1f}" for n, t in sorted(r["ttft_s"].items()))
            + f"; decode {r['decode_tok_s']:.1f} tok/s; step records {per}; "
            f"one decode step's collectives: "
            f"{comm_line(r['step_comm']) if r['step_comm'] else 'none'}; "
            f"K1 {r['launches']['flash_fwd']} launches at {len(r['calls'])} "
            f"shapes; peak {r['peak_gb']:.2f} GB; wall {r['wall_s']:.2f} s")


def p22_logits_gap(label: str, got: dict, want: dict, streams: dict,
                   want_streams: dict, tol: float | None) -> float:
    """First-token logits of a layout against its one-process reference
    (by prompt length), relative to max |logit|: bitwise when ``tol`` is
    None; each first token held where the reference's top-2 margin
    exceeds twice the row's gap.  Returns the worst gap."""
    worst = 0.0
    for n, w in sorted(want.items()):
        g = got[n]
        gap = (g - w).abs().max().item()
        rel = gap / w.abs().max().item()
        worst = max(worst, rel)
        top2 = w.topk(2).values
        margin = (top2[0] - top2[1]).item()
        held = margin > 2 * gap
        key = (n, 0)
        mine, ref = streams[key][0], want_streams.get(key, (None,))[0]
        first = (mine[n], None if ref is None else ref[n])
        log(f"  phase 22 {label} {n} tokens: first-token logits max |d| "
            f"{gap:.4e} ({rel:.3e} of max |logit|), top-2 margin "
            f"{margin:.4e}; first token {first[0]} against {first[1]} "
            f"({'held' if held else 'not held: margin under 2 gaps'})")
        if tol is None:
            check(torch.equal(g, w), (label, n, "logits not bitwise"))
        elif ref is not None:
            check(not held or first[0] == first[1], (label, n, first))
    return worst


def p22_finish(prep: dict, twos: list[list], fours: list[list]) -> dict:
    """Phase 22's checks: every rank's streams identical and complete, K1
    once per layer and chunk at the rank's heads, the rank's weights and
    KV heads, the first-token logits against one process's (tp=2:
    phase 2's within P22_REL_TOL; the 2-layer twin bitwise under
    ``tp2_partial_sums`` with every token; MoE ep=2 bitwise with every
    token; MoE tp=2 x ep=2 within P22_REL_TOL), the warm stream against
    its cold one."""
    runs, one = prep["runs"], prep["one"]
    jobs = {label: [r[i] for r in twos] for i, label in
            enumerate(("tp=2", "2-layer tp=2", "MoE ep=2"))}
    jobs["MoE tp=2 x ep=2"] = [r[0] for r in fours]
    out = {}
    for label, tp, ep, layers, is_moe, _ in P22_LAYOUTS:
        for j in jobs[label]:
            check(j["rc"] == 0, (label, j["rc"]))
        ranks = [j["extra"] for j in jobs[label]]
        run = runs[label]
        p22_log(label, ranks)
        lead = ranks[0]
        check(all(r["streams"] == lead["streams"] for r in ranks),
              f"phase 22 {label}: ranks' streams differ")
        check(all(s[2] == "ok" for s in lead["streams"]),
              (label, [s[2] for s in lead["streams"]]))
        depth = layers or 32
        chunks = p22_chunks(label)
        h, hkv, d = P22_HEADS
        want_calls = sorted({(1, sq, sk, h // tp, hkv // tp, d, True)
                             for sq, sk in chunks})
        config = {} if layers is None else {"num_layers": layers}
        if is_moe:
            config["moe_experts"] = MOE_EXPERTS
        whole = whole_weight_bytes(config)
        for r in ranks:
            check(r["launches"] == {"flash_fwd": depth * len(chunks),
                                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
                  and r["n_calls"] == depth * len(chunks)
                  and [tuple(c) for c in r["calls"]] == want_calls,
                  (label, r["rank"], r["launches"], r["calls"]))
            check(r["kv_heads"] == [hkv // tp], (label, r["kv_heads"]))
            share = r["weight_bytes"] / whole
            rest = (r["loaded"] - r["cache_bytes"]) / whole
            log(f"phase 22 {label} rank {r['rank']}: weights {share:.4f} of "
                f"one process's {whole} B, memory after loading less the KV "
                f"view and pool {rest:.4f}" + (f" (at most {MH_WEIGHT_SHARE})"
                                               if tp > 1 else ""))
            if tp > 1:
                check(share <= MH_WEIGHT_SHARE and rest <= MH_WEIGHT_SHARE,
                      (label, r["rank"], share, rest))
        mine = p22_keyed(lead["streams"])
        got = torch.load(run["out"].format(rank=0), weights_only=True)
        for r in ranks[1:]:
            other = torch.load(run["out"].format(rank=r["rank"]),
                               weights_only=True)
            check(all(torch.equal(other[n], got[n]) for n in got),
                  (label, r["rank"], "first-token logits differ by rank"))
        if label == "tp=2":
            ref = one["phase 2"]
            want = torch.load(ref["out"], weights_only=True)
            want_streams = {(len(ids) - NEW_TOKENS, 0): (ids, "ok")
                            for i, ids in enumerate(ref["streams"])
                            if i != 3}          # phase 2's sampled request
            tol = P22_REL_TOL[label]
        else:
            name = P22_ONE[label]
            ref = one[name]
            want = torch.load(runs[name]["out"].format(rank=0),
                              weights_only=True)
            want_streams = p22_keyed(ref["streams"])
            tol = P22_REL_TOL.get(label)
        if label == "2-layer tp=2":
            # bitwise where every product ran at the rank's shapes; else
            # (a GEMM whose algorithm changed with N at a chunk's M) the
            # 2-layer tolerance and every first token margin-gated
            exact = all(torch.equal(got[n], want[n]) for n in want)
            plain = torch.load(runs["2-layer one process"]["out"].format(
                rank=0), weights_only=True)
            gap = max(((got[n] - w).abs().max() / w.abs().max()).item()
                      for n, w in plain.items())
            log(f"phase 22 {label}: first-token logits "
                f"{'bitwise' if exact else 'NOT bitwise'} one process's "
                f"with every product at a tp = 2 rank's shapes "
                f"(tp2_partial_sums(columns=True)); {gap:.3e} of max "
                f"|logit| from one process's plain products")
            tol = None if exact else MH_SHALLOW_REL_TOL
        worst = p22_logits_gap(label, got, want, mine, want_streams, tol)
        same = sum(mine[k][0] == want_streams[k][0] for k in want_streams
                   if k in mine)
        log(f"phase 22 {label}: {len(ranks)} ranks' streams identical; "
            f"first-token logits {'bitwise' if tol is None else 'within'} "
            + ("" if tol is None else f"{worst:.3e} of max |logit| (tol "
               f"{tol:g}) of ") + f"one process's; {same} of "
            f"{len(want_streams)} streams equal one process's")
        if tol is None:
            check(same == len(want_streams) == len(mine),
                  (label, "streams", same))
        else:
            check(math.isfinite(worst) and worst <= tol, (label, worst))
        if run["warm"]:
            n = PROMPT_LENS[P22_WARM]
            cold, warm = mine[(n, 0)][0], mine[(n, 1)][0]
            log(f"phase 22 {label}: the re-sent {n}-token prompt (a prefix "
                f"hit) {'equals' if warm == cold else 'DIFFERS from'} its "
                f"cold stream; kv_pool at the end {lead['kv_pool']}")
            check(warm == cold, (label, "warm stream"))
        out[label] = {"ranks": ranks, "launches": sum(
            r["launches"]["flash_fwd"] for r in ranks),
            "load_s": max(r["load_s"] for r in ranks),
            "decode_tok_s": lead["decode_tok_s"],
            "ttft_s": lead["ttft_s"], "records": lead["records"]}
    out["residency"] = p22_residency_finish(
        prep["residency"], [r[3] for r in twos], out)
    out["int8"] = p22_int8_finish(prep, [r[4] for r in twos])
    out["disagg"] = p22_disagg_finish(prep, [r[5] for r in twos], out)
    return out


def p22_residency_finish(run: dict, jobs: list[dict], p22: dict) -> dict:
    """Phase 22(c)'s checks: every request served; a's streams bitwise
    the 2-layer tp=2 layout's never-parked ones (which are one process's
    under ``tp2_partial_sums``) and b's its own never-parked one; the
    budget parks a at b's request and at b's last one, the page pressure
    parks b and donates b's whole bytes over the page bytes, b's load
    reclaims the free donated slots, on both ranks alike (the same events
    and page pool statistics after every request, donation and reclaim);
    each park frees at least ``P22_RES_PARK_SHARE`` of the rank's blocks;
    K1 runs in every request's prefill, at the gang's rank shapes."""
    for j in jobs:
        check(j["rc"] == 0, ("residency", j["rc"]))
    ranks = [j["extra"] for j in jobs]
    lead = ranks[0]
    for r in ranks[1:]:
        check(r["errors"] == [], ("residency follower", r["errors"]))
    reqs = lead["requests"]
    for q in reqs:
        log(f"phase 22(c) {q['label']}: status {q['status']}, "
            f"{q['s'] * 1e3:.1f} ms, K1 launches {q['k1']}, residency "
            f"{q['residency']}, pool loads {q['pool']['loads_total']} "
            f"evictions {q['pool']['evictions_total']} donated pages "
            f"{q['pool']['donated_pages']}")
        check(q["status"] == 200, (q["label"], q["status"], q["error"]))
    # the streams: a's against the 2-layer tp=2 layout's cold ones
    dense = p22_keyed(p22["2-layer tp=2"]["ranks"][0]["streams"])
    a_want = [dense[(PROMPT_LENS[i], 0)][0] for i in P22_RES_A]
    got = {q["label"]: q["ids"] for q in reqs}
    a_same = [reqs[0]["ids"], reqs[2]["ids"]] == a_want
    b_never = lead["b_never_parked"]
    b_same = reqs[1]["ids"] == reqs[3]["ids"] == b_never
    moe = p22_keyed(p22["MoE ep=2"]["ranks"][0]["streams"])
    b_layout = moe[(len(run["prompt_b"]), 0)][0]
    log(f"phase 22(c): a's streams {'equal' if a_same else 'DIFFER FROM'} "
        f"the 2-layer tp=2 layout's; b's {'equal' if b_same else 'DIFFER'} "
        f"{'' if b_same else 'FROM '}its never-parked stream (which "
        f"{'equals' if b_never == b_layout else 'differs from'} the MoE "
        "ep=2 layout's, where 4 prompts shared the steps)")
    check(a_same, ("residency a streams", got))
    check(b_same, ("residency b streams", got, b_never))
    want_res = [{"a": "resident", "b": "parked"},
                {"a": "parked", "b": "resident"},
                {"a": "resident", "b": "parked"},
                {"a": "parked", "b": "resident"}]
    check([q["residency"] for q in reqs] == want_res,
          [q["residency"] for q in reqs])
    def shared(r, name):
        # what every rank logs alike of one model, in its engine's order:
        # parks and warms (not their memory and seconds), donations,
        # reclaims and finished requests with the page pool's statistics
        return [e[:3] if e[1] == "park" else e[:4] if e[1] == "warm" else e
                for e in r["events"] if e[0] == name
                and e[1] in ("park", "warm", "donate", "reclaim", "done")]
    for r in ranks[1:]:
        for name in ("a", "b"):
            check(shared(r, name) == shared(lead, name),
                  ("residency events differ by rank", name,
                   shared(r, name), shared(lead, name)))
    sizes = run["sizes"]
    page_nbytes = next(e[3] for e in lead["events"]
                       if e[:2] == ["a", "done"])["page_nbytes"]
    for r in ranks:
        evs = r["events"]
        parks = [e for e in evs if e[1] == "park"]
        check([e[0] for e in parks] == ["a", "b", "a"],
              ("parks", r["rank"], parks))
        for name, _, freed, block, fell in parks:
            share = fell / block
            log(f"phase 22(c) rank {r['rank']}: park of {name} freed "
                f"{fell} B of memory_allocated, {share:.4f} of its "
                f"{block} B of blocks (whole model {freed} B)")
            check(share >= P22_RES_PARK_SHARE and freed == sizes[
                "ab".index(name)], (r["rank"], name, fell, block, freed))
        warms = [e for e in evs if e[1] == "warm" and e[3]]
        check([e[0] for e in warms] == ["a", "b"], ("warms", warms))
        donated = [e for e in evs if e[1] == "donate"]
        check(len(donated) == 1 and donated[0][2] == sizes[1] // page_nbytes,
              ("donation", r["rank"], donated, sizes[1] // page_nbytes))
        reclaims = [e for e in evs if e[1] == "reclaim"]
        took = sum(e[3] for e in reclaims)
        a_done = [e for e in evs if e[:2] == ["a", "done"]]
        live = a_done[-1][3]["in_use"]
        held = donated[0][4]["in_use"]
        log(f"phase 22(c) rank {r['rank']}: " + "; ".join(
            f"{e[0]} warm {e[4]:.3f} s ({e[5]} B of blocks)" for e in warms)
            + f"; donated {donated[0][2]} pages, reclaimed {took} "
            f"({len(reclaims)} reclaims: {[e[3] for e in reclaims]}); a's "
            f"pool at the end {reclaims[-1][4] if reclaims else None}; "
            f"step records " + ", ".join(
                f"{n} {t.get('records', 0)} ({t.get('calls', 0)} "
                f"broadcasts, {t.get('seconds', 0.0):.3f} s; pressure "
                f"verdicts {t.get('pressure_calls', 0)}, "
                f"{t.get('pressure_seconds', 0.0) * 1e3:.2f} ms)"
                for n, t in r["tally"].items())
            + f"; K1 {r['launches']['flash_fwd']} launches; wall "
            f"{r['wall_s']:.2f} s")
        # b's load took back the free donated slots, never live KV
        check(reclaims and took == donated[0][2] - (live - held),
              ("reclaim", r["rank"], took, donated[0][2], live, held))
    # K1 in every request's prefill (and b's never-parked one), at the
    # rank shapes of the 2-layer tp=2 and MoE ep=2 layouts
    layers = run["layers"]
    want_k1 = [layers * len(chunk_shapes(len(p))) for p in (
        run["prompts_a"][0], run["prompt_b"], run["prompts_a"][1],
        run["prompt_b"])]
    check([q["k1"] for q in reqs] == want_k1,
          ("residency K1 launches", [q["k1"] for q in reqs], want_k1))
    h, hkv, d = P22_HEADS
    allowed = {(1, sq, sk, h // tp, hkv // tp, d, True)
               for label, tp in (("2-layer tp=2", 2), ("MoE ep=2", 1))
               for sq, sk in p22_chunks(label)}
    for r in ranks:
        check(r["launches"]["flash_fwd"] == sum(want_k1) + lead[
            "b_never_parked_k1"], ("residency K1 total", r["launches"]))
        check({tuple(c) for c in r["calls"]} <= allowed,
              ("residency K1 shapes", r["calls"]))
    pool = lead["pool"]
    log(f"phase 22(c): pool loads {pool['loads_total']}, evictions "
        f"{pool['evictions_total']}, donated pages at the end "
        f"{pool['donated_pages']}; {card_line()}")
    return {"ranks": ranks, "requests": reqs, "pool": pool,
            "launches": sum(r["launches"]["flash_fwd"] for r in ranks),
            "wall_s": max(r["wall_s"] for r in ranks)}


def p22_int8_finish(prep: dict, jobs: list[dict]) -> dict:
    """Phase 22(d)'s int8 MoE at ep=2: every rank's stream identical and
    bitwise one process's int8 MoE stream (tokens and first-token
    logits), each rank's int8 ``q`` and ``scale`` expert blocks bitwise
    its slice of one process's (SHA-256), K1 once per layer and chunk."""
    label = "MoE int8 ep=2"
    for j in jobs:
        check(j["rc"] == 0, (label, j["rc"]))
    ranks = [j["extra"] for j in jobs]
    p22_log(label, ranks)
    runs, one = prep["runs"], prep["one"]["MoE int8 one process"]
    lead = ranks[0]
    check(all(r["streams"] == lead["streams"] for r in ranks),
          f"phase 22 {label}: ranks' streams differ")
    same = ([s[1:] for s in lead["streams"]]
            == [s[1:] for s in one["streams"]])
    got = torch.load(runs[label]["out"].format(rank=0), weights_only=True)
    want = torch.load(runs["MoE int8 one process"]["out"].format(rank=0),
                      weights_only=True)
    exact = got.keys() == want.keys() and all(
        torch.equal(got[n], want[n]) for n in want)
    blocks = {}
    for r in ranks:
        for name, digests in r["int8_digests"].items():
            blocks[name] = blocks.get(name, 0) + (
                one["int8_digests"].get(name) == digests)
    n_blocks = len(one["int8_digests"])
    layers, n = MH_SHALLOW_LAYERS, len(runs[label]["prompts"][0])
    log(f"phase 22(d) {label}: stream {'equals' if same else 'DIFFERS FROM'}"
        f" one process's int8 MoE stream; first-token logits "
        f"{'bitwise' if exact else 'NOT bitwise'}; {sum(blocks.values())} "
        f"of {n_blocks} int8 expert blocks (q and scale) bitwise one "
        f"process's slice, held by {len(ranks)} ranks")
    check(same and exact, (label, same, exact))
    check(len(blocks) == n_blocks and all(v == 1 for v in blocks.values()),
          (label, "int8 blocks", blocks))
    h, hkv, d = P22_HEADS
    want = [[1, sq, sk, h, hkv, d, True] for sq, sk in chunk_shapes(n)]
    for r in ranks:
        check(r["launches"]["flash_fwd"] == layers * len(chunk_shapes(n))
              and [list(c) for c in r["calls"]] == want,
              (label, r["rank"], r["launches"], r["calls"], want))
    return {"ranks": ranks, "launches": sum(
        r["launches"]["flash_fwd"] for r in ranks)}


def p22_disagg_finish(prep: dict, jobs: list[dict], p22: dict) -> dict:
    """Phase 22(d)'s checks: every handed-off stream, and the one resumed
    on the prefill gang, equal the 2-layer tp=2 layout's colocated
    stream of the same prompt; each body's pages are bitwise the pages
    one process under ``tp2_partial_sums(columns=True)`` committed for
    the prompt; K1 once per layer and prefill chunk at the rank's heads;
    both ranks' page pools equal and empty at the end, no handoff held;
    every rank gathered each handoff and took each page broadcast."""
    run = prep["disagg"]
    for j in jobs:
        check(j["rc"] == 0, ("disagg", j["rc"]))
    ranks = [j["extra"] for j in jobs]
    lead = ranks[0]
    for r in ranks[1:]:
        check(r["errors"] == [], ("disagg follower", r["errors"]))
    dense = p22_keyed(p22["2-layer tp=2"]["ranks"][0]["streams"])
    want = [dense[(len(p), 0)][0] for p in run["prompts"]]
    same = sum(g == w for g, w in zip(lead["streams"], want))
    no_peer = lead["no_peer"] == dense[(len(run["no_peer"]), 0)][0]
    mine = torch.load(run["pages_out"], weights_only=True)
    ref = torch.load(prep["runs"]["2-layer one process (tp2_partial_sums)"][
        "pages_out"], weights_only=True)
    exact, worst = 0, 0.0
    for n, layers in ref.items():
        got = mine.get(n)
        ok = got is not None and all(
            torch.equal(g[name], w[name]) for g, w in zip(got, layers)
            for name in w)
        exact += ok
        if got is not None and not ok:
            worst = max(worst, max((g[name].float() - w[name].float()).abs()
                                   .max().item() for g, w in zip(got, layers)
                                   for name in w))
    for h in lead["hops"]:
        fwd = "post_s" in h
        log(f"phase 22(d) {h['prompt']} tokens: gather "
            f"{h['gather_s'] * 1e3:.2f} ms of {h['gather_bytes']} B into the "
            f"prefill leader's host memory" + (
                f"; serialize_handoff {h['serialize_s'] * 1e3:.1f} ms, body "
                f"{h['body_bytes']} B of JSON; POST wall "
                f"{h['post_s'] * 1e3:.1f} ms (the decode leader's deserialize "
                f"{h['deserialize_s'] * 1e3:.1f} ms, page broadcast "
                f"{h['broadcast_s'] * 1e3:.2f} ms of {h['broadcast_bytes']} B, "
                f"its :resume {h['resume_s'] * 1e3:.1f} ms)" if fwd
                else "; no decode peer: resumed on the prefill gang"))
    for r in ranks:
        log(f"phase 22(d) rank {r['rank']}: step records " + ", ".join(
            f"{k} {t.get('records', 0)} ({t.get('calls', 0)} broadcasts, "
            f"{t.get('seconds', 0.0) * 1e3:.1f} ms; gathers "
            f"{t.get('gather_calls', 0)}, {t.get('gather_seconds', 0.0) * 1e3:.1f}"
            f" ms; page broadcasts {t.get('page_calls', 0)}, "
            f"{t.get('page_seconds', 0.0) * 1e3:.1f} ms, "
            f"{t.get('page_bytes', 0)} B)" for k, t in r["tally"].items())
            + f"; K1 {r['launches']['flash_fwd']} launches; pools at the end "
            + ", ".join(f"{k} in use {p['stats']['in_use']} of "
                        f"{p['stats']['pages']}, held {p['held']}"
                        for k, p in r["pools"].items())
            + f"; wall {r['wall_s']:.2f} s")
    log(f"phase 22(d): {same} of {len(want)} handed-off streams and the "
        f"no-peer one ({no_peer}) equal the 2-layer tp=2 layout's; {exact} "
        f"of {len(ref)} bodies' pages bitwise one process's under "
        f"tp2_partial_sums" + (f" (max |d| {worst:.4e})" if worst else "")
        + f"; {card_line()}")
    check(same == len(want) and no_peer, ("disagg streams", same, no_peer))
    check(exact == len(ref) == len(run["prompts"]), ("disagg pages", exact))
    layers = run["layers"]
    want_k1 = layers * (len(prefill_shapes())
                        + len(chunk_shapes(len(run["no_peer"]))))
    h, hkv, d = P22_HEADS
    allowed = {(1, sq, sk, h // 2, hkv // 2, d, True)
               for sq, sk in p22_chunks("2-layer tp=2")}
    n_hops = len(run["prompts"]) + 1
    for r in ranks:
        check(r["launches"] == {"flash_fwd": want_k1, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}
              and {tuple(c) for c in r["calls"]} <= allowed,
              ("disagg K1", r["rank"], r["launches"], want_k1))
        check(r["tally"]["prefill"].get("gather_calls") == n_hops
              and r["tally"]["decode"].get("page_calls")
              == len(run["prompts"]), ("disagg hops", r["tally"]))
        for k, p in r["pools"].items():
            check(p["used"] == [] and p["held"] == 0
                  and p["stats"] == lead["pools"][k]["stats"],
                  ("disagg pool", r["rank"], k, p))
        for k in ("prefill", "decode"):
            check(r["tally"][k]["records"] == lead["tally"][k]["records"],
                  ("disagg records", k))
    return {"ranks": ranks, "hops": lead["hops"],
            "launches": sum(r["launches"]["flash_fwd"] for r in ranks),
            "wall_s": max(r["wall_s"] for r in ranks)}


def p22_call_counts(part: dict) -> dict[tuple, int]:
    """Every rank's recorded K1 calls of a phase 22 part, by shape."""
    counts: dict[tuple, int] = {}
    for r in part["ranks"]:
        for call in r["calls"]:
            counts[tuple(call)] = counts.get(tuple(call), 0) + 1
    return counts


def p22_numbers(fa, p22: dict) -> list[dict]:
    """K1 rows of phase 22: each layout's distinct shapes with their
    launches over its ranks, each shape timed once (``k1_times``)."""
    rows = []
    for label, tp, *_ in P22_LAYOUTS:
        ranks = p22[label]["ranks"]
        layers = p22[label]["launches"] // len(ranks) // len(
            p22_chunks(label))
        for name, *dims, per_layer in p22_shapes(label, tp):
            key = tuple(dims)
            ms, plain_ms, library_ms = k1_times(fa, *key)
            row = {"shape": name, "launches": per_layer * layers * len(ranks),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound_fields("flash_fwd", key, torch.bfloat16)}
            log(f"flash_fwd {name} bf16 (x{row['launches']} in phase 22 "
                f"{label}, {len(ranks)} ranks): kernel {ms:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
                f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
            rows.append(row)
    # (c) and (d): every rank's K1 calls, by shape; (d)'s int8 request
    # has one shape (p22_int8_finish)
    int8 = p22["int8"]["ranks"]
    for part, slug, counts in (
            ("22(c)", "residency", p22_call_counts(p22["residency"])),
            ("22(d)", "disagg", p22_call_counts(p22["disagg"])),
            ("22(d) int8", "int8", {tuple(int8[0]["calls"][0]): sum(
                r["launches"]["flash_fwd"] for r in int8)})):
        for key, n in sorted(counts.items()):
            _, sq, sk, h, *_ = key
            name = f"7b_predictor_{slug}_{sq}x{sk}_h{h}"
            ms, plain_ms, library_ms = k1_times(fa, *key)
            row = {"shape": name, "launches": n, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound_fields("flash_fwd", key, torch.bfloat16)}
            log(f"flash_fwd {name} bf16 (x{n} in phase {part}, 2 ranks): "
                f"kernel {ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), plain {plain_ms:.4f} ms, sdpa "
                f"{library_ms:.4f} ms")
            rows.append(row)
    return rows


def phase_gangs(fa, wanted=(17, 18, 19, 20, 21, 22),
                phase2: dict | None = None) -> dict:
    """Phases 17-22 (``wanted`` of them): each one's one-process runs
    here, then one gang of GANG_RANKS on this card for all their 2-rank
    layouts, then each phase's checks (phase 17's (c) in this process);
    phase 18's, 21's and 22's 4-rank layouts run in one gang of 4,
    spawned when the first of them is checked, and phase 18's restore
    follows.  Phase 22 compares its tp=2 layout with ``phase2`` (phase
    2's result: its streams and first-token logits)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    free_memory()
    home = Path(tempfile.mkdtemp(prefix=".kf_gangs_"))
    prepare = {17: gang_prepare, 18: mesh_prepare, 19: sp_prepare,
               20: moe_ep_prepare, 21: mh_prepare,
               22: lambda fa, home: p22_prepare(fa, home, phase2)}
    preps, spec, out, four = {}, {}, {}, []
    try:
        for phase in wanted:
            t1 = time.perf_counter()
            preps[phase], spec[str(phase)] = prepare[phase](fa, home)
            free_memory()
            log(f"phase {phase}: one process {time.perf_counter() - t1:.1f}s")
        t1 = time.perf_counter()
        ranks = spawn_gang(spec, GANG_RANKS)
        log(f"phases {', '.join(map(str, wanted))}: gang of {GANG_RANKS} "
            f"{time.perf_counter() - t1:.1f}s; seconds after the spawn "
            + "; ".join(f"rank {r} " + ", ".join(
                f"{k} {v:.1f}" for k, v in o["times"].items())
                for r, o in enumerate(ranks)))

        def fours(phase: str) -> list[list]:
            # phase 18's fsdp=2 x tp=2, phase 21's dp=2 x tp=2 and phase
            # 22's MoE tp=2 x ep=2
            if not four:
                spec4 = {}
                if 18 in wanted:
                    spec4["18"] = [preps[18]["configs"][MESH_LAYOUTS[-1][0]]]
                for p4 in (21, 22):
                    if p4 in wanted:
                        spec4[str(p4)] = preps[p4]["fours"]
                t2 = time.perf_counter()
                four.extend(spawn_gang(spec4, 4))
                log(f"phases {', '.join(spec4)}: gang of 4 "
                    f"{time.perf_counter() - t2:.1f}s; seconds after the "
                    "spawn " + "; ".join(f"rank {r} " + ", ".join(
                        f"{k} {v:.1f}" for k, v in o["times"].items())
                        for r, o in enumerate(four)))
            return [o[phase] for o in four]

        for phase in wanted:
            t1 = time.perf_counter()
            got = [o[str(phase)] for o in ranks]
            if phase == 17:
                out[17] = gang_finish(fa, preps[17], got, home)
            elif phase == 18:
                out[18] = mesh_finish(preps[18], got, fours("18"), home)
            elif phase == 19:
                out[19] = sp_finish(preps[19], got)
            elif phase == 20:
                out[20] = moe_ep_finish(preps[20], ranks)
            elif phase == 21:
                out[21] = mh_finish(preps[21], got, fours("21"))
            else:
                out[22] = p22_finish(preps[22], got, fours("22"))
            log(f"phase {phase}: checks and what follows the gang of "
                f"{GANG_RANKS} {time.perf_counter() - t1:.1f}s")
    finally:
        shutil.rmtree(home, ignore_errors=True)
    log(f"phases {', '.join(map(str, wanted))}: "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def int8_pages_equal(engine, prompt: list[int], usable: int) -> bool:
    """Whether the int8 pages ``engine`` committed for ``prompt`` past its
    reused prefix equal ``quantize_kv`` of the scratch rows they were cut
    from, bitwise (one gather per layer and tensor)."""
    from kubeflow_tpu_torch.serving.page_pool import pages_for
    from kubeflow_tpu_torch.serving.quant import quantize_kv

    node, _ = engine.prefix_cache.match(prompt)
    shared = usable // PC_PAGE
    pages = node.pages[shared:pages_for(len(prompt), PC_PAGE)]
    first, end = shared * PC_PAGE, (shared + len(pages)) * PC_PAGE
    bufs = [{name: torch.empty((len(pages),) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
             for name, t in layer.items()}
            for layer in engine.pool.kv["layers"]]
    engine.pool.gather(pages, bufs)
    for b, rows in zip(bufs, engine._scratch()):
        for name in ("k", "v"):
            x = rows[name][0, first:end]
            q, scale = quantize_kv(x.reshape((len(pages), PC_PAGE)
                                             + tuple(x.shape[1:])))
            if not (torch.equal(q, b[name])
                    and torch.equal(scale, b[name + "s"])):
                return False
    return True


def kv_quant_perplexity(model) -> dict:
    """Perplexity of a ``PPL_TAIL``-token continuation over a
    ``PPL_HEAD``-token prompt's KV, int8 (quantized per page of
    ``PC_PAGE`` positions and head, then dequantized) against bf16, on
    ``model`` (the reference's test_kv_quant_perplexity_neutral)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.quant import dequantize_kv, quantize_kv

    cfg = model.config
    rng = np.random.default_rng(73)
    prompt = rng.integers(1, cfg.vocab_size, PPL_HEAD + PPL_TAIL).tolist()
    head, tail = prompt[:PPL_HEAD], prompt[PPL_HEAD:]

    @torch.no_grad()
    def continuation(quantize: bool):
        cache = llama.init_cache(cfg, 1, PPL_HEAD + PPL_TAIL)
        model(torch.tensor([head], device="cuda"), cache=cache)
        for layer in cache["layers"]:
            for name in ("k", "v"):
                x = layer[name][0, :PPL_HEAD]
                if quantize:
                    pages = x.reshape((PPL_HEAD // PC_PAGE, PC_PAGE)
                                      + tuple(x.shape[1:]))
                    q, scale = quantize_kv(pages)
                    x.copy_(dequantize_kv(q, scale, x.dtype).reshape(x.shape))
            layer["index"] = PPL_HEAD
        logits = model(torch.tensor([tail], device="cuda"),
                       cache=cache)["logits"][0].double()
        logp = torch.log_softmax(logits, -1)
        pick = logp[torch.arange(len(tail) - 1),
                    torch.tensor(tail[1:], device="cuda")]
        return float(torch.exp(-pick.mean())), logits

    ppl_ref, ref = continuation(False)
    ppl_q, got = continuation(True)
    return {"ppl_bf16": ppl_ref, "ppl_int8": ppl_q,
            "ppl_ratio": ppl_q / ppl_ref,
            "logits_rel": float((got - ref).abs().max() / ref.abs().max())}


def phase_int8(fa) -> dict:
    """Phase 12 (module docstring)."""
    from kubeflow_tpu_torch.models import registry
    from kubeflow_tpu_torch.serving.quant import (QTensor, quantize_array,
                                                  quantized_bytes)

    # the bf16 model the predictor quantizes (same seed: the same weights
    # before quantization): two layers' weights and one prompt's logits
    model = registry.get("llama").make_model(
        size="7b", param_dtype="compute").init_weights(0)
    cfg = model.config
    bf16_bytes = quantized_bytes(model)
    layers = tuple(f"layers.{i}." for i in INT8_CHECK_LAYERS)
    weights = {n: p.detach().cpu() for n, p in model.named_parameters()
               if n.startswith(layers) and n.endswith(".kernel")
               and p.numel() >= 1 << 12}      # quantize_params' min_size
    prompt = serving_bodies(cfg.vocab_size, 0)[1]["ids"][0]
    ids = torch.tensor([prompt], device="cuda")
    with torch.no_grad():
        bf16_logits = model(ids)["logits"].float()
    del model
    free_memory()

    def extras(pred) -> dict:
        t0 = time.perf_counter()
        for name, w in weights.items():
            owner, _, leaf = name.rpartition(".")
            qt = getattr(pred.module.get_submodule(owner), leaf)
            check(isinstance(qt, QTensor), f"{name} is not int8")
            q, scale = quantize_array(w, 0)
            check(torch.equal(qt.q.cpu(), q)
                  and torch.equal(qt.scale.cpu(), scale),
                  f"{name}: quantized on the card != quantize_array on the "
                  f"CPU")
        log(f"phase 12: the int8 q and scale of layers {INT8_CHECK_LAYERS} "
            f"({len(weights)} weights, "
            f"{sum(w.numel() for w in weights.values()) / 1e6:.0f} M values)"
            f" made on the card equal quantize_array on the CPU, bitwise "
            f"({time.perf_counter() - t0:.1f}s)")
        qts = [m for m in pred.module.modules() if isinstance(m, QTensor)]
        n_q = sum(m.q.numel() for m in qts)
        n_scale = sum(m.scale.numel() for m in qts)
        out = {"weight_bytes": pred.weight_bytes, "bf16_bytes": bf16_bytes}
        log(f"phase 12: weight_bytes {out['weight_bytes']} "
            f"({out['weight_bytes'] / 1e9:.3f} GB) against {bf16_bytes} "
            f"({bf16_bytes / 1e9:.3f} GB) in bf16, "
            f"{out['weight_bytes'] / bf16_bytes:.4f}x: {len(qts)} int8 "
            f"weights of {n_q} values, {n_scale} float32 scales")
        # each int8 value saves one byte of bf16; each scale costs four
        check(out["weight_bytes"] == bf16_bytes - n_q + 4 * n_scale, out)
        with torch.no_grad():
            logits = pred.module(ids)["logits"].float()
        check(bool(torch.isfinite(logits).all()), "finite int8 logits")
        out["logits_rel"] = ((logits - bf16_logits).abs().max()
                             / bf16_logits.abs().max()).item()
        out["top1"] = (logits.argmax(-1) == bf16_logits.argmax(-1)
                       ).float().mean().item()
        log(f"phase 12: prefill logits [1, {len(prompt)}, "
            f"{cfg.vocab_size}] int8 against bf16 weights (same seed): max "
            f"rel drift {out['logits_rel']:.3e}, top-1 agreement "
            f"{out['top1']:.4f} of positions")
        out.update(phase_profile(pred.module, "int8 "))

        def dequantize_all():
            for m in qts:
                m.dequantize()

        out["dequant_ms"] = time_ms(dequantize_all, reps=3, windows=5)
        bound = (n_q * (1 + 2) + n_scale * 4) / HBM_BYTES_PER_S * 1e3
        log(f"phase 12: dequantizing every int8 weight once ({len(qts)} "
            f"weights, {n_q / 1e9:.2f} G values; once per forward): "
            f"{out['dequant_ms']:.3f} ms, bound {bound:.3f} ms (bytes)")
        out.update(int8_kv_traffic(fa, pred))
        return out

    out = phase_serving(fa, label="int8 llama 7b", extra=extras,
                        quantize=True)
    free_memory()
    return out


def int8_kv_traffic(fa, pred) -> dict:
    """Phase 12's second half: int8 KV pages under phase 7(a)'s traffic on
    the int8 model, and the perplexity check."""
    from kubeflow_tpu_torch.models.llama import kv_page_nbytes
    from kubeflow_tpu_torch.serving.engine import (PREFIX_HITS,
                                                   PREFIX_MISSES,
                                                   ContinuousBatcher)

    cfg = pred.cfg
    budget = int(PC_CACHE_MB * (1 << 20))
    eng = ContinuousBatcher(pred.module, cfg, max_batch=4, max_seq=MAX_SEQ,
                            prefill_chunk=PREFILL_CHUNK,
                            prefix_cache_bytes=budget, page_size=PC_PAGE,
                            kv_quant=True)
    bf16_pages = budget // kv_page_nbytes(cfg, PC_PAGE)
    pages = eng.prefix_cache.max_pages
    log(f"phase 12: int8 KV pages of {eng.page_nbytes} B "
        f"({eng.page_nbytes / 2**20:.2f} MiB): {pages} cache pages in "
        f"{PC_CACHE_MB} MB against {bf16_pages} bf16 pages, "
        f"{pages / bf16_pages:.3f}x")
    check(pages >= 1.9 * bf16_pages, (pages, bf16_pages))
    plan = prefix_plan()
    store: list = []
    try:
        with torch.no_grad(), first_token_logits(store):
            saved = counters(fa)
            # warm-up, one turn (its module loads and first-use costs)
            for prompt in chat_turns(cfg.vocab_size, 71)[:1]:
                serve_one(eng, prompt, store)
            set_counters(fa, saved)
            h0, m0 = PREFIX_HITS.get(), PREFIX_MISSES.get()
            set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # path starts
            runs = []
            for (n, usable), prompt in zip(plan,
                                           chat_turns(cfg.vocab_size, 70)):
                r = serve_one(eng, prompt, store)
                check(len(r["ids"]) == n + NEW_TOKENS
                      and r["ids"][:n] == prompt, (n, "int8 KV stream"))
                if usable < n - 1:
                    check(int8_pages_equal(eng, prompt, usable),
                          f"int8 pages of the {n}-token prompt")
                runs.append(r)
            launches = counters(fa)                           # path ended
            set_counters(fa, {k: saved[k] + launches[k] for k in saved})
        hits, misses = PREFIX_HITS.get() - h0, PREFIX_MISSES.get() - m0
        chunks = len(prefix_shapes())
        log(f"phase 12 int8 KV: flash_fwd launches {launches['flash_fwd']} "
            f"(expected {cfg.num_layers} x {chunks} chunks); prefix hits "
            f"{hits:.0f}, misses {misses:.0f}; every committed page equals "
            f"quantize_kv of its scratch rows, bitwise; TTFT ms "
            + " ".join(f"{r['ttft'] * 1e3:.2f}" for r in runs))
        check(launches["flash_fwd"] == cfg.num_layers * chunks, launches)
        check((hits, misses) == (3, 1), (hits, misses))
        idle_state(eng)
    finally:
        eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    ppl = kv_quant_perplexity(pred.module)
    log(f"phase 12: perplexity of a {PPL_TAIL}-token continuation over "
        f"{PPL_HEAD} tokens of int8 prompt KV {ppl['ppl_int8']:.4f} against "
        f"bf16 {ppl['ppl_bf16']:.4f}: ratio {ppl['ppl_ratio']:.6f} (tol "
        f"|ratio - 1| < {KV_QUANT_PPL_TOL:g}); continuation logits max rel "
        f"diff {ppl['logits_rel']:.3e}")
    check(abs(ppl["ppl_ratio"] - 1.0) < KV_QUANT_PPL_TOL, ppl)
    return {"kv_launches": launches["flash_fwd"], "kv_pages": pages,
            "kv_bf16_pages": bf16_pages,
            "kv_ttft_ms": [r["ttft"] * 1e3 for r in runs], **ppl}


class HandoffWire:
    """Phase 13's handoff transport: ``disagg.http_post_json``'s JSON POST
    with its body's bytes and wall time, and the serialize time (from a
    wrapper of ``disagg.serialize_handoff``), by prompt length."""

    def __init__(self):
        self.rows: dict[int, dict] = {}

    def post(self, addr: str, path: str, payload: dict,
             timeout: float = 600.0) -> dict:
        import http.client

        body = json.dumps(payload).encode()
        host, _, port = addr.partition(":")
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"decode peer answered {resp.status}: "
                               f"{raw[:200]!r}")
        out = json.loads(raw)
        self.rows.setdefault(len(payload["ids"]), {}).update(
            wire_bytes=len(body), post_s=time.perf_counter() - t0,
            deserialize_s=out.get("deserialize_s"))
        return out

    @contextlib.contextmanager
    def timed_serialize(self):
        from kubeflow_tpu_torch.serving import disagg

        original = disagg.serialize_handoff

        def timed(state, pool):
            t0 = time.perf_counter()
            out = original(state, pool)
            self.rows.setdefault(len(state.ids), {})["serialize_s"] = \
                time.perf_counter() - t0
            return out

        disagg.serialize_handoff = timed
        try:
            yield
        finally:
            disagg.serialize_handoff = original


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_decode_child(port: int):
    """``python -m kubeflow_tpu_torch.serving.predictor --role decode`` at
    phase 2's model, seed and settings on ``port``; its output lines are
    collected by threads (``child.lines``)."""
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.serving.predictor",
           "--model", "llama:size=7b", "--max-seq", str(MAX_SEQ),
           "--prefill-chunk", str(PREFILL_CHUNK), "--max-batch", "4",
           "--role", "decode", "--port", str(port)]
    env = dict(os.environ)
    env.pop("KF_POD_PORT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    child = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    child.lines = []

    def drain(stream):
        for line in stream:
            child.lines.append(line.rstrip())

    child.readers = [threading.Thread(target=drain, args=(s,), daemon=True)
                     for s in (child.stdout, child.stderr)]
    for t in child.readers:
        t.start()
    return child


def child_ready(child, port: int) -> None:
    """Wait for the decode child's ``/healthz``; fail, printing its
    output, if it exits or does not come up in ``CHILD_START_S``."""
    import http.client

    end = time.monotonic() + CHILD_START_S
    while time.monotonic() < end:
        if child.poll() is not None:
            break
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                return
        except OSError:
            pass
        finally:
            conn.close()
        time.sleep(0.5)
    log("decode child output:\n" + "\n".join(child.lines[-60:]))
    check(False, f"the decode child is not serving (exit {child.poll()})")


def stop_child(child) -> int:
    if child.poll() is None:
        child.terminate()
        try:
            child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=30)
    for t in child.readers:
        t.join(timeout=10)
    return child.returncode


def phase_disagg(fa, colocated: list | None = None,
                 colocated_tok_s: float | None = None) -> dict:
    """Phase 13 (module docstring); ``colocated``: phase 2's streams of
    ``serving_bodies(.., 0)``, made here when not given."""
    import http.client

    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (GenerativePredictor,
                                                      PredictorApp)

    child_port = free_port()
    t_child = time.perf_counter()
    child = start_decode_child(child_port)       # starts while we build
    wire = HandoffWire()
    pred, httpd = None, None
    try:
        pred = GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                                   prefill_chunk=PREFILL_CHUNK, max_batch=4,
                                   seed=0, role="prefill",
                                   handoff_post=wire.post)
        cfg = pred.cfg
        bodies = serving_bodies(cfg.vocab_size, 0)
        if colocated is None:
            ref = ContinuousBatcher(pred.module, cfg, max_batch=4,
                                    max_seq=MAX_SEQ,
                                    prefill_chunk=PREFILL_CHUNK)
            colocated = engine_streams(ref, bodies)
            ref.shutdown()
            del ref
        child_ready(child, child_port)
        log(f"phase 13(a): decode child (pid {child.pid}) serving on "
            f":{child_port} after {time.perf_counter() - t_child:.1f}s")
        ttft: dict[int, float] = {}
        capture = pred.engine.handoff_fn

        def noted(req, state):
            ttft[len(req.ids)] = req.first_token_at - req.submitted_at
            capture(req, state)

        pred.engine.handoff_fn = noted
        httpd, thread = serve(PredictorApp({"llama": pred}), 0)
        peer = {"X-KF-Decode-Peer": f"127.0.0.1:{child_port}"}
        chunks = len(prefill_shapes())
        # the longest prompt goes without a peer and resumes here: its
        # 1 GB JSON handoff is off the run (DISAGG_HANDED_OFF)
        headers = [peer if n in DISAGG_HANDED_OFF else None
                   for n in PROMPT_LENS]
        with wire.timed_serialize():
            set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # path starts
            t0 = time.perf_counter()
            results = concurrent_round(httpd.server_port, bodies, headers)
            wall = time.perf_counter() - t0
            launches = counters(fa)                           # path ended
        if child.poll() is not None:
            log("decode child output:\n" + "\n".join(child.lines[-60:]))
            check(False, f"the decode child died (exit {child.poll()})")
        for i, (status, body) in enumerate(results):
            check(status == 200, (i, status, body))
        streams = [body["ids"][0] for _, body in results]
        same = [s == c for s, c in zip(streams, colocated)]
        conn = http.client.HTTPConnection("127.0.0.1", child_port,
                                          timeout=30)
        conn.request("GET", "/v1/models/llama")
        child_stats = json.loads(conn.getresponse().read())["stats"]
        conn.close()
        pre_stats = pred.engine.stats()
        log(f"phase 13(a): 4 concurrent requests in {wall:.2f}s through "
            f"the prefill predictor; flash_fwd launches "
            f"{launches['flash_fwd']} in this process (expected "
            f"{cfg.num_layers} x {chunks} chunks); streams equal to the "
            f"colocated ones {same}; decode child: role "
            f"{child_stats.get('role')}, resumed {child_stats.get('resumed')}"
            f"; prefill: handoffs {pre_stats['handoffs']}, resumed locally "
            f"{pre_stats['resumed']}")
        check(all(same), "disaggregated streams != colocated streams")
        check(launches == {"flash_fwd": cfg.num_layers * chunks,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, launches)
        local = len(PROMPT_LENS) - len(DISAGG_HANDED_OFF)
        check(child_stats.get("role") == "decode"
              and child_stats.get("resumed") == len(DISAGG_HANDED_OFF),
              child_stats)
        check(pre_stats["handoffs"] == 4 and pre_stats["resumed"] == local,
              pre_stats)
        log(f"  {card_line()}")
        for n in DISAGG_HANDED_OFF:
            row = wire.rows[n]
            row["ttft_s"] = ttft[n]
            log(f"  handoff of the {n}-token prompt: "
                f"{-(-n // PC_PAGE)} pages, {row['wire_bytes']} B of JSON; "
                f"serialize {row['serialize_s'] * 1e3:.1f} ms, POST "
                f"{row['post_s'] * 1e3:.1f} ms (transfer, deserialize and "
                f"decode), deserialize {row['deserialize_s'] * 1e3:.1f} ms; "
                f"TTFT {ttft[n] * 1e3:.1f} ms")
        # the peer goes away: the next request resumes on this engine
        code = stop_child(child)
        log(f"phase 13(a): decode child stopped (exit {code})")
        status, body = post(httpd.server_port, "/v1/models/llama:generate",
                            bodies[1], peer)
        after = pred.engine.stats()
        log(f"phase 13(a): with the peer gone, a {PROMPT_LENS[1]}-token "
            f"request completes with status {status}, stream equal to the "
            f"colocated one {status == 200 and body['ids'][0] == colocated[1]}"
            f", resumed locally {after['resumed']}")
        check(status == 200 and body["ids"][0] == colocated[1]
              and after["resumed"] == local + 1, (status, after))
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        httpd = None
        check(pred.stop(timeout=60), "prefill predictor idle")
        check(pred.engine.stats()["kv_pool"]["orphan_pages"] == 0,
              pred.engine.stats()["kv_pool"])
        model = pred.module
        pred = noted = capture = None     # the predictor goes; the model stays
        free_memory()
        out = {"launches": launches["flash_fwd"], "handoffs": wire.rows,
               "wall_s": wall}
        out.update(disagg_in_process(fa, model, bodies, colocated_tok_s))
        return out
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        stop_child(child)
        if pred is not None:
            pred.stop(timeout=60)


def disagg_in_process(fa, model, bodies: list[dict],
                      colocated_tok_s: float | None) -> dict:
    """Phase 13(b): a ``DisaggCoordinator`` (1 prefill, 1 decode engine
    over one int8 pool) takes phase 2's four requests."""
    from kubeflow_tpu_torch.serving.disagg import DisaggCoordinator

    cfg = model.config
    co = DisaggCoordinator(model, cfg, max_batch=4, max_seq=MAX_SEQ,
                           prefill_chunk=PREFILL_CHUNK, page_size=PC_PAGE,
                           kv_quant=True)
    try:
        pool = co.pool
        log(f"phase 13(b): one int8 pool of {pool.num_pages} pages x "
            f"{pool.page_nbytes / 2**20:.2f} MiB = "
            f"{pool.num_pages * pool.page_nbytes / 1e9:.2f} GB; "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        chunks = len(prefill_shapes())
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))      # path starts
        t0 = time.perf_counter()
        reqs = [co.submit(b["ids"][0], max_new_tokens=NEW_TOKENS,
                          temperature=b.get("temperature", 0.0),
                          seed=b.get("seed", 0)) for b in bodies]
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        launches = counters(fa)                               # path ended
        check(all(len(o) == n + NEW_TOKENS for o, n in zip(outs,
                                                             PROMPT_LENS)),
              "int8 disaggregated streams")
        check(co.drained(timeout=60), "coordinator idle")
        st = co.stats()
        pre, dec = st["prefill"][0], st["decode"][0]
        t = dec["timing"]
        tok_s = t["decode_tokens"] / t["decode_seconds"] \
            if t["decode_seconds"] else 0.0
        log(f"phase 13(b): 4 requests in {wall:.2f}s; flash_fwd launches "
            f"{launches['flash_fwd']} (expected {cfg.num_layers} x {chunks} "
            f"chunks); prefill handoffs {pre['handoffs']}, decode resumed "
            f"{dec['resumed']}; at idle: in_use {st['kv_pool']['in_use']}, "
            f"orphan_pages {st['kv_pool']['orphan_pages']}")
        log(f"  decode role {tok_s:.1f} tok/s while the prefill role took "
            f"the prompts (the {PROMPT_LENS[-1]}-token one last), against "
            + (f"{colocated_tok_s:.1f}" if colocated_tok_s else "(not run)")
            + " colocated (phase 2, this call); " + card_line())
        check(launches["flash_fwd"] == cfg.num_layers * chunks, launches)
        check(pre["handoffs"] == 4 and dec["resumed"] == 4, (pre, dec))
        check(st["kv_pool"]["orphan_pages"] == 0, st["kv_pool"])
        return {"int8_launches": launches["flash_fwd"],
                "int8_decode_tok_per_s": tok_s, "int8_wall_s": wall}
    finally:
        co.shutdown()
        del co
        free_memory()


# -- phase 14: multi-model, multi-tenant serving ---------------------------------

def checkpoint_home(need: int) -> Path:
    """A fresh directory for the phase's checkpoint on the first disk with
    room for it (TMPDIR, then the checkout); prints both disks' usage."""
    import shutil
    import tempfile

    for base in (Path(tempfile.gettempdir()), ROOT):
        usage = shutil.disk_usage(base)
        log(f"phase 14: disk of {base}: {usage.free / 1e9:.1f} GB free of "
            f"{usage.total / 1e9:.1f} GB")
        if usage.free > 1.2 * need:
            return Path(tempfile.mkdtemp(prefix=".kf_ckpt_", dir=base))
    check(False, f"no disk holds the {need} B checkpoint")


def pinned_h2d_gb_s() -> float:
    """Host-to-device copy rate of a pinned 256 MiB buffer (CUDA events,
    median of 5): the bound of a streamed restore."""
    host = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty_like(host, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return host.numel() / statistics.median(times) / 1e9


def engine_streams(engine, bodies: list[dict], new_tokens: int = NEW_TOKENS
                   ) -> list[list[int]]:
    """``bodies`` (``serving_bodies``) submitted together to ``engine``,
    as the predictor submits them; the full streams."""
    reqs = [engine.submit(b["ids"][0], new_tokens,
                          temperature=b.get("temperature", 0.0),
                          seed=b.get("seed", 0)) for b in bodies]
    return [r.result(timeout=600) for r in reqs]


def fleet_predictor(**kw):
    """Phase 2's 7B predictor settings with ``kw``."""
    from kubeflow_tpu_torch.serving.predictor import GenerativePredictor

    return GenerativePredictor("llama", size="7b", max_seq=MAX_SEQ,
                               prefill_chunk=PREFILL_CHUNK, max_batch=4, **kw)


def fleet_restore(fa, ckpt: Path, phase2: list | None) -> tuple:
    """Phase 14(a): phase 2's model (seed 0) written with
    ``save_streamable``, restored into a seed-7 predictor through the
    ``STAGING_MB`` window; both serve phase 2's requests.  Returns the
    restored predictor, phase 2's bodies, the streams and the numbers."""
    from kubeflow_tpu_torch.serving.model_pool import save_streamable

    p0 = fleet_predictor(seed=0)
    bodies = serving_bodies(p0.cfg.vocab_size, 0)
    streams = engine_streams(p0.engine, bodies)
    if phase2 is not None:
        check(streams == phase2, "phase 14 seed-0 streams != phase 2's")
    t0 = time.perf_counter()
    total = save_streamable(p0.module, str(ckpt))
    save_s = time.perf_counter() - t0
    weight_bytes = p0.weight_bytes
    check(total == weight_bytes == CKPT_BYTES, (total, weight_bytes))
    log(f"phase 14(a): wrote {total} B in {len(os.listdir(ckpt)) - 1} "
        f"files to {ckpt} in {save_s:.2f}s "
        f"({total / save_s / 1e9:.2f} GB/s)")
    p0.stop(timeout=60)
    del p0
    free_memory()
    h2d = pinned_h2d_gb_s()
    t0 = time.perf_counter()
    p1 = fleet_predictor(seed=7, checkpoint_dir=str(ckpt),
                         staging_mb=STAGING_MB)
    build_s = time.perf_counter() - t0
    rep = p1.last_restore
    rate = rep["bytes"] / rep["seconds"] / 1e9
    log(f"phase 14(a): seed-7 predictor restored {rep['tensors']} tensors, "
        f"{rep['bytes']} B in {rep['seconds']:.3f}s ({rate:.2f} GB/s; "
        f"pinned copy_ rate in this call {h2d:.2f} GB/s, "
        f"{100 * rate / h2d:.1f}% of it); max_staged_bytes "
        f"{rep['max_staged_bytes']} against the {STAGING_MB} MiB window "
        f"({int(STAGING_MB * (1 << 20))} B); predictor built in "
        f"{build_s:.2f}s")
    check(0 < rep["max_staged_bytes"] <= STAGING_MB * (1 << 20), rep)
    restored = engine_streams(p1.engine, bodies)
    same = restored == streams
    log(f"phase 14(a): the restored seed-7 model's 4 streams equal the "
        f"seed-0 model's: {same}")
    check(same, "restored streams")
    return p1, bodies, streams, {"save_s": save_s, "restore_s": rep["seconds"],
                         "restore_gb_s": rate, "h2d_gb_s": h2d,
                         "max_staged": rep["max_staged_bytes"]}


def fleet_int8_restore(ckpt: Path) -> dict:
    """Phase 14(a), int8: the same checkpoint with ``quantize``.  Built,
    then parked and warmed again so that the peak of
    ``max_memory_allocated`` is taken over the restore alone (each weight
    lands in bf16, is quantized and dropped before the next)."""
    p = fleet_predictor(seed=7, checkpoint_dir=str(ckpt),
                        staging_mb=STAGING_MB, quantize=True)
    try:
        wb = p.weight_bytes
        check(wb == INT8_BYTES, (wb, INT8_BYTES))
        p.park()
        free_memory()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p.warm()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        layer = sum(math.prod(s) * 2 for n, (s, _) in p._shapes.items()
                    if n.startswith("layers.0."))
        log(f"phase 14(a) int8: restored in "
            f"{p.last_restore['seconds']:.3f}s; weight_bytes {wb}; peak of "
            f"max_memory_allocated over the restore {peak} B above the "
            f"engine's {base} B, {peak - wb} B above the int8 weights (one "
            f"layer's bf16 weights: {layer} B; window {STAGING_MB} MiB)")
        n_tensors = len([*p.module.parameters(), *p.module.buffers()])
        check(0 <= held - wb <= 512 * n_tensors
              and peak - wb <= layer + STAGING_MB * (1 << 20),
              (peak, held, wb, layer))
        return {"int8_peak": peak, "int8_bytes": wb,
                "int8_restore_s": p.last_restore["seconds"]}
    finally:
        p.stop(timeout=60)
        del p
        free_memory()


def fleet_tenants(module, cfg) -> dict:
    """Phase 14(c): 16 "storm" requests then 1 "victim" on one engine
    (``max_batch`` 4), all queued before admission starts, under WFQ
    shares of 1:1 and under FIFO; the victim's admission position and
    TTFT and each tenant's usage."""
    import math

    from kubeflow_tpu_torch.qos.accounting import Accountant, set_accountant
    from kubeflow_tpu_torch.serving.engine import ContinuousBatcher

    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cfg.vocab_size, TENANT_PROMPT).tolist()
               for _ in range(TENANT_STORM + 1)]
    tenants = ["storm"] * TENANT_STORM + ["victim"]
    shares = {"storm": 1.0, "victim": 1.0}
    out = {}
    for label, eng_shares in (("wfq", shares), ("fifo", None)):
        acct = Accountant()
        prev = set_accountant(acct)
        eng = ContinuousBatcher(module, cfg, max_batch=4, max_seq=MAX_SEQ,
                                prefill_chunk=PREFILL_CHUNK,
                                tenant_shares=eng_shares)
        try:
            gate = threading.Event()
            admit = eng._admit

            def gated(admit=admit, gate=gate):
                gate.wait(60)
                admit()

            eng._admit = gated             # admission waits for the queue
            t0 = time.perf_counter()
            reqs = [eng.submit(p, TENANT_NEW, tenant=t)
                    for p, t in zip(prompts, tenants)]
            gate.set()
            for r in reqs:
                r.result(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            eng.shutdown()
            set_accountant(prev)
        order = sorted(reqs, key=lambda r: r.admitted_at)
        victim = reqs[-1]
        pos = order.index(victim)
        ttft = victim.first_token_at - victim.submitted_at
        storm_ttft = [r.first_token_at - r.submitted_at for r in reqs[:-1]]
        usage = {t: {"requests": u["requests"],
                     "decode_tokens": u["decode_tokens"],
                     "slice_seconds": round(u["slice_seconds"], 4),
                     "admission_wait_max_s": round(
                         u["admission_wait"]["max_s"], 4)}
                 for t, u in acct.all_usage().items()}
        log(f"phase 14(c) {label}: victim admitted at position {pos} of "
            f"{len(reqs)}; victim TTFT {ttft * 1e3:.1f} ms, storm TTFT "
            f"mean {statistics.mean(storm_ttft) * 1e3:.1f} ms; "
            f"{len(reqs)} requests in {wall:.2f}s; usage {usage}")
        out[label] = {"pos": pos, "ttft_s": ttft, "usage": usage}
        del eng, reqs, order, victim
    # the reference's starvation bound: the victim's first request within
    # ceil(1 * W / w_victim) admissions
    bound = math.ceil(sum(shares.values()) / shares["victim"])
    check(out["wfq"]["pos"] < bound, ("wfq victim", out["wfq"], bound))
    check(out["fifo"]["pos"] == TENANT_STORM, ("fifo", out["fifo"]))
    check(out["wfq"]["usage"]["victim"]["requests"] == {"ok": 1},
          out["wfq"]["usage"])
    check(out["wfq"]["usage"]["storm"]["decode_tokens"]
          == TENANT_STORM * (TENANT_NEW - 1), out["wfq"]["usage"])
    check(set(out["fifo"]["usage"]) == {"anonymous"}, out["fifo"]["usage"])
    return out


def fleet_tracing(pred, bodies: list[dict], streams: list) -> dict:
    """Phase 14(d): one traced request with a ``traceparent`` through
    ``PredictorApp``; then phase 2's four requests at sample rate 0 and
    1, tokens identical."""
    from kubeflow_tpu_torch import trace
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import PredictorApp

    httpd, thread = serve(PredictorApp({"llama": pred}), 0)
    port = httpd.server_port
    try:
        tracer = trace.set_tracer(trace.Tracer(
            1.0, collector=trace.Collector(1 << 16)))
        ctx = trace.SpanContext(trace.new_trace_id(), trace.new_span_id())
        status, body = post(port, "/v1/models/llama:generate", bodies[2],
                            {"traceparent": ctx.to_traceparent()})
        check(status == 200 and body["ids"][0] == streams[2], status)
        spans = tracer.collector.trace(ctx.trace_id)
        by_id = {s.span_id: s for s in spans}
        names = [s.name for s in spans]
        chunks = len(chunk_shapes(PROMPT_LENS[2]))
        want = {"predictor.request": 1, "engine.request": 1,
                "engine.admission_wait": 1, "engine.prefill": chunks,
                "engine.decode": 1}
        got = {n: names.count(n) for n in want}
        parents = {s.name: by_id[s.parent_id].name if s.parent_id in by_id
                   else "client" for s in spans}
        dumped = json.loads(json.dumps(trace.chrome_trace(spans)))
        log(f"phase 14(d): trace {ctx.trace_id}: spans {got} (parents "
            f"{parents}); chrome trace {len(dumped['traceEvents'])} events; "
            f"durations (host) " + ", ".join(
                f"{s.name} {s.duration * 1e3:.2f} ms" for s in spans))
        check(got == want and len(spans) == sum(want.values()), names)
        check(parents == {"predictor.request": "client",
                          "engine.request": "predictor.request",
                          "engine.admission_wait": "engine.request",
                          "engine.prefill": "engine.request",
                          "engine.decode": "engine.request"}, parents)
        check(len(dumped["traceEvents"]) == len(spans), "chrome trace")
        rates = {}
        for rate in (0.0, 1.0):
            trace.set_tracer(trace.Tracer(
                rate, collector=trace.Collector(1 << 16)))
            before = pred.engine.stats()["timing"]
            results = concurrent_round(port, bodies)
            after = pred.engine.stats()["timing"]
            check(all(r[0] == 200 for r in results), results)
            check([r[1]["ids"][0] for r in results] == streams,
                  f"streams at sample rate {rate}")
            dec = after["decode_seconds"] - before["decode_seconds"]
            rates[rate] = ((after["decode_tokens"] - before["decode_tokens"])
                           / dec if dec else 0.0)
        log(f"phase 14(d): decode {rates[0.0]:.1f} tok/s at sample rate 0, "
            f"{rates[1.0]:.1f} at rate 1 (host-timed), tokens identical to "
            f"the untraced streams")
        return {"tok_s_rate0": rates[0.0], "tok_s_rate1": rates[1.0]}
    finally:
        trace.set_tracer(trace.Tracer(0.0))
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def get_json(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def fleet_residency(fa, ckpt: Path, bodies: list[dict], streams: list,
                    calls: list) -> dict:
    """Phase 14(b): two 7B models from the checkpoint under one
    ``WEIGHT_BUDGET_MB`` budget behind one ``PredictorApp``; "a" with a
    2048 MB prefix cache, "b" started parked.  ``calls``: the phase's
    record of K1 calls, which the checked request adds to."""
    from kubeflow_tpu_torch.serving import model_pool as mp
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (PredictorApp,
                                                      wire_model_pool)

    a = fleet_predictor(checkpoint_dir=str(ckpt), staging_mb=STAGING_MB,
                        prefix_cache_mb=PC_CACHE_MB, kv_page_size=PC_PAGE)
    b = fleet_predictor(checkpoint_dir=str(ckpt), staging_mb=STAGING_MB)
    parks: list = []

    def measured(name, pred):
        park = pred.park

        def wrapped():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            freed = park()
            torch.cuda.synchronize()
            parks.append((name, freed,
                          before - torch.cuda.memory_allocated()))
            return freed
        return wrapped

    a.park, b.park = measured("a", a), measured("b", b)
    b.park()                                   # parked=true
    pool = wire_model_pool({"a": a, "b": b},
                           int(WEIGHT_BUDGET_MB * (1 << 20)))
    httpd, thread = serve(PredictorApp({"a": a, "b": b}, model_pool=pool), 0)
    port = httpd.server_port
    evicted: list = []
    a.engine.prefix_cache.on_evict = evicted.append
    held: list = []
    try:
        body = bodies[1]

        def residency() -> dict:
            return {n: get_json(port, f"/v1/models/{n}")["residency"]
                    for n in ("a", "b")}

        # a serves while b stays parked (a metadata probe must not warm b)
        status, out = post(port, "/v1/models/a:generate", body)
        check(status == 200 and out["ids"][0] == streams[1],
              ("a", status, out.get("ids", [None])[0]))
        res0 = residency()
        check(res0 == {"a": "resident", "b": "parked"} and b.parked,
              (res0, b.parked))
        # TTFT: a one-token request to the resident a (a prompt it has
        # not cached), then 4 concurrent ones to the parked b (its load,
        # which parks a, included)
        one = dict(body, max_new_tokens=1)
        t0 = time.perf_counter()
        status, out = post(port, "/v1/models/a:generate",
                           dict(bodies[3], max_new_tokens=1))
        resident_ttft = time.perf_counter() - t0
        check(status == 200 and out["ids"][0] == streams[3][:len(
            bodies[3]["ids"][0]) + 1], status)
        before = pool.stats()["models"]["b"]
        loads0 = mp.COLDSTART_LOADS.get()
        walls: list = [None] * 4

        def cold(i):
            t = time.perf_counter()
            walls[i] = (post(port, "/v1/models/b:generate", one),
                        time.perf_counter() - t)

        threads = [threading.Thread(target=cold, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        after = pool.stats()["models"]["b"]
        for (status, out), _ in walls:
            check(status == 200 and out["ids"][0]
                  == streams[1][:len(body["ids"][0]) + 1], status)
        coalesced = after["coalesced"] - before["coalesced"]
        n_loads = mp.COLDSTART_LOADS.get() - loads0
        res1 = residency()
        check(res1 == {"a": "parked", "b": "resident"}, res1)
        # the switched-to b serves the whole stream
        status, out = post(port, "/v1/models/b:generate", body)
        check(status == 200 and out["ids"][0] == streams[1],
              ("b", status, out.get("ids", [None])[0]))
        log(f"phase 14(b): a, then b from parked over HTTP (streams equal "
            f"the seed-0 model's: True; residency {res0}, then "
            f"{res1}); 4 concurrent cold requests to parked b: loads "
            f"{n_loads:.0f}, coalesced {coalesced}; b loaded in "
            f"{after['last_load_seconds']:.3f}s; cold TTFT (parked to first "
            f"token, wall) {max(w for _, w in walls) * 1e3:.1f} ms against "
            f"resident TTFT {resident_ttft * 1e3:.1f} ms")
        check(n_loads == 1 and coalesced == 3, (n_loads, coalesced))
        # a's page pool runs dry while b is resident and idle: b is pinned
        # by a held lease while a loads (the pool overshoots its budget),
        # then released; every free page of a's pool is then held (as
        # in-flight work would hold it)
        # a's load serves a one-token full prefix hit of a's first prompt:
        # every K1 call is held against the plain version (the chunk of
        # the prompt's last tokens over its whole cached prefix)
        pool.acquire("b")
        worst = {"o": 0.0, "lse": 0.0}
        shapes: set = set()
        with flash_route(checked_flash(fa, worst, shapes, calls)):
            status, out = post(port, "/v1/models/a:generate", one)
        pool.release("b")
        first = streams[1][:len(body["ids"][0]) + 1]
        same = status == 200 and out["ids"][0] == first
        log(f"phase 14(b): a's one-token full prefix hit (Sq, Sk) "
            f"{sorted(shapes)}: every K1 call vs plain: |dO|/allowance "
            f"{worst['o']:.3f} (tol {IN_MODEL_TOL['o']:g}), lse "
            f"{worst['lse']:.3g} (tol {IN_MODEL_TOL['lse']:g}); first token "
            f"equals the cold stream's: {same}")
        check(same and shapes and in_model_ok(worst), (status, worst, shapes))
        check(pool.state_of("a") == pool.state_of("b") == "resident",
              pool.stats())
        loads = {n: pool.stats()["models"][n]["last_load_seconds"]
                 for n in ("a", "b")}
        log(f"phase 14(b): a loaded in {loads['a']:.3f}s while b was "
            "pinned (the budget overshoots)")
        pages = a.engine.pool
        cap0 = pages.stats()["pages"]
        free0 = pages.free_count
        held += pages.alloc(free0)
        cached0 = a.engine.prefix_cache.stats()["pages"]
        status, out = post(port, "/v1/models/a:generate", bodies[2])
        check(status == 200 and out["ids"][0] == streams[2], status)
        st = pages.stats()
        donated = pool.stats()["donated_pages"]
        log(f"phase 14(b): a's pool of {cap0} pages with {len(held)} held: "
            f"a {PROMPT_LENS[2]}-token request relieved b (parked "
            f"{b.parked}), {donated} pages donated "
            f"({CKPT_BYTES} // {pages.page_nbytes}); pool now {st['pages']} "
            f"pages over {st['device_rows']} device rows; prefix evictions "
            f"{len(evicted)}; cached pages {cached0} -> "
            f"{a.engine.prefix_cache.stats()['pages']}")
        check(b.parked and donated == CKPT_BYTES // pages.page_nbytes
              == DONATED_PAGES, (donated, b.parked))
        check(st["pages"] == cap0 + DONATED_PAGES and evicted == [], st)
        # b comes back through the pool's entry point (no request to it:
        # its one-token prefill was cut): a (idle) parks, then the free
        # donated slots return and no live page moves
        in_use = pages.stats()["in_use"]
        headroom = pages.free_count
        pool.acquire("b")
        pool.release("b")
        check(a.parked and not b.parked, "a parks to make room for b")
        st = pages.stats()
        reclaimed = DONATED_PAGES - pool.stats()["donated_pages"]
        log(f"phase 14(b): b warmed again; reclaimed {reclaimed} donated "
            f"slots (free headroom {headroom}), {DONATED_PAGES - reclaimed} "
            f"stay donated; live pages {in_use} -> {st['in_use']}; device "
            f"rows stay {st['device_rows']}")
        check(reclaimed == min(DONATED_PAGES, headroom) and st["in_use"]
              == in_use and evicted == [], (reclaimed, headroom, st))
        # every park freed the weights: memory_allocated falls by
        # weight_bytes, each tensor's block rounded up to 512 bytes
        n_tensors = len(a._shapes)
        log("phase 14(b): parks (model, weight_bytes, memory_allocated "
            "drop): " + "; ".join(f"{n} {f} {d}" for n, f, d in parks))
        for name, freed, drop in parks:
            check(freed == CKPT_BYTES
                  and 0 <= drop - freed <= 512 * n_tensors,
                  (name, freed, drop))
        return {"loads": loads, "load_b_s": after["last_load_seconds"],
                "resident_ttft_s": resident_ttft,
                "cold_ttft_s": max(w for _, w in walls),
                "donated": donated, "reclaimed": reclaimed,
                "device_rows": st["device_rows"],
                "parks": parks}
    finally:
        if held:
            a.engine.pool.decref(held)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        mp.set_model_pool(None)
        a.stop(timeout=60)
        b.stop(timeout=60)


def fleet_classifiers(fa) -> dict:
    """Phase 14(e): ``:predict`` over HTTP for ``mnist_mlp`` (against the
    same predictor's CPU copy), and BERT-large on one 128-token row
    through K1 (24 launches), every call held against the plain version,
    the logits against the plain attention route."""
    from kubeflow_tpu_torch.serving.httpserve import serve
    from kubeflow_tpu_torch.serving.predictor import (ClassifierPredictor,
                                                      PredictorApp)

    mlp = ClassifierPredictor("mnist_mlp", seed=0)
    images = np.random.default_rng(4).standard_normal(
        (4, 28, 28, 1)).astype(np.float32)
    httpd, thread = serve(PredictorApp({"mnist_mlp": mlp}), 0)
    try:
        status, out = post(httpd.server_port, "/v1/models/mnist_mlp:predict",
                           {"instances": images.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    host = ClassifierPredictor("mnist_mlp", seed=0, device="cpu")
    with torch.no_grad():
        host.module.load_state_dict({k: v.cpu() for k, v in
                                     mlp.module.state_dict().items()})
    want = host.forward(torch.from_numpy(images))
    got = torch.tensor(out["logits"])
    err = (got - want).abs().max().item()
    log(f"phase 14(e): mnist_mlp :predict over HTTP: status {status}, "
        f"predictions {out['predictions']}, logits max |card - cpu| "
        f"{err:.3e} (tol 1e-4)")
    check(status == 200 and out["predictions"]
          == want.argmax(-1).tolist() and err <= 1e-4, (status, err))
    bert = ClassifierPredictor("bert", model_config={"size": "large"},
                               seed=0)
    rows = np.random.default_rng(5).integers(
        0, bert.module.config.vocab_size, (1, BERT_ROW))
    x = torch.from_numpy(rows)
    bert.forward(x)                                  # warm, not counted
    set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))  # the path starts
    logits = bert.forward(x)
    launches = counters(fa)["flash_fwd"]              # the path ended
    worst, shapes = {"o": 0.0, "lse": 0.0}, set()
    with torch.no_grad(), flash_route(checked_flash(fa, worst, shapes)):
        bert.forward(x)
    with plain_attention_route(bert.module):
        ref = bert.forward(x)
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    preds = bert.predict(rows.tolist())["predictions"]
    tol = LOGITS_REL_TOL["plain_route"]
    log(f"phase 14(e): BERT-large :predict [1, {BERT_ROW}]: flash_fwd "
        f"launches {launches} (expected 24); every K1 call vs plain: "
        f"|dO|/allowance {worst['o']:.3f} (tol {IN_MODEL_TOL['o']:g}), lse "
        f"{worst['lse']:.2e}; logits kernel vs plain route: max rel err "
        f"{rel:.3e} (tol {tol:g}); predictions equal argmax "
        f"{preds == logits.argmax(-1).tolist()}")
    check(launches == 24 and in_model_ok(worst) and rel <= tol
          and bool(torch.isfinite(logits).all())
          and preds == logits.argmax(-1).tolist(),
          (launches, worst, rel))
    del bert, mlp
    free_memory()
    return {"bert_launches": launches, "bert_rel": rel}


def phase_fleet(fa, phase2: list | None = None) -> dict:
    """Phase 14 (module docstring); ``phase2``: phase 2's streams, when
    it ran.  Every K1 call of the phase is recorded for the numbers."""
    t_phase = time.perf_counter()
    ckpt = checkpoint_home(CKPT_BYTES)
    calls: list = []
    out: dict = {}
    try:
        set_counters(fa, dict.fromkeys(KERNEL_NAMES, 0))   # the path starts
        with flash_route(recording_flash(fa, calls)):
            pred, bodies, streams, out["restore"] = fleet_restore(
                fa, ckpt, phase2)
            out["tenants"] = fleet_tenants(pred.module, pred.cfg)
            out["tracing"] = fleet_tracing(pred, bodies, streams)
            pred.stop(timeout=60)
            del pred
            free_memory()
            out["restore"].update(fleet_int8_restore(ckpt))
            out["residency"] = fleet_residency(fa, ckpt, bodies, streams,
                                               calls)
            free_memory()
            launches = counters(fa)["flash_fwd"]
        out.update(fleet_classifiers(fa))
    finally:
        import shutil

        shutil.rmtree(ckpt, ignore_errors=True)
        log(f"phase 14: removed {ckpt}")
    check(launches == len(calls), (launches, len(calls)))
    # BERT's :predict ran K1 at one shape, outside the recording
    out["calls"] = calls + [(1, BERT_ROW, BERT_ROW, 16, 16, 64, False)] \
        * out["bert_launches"]
    out["launches"] = len(out["calls"])
    log(f"phase 14: flash_fwd launches {out['launches']} ({launches} in the "
        f"7B traffic, {out['bert_launches']} in BERT's :predict); "
        f"{time.perf_counter() - t_phase:.1f}s")
    return out


def fleet_numbers(fa, calls: list) -> list[dict]:
    """K1 rows of phase 14: its recorded calls grouped by shape, each
    shape timed once (kernel, plain version, SDPA) beside its bound."""
    counts: dict[tuple, int] = {}
    for c in calls:
        counts[c] = counts.get(c, 0) + 1
    rows = []
    for (b, sq, sk, h, hkv, d, causal), n in sorted(counts.items()):
        ms, plain_ms, library_ms = k1_times(fa, b, sq, sk, h, hkv, d, causal)
        name = f"{'bert_predict' if d == 64 else '7b_fleet'}_{sq}x{sk}"
        row = {"shape": name, "launches": n, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               **bound_fields("flash_fwd", (b, sq, sk, h, hkv, d, causal),
                              torch.bfloat16)}
        log(f"flash_fwd {name} bf16 (x{n} in phase 14): kernel {ms:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
        rows.append(row)
    return rows


def kernel_times_only(fa) -> int:
    """``--kernel-times``: build the kernels and time K1, K2 and K3 at the
    Llama training shape and at the causal 2048 shape (for an A/B of two
    trees' kernels in one call); prints no result line."""
    from kubeflow_tpu_torch.ops import _build

    check_build(_build.build_all())
    log(card_line())
    name, *shape = LLAMA_SHAPE
    ms, _, _ = kernel_times(fa, tuple(shape), seed=12, plain_too=False)
    for kernel in KERNEL_NAMES:
        bound = bound_fields(kernel, tuple(shape), torch.bfloat16)
        log(f"{kernel} {name} bf16: kernel {ms[kernel]:.5f} ms, bound "
            f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})")
    causal_numbers(fa)
    return 0


def some_phases(fa, which: str) -> int:
    """``--phases 9,12,13``: build and check the kernels (phase 1), then
    the named phases (9 to 22; 22 runs phase 2 first, its reference);
    prints no result line."""
    wanted = {int(w) for w in which.split(",") if w}
    if not wanted <= set(range(9, 23)):
        print(f"chip_smoke: --phases takes 9 to 22, not {which}",
              file=sys.stderr)
        return 2
    phase_kernels(fa)
    gang_phases = tuple(p for p in (17, 18, 19, 20, 21, 22) if p in wanted)
    if gang_phases:
        serving = phase_serving(fa) if 22 in wanted else None
        free_memory()
        gangs = phase_gangs(fa, gang_phases, serving)
        free_memory()
        log(card_line())
        if 17 in gangs:
            gang_numbers(fa, gangs[17], training_numbers(
                fa, TRAIN_SHAPE, dict.fromkeys(KERNEL_NAMES, 0),
                TRAIN_LAUNCHES))
        mesh_rows = mesh_numbers(fa, gangs[18]) if 18 in gangs else None
        if 19 in gangs:
            sp_numbers(fa, gangs[19])
        if 20 in gangs:
            moe_ep_numbers(fa, gangs[20], mesh_rows)
        if 21 in gangs:
            mh_numbers(fa, gangs[21])
        if 22 in gangs:
            p22_numbers(fa, gangs[22])
    gemma = {}
    if 15 in wanted:
        gemma["serving"] = phase_gemma_serving(fa)
        free_memory()
    if 16 in wanted:
        gemma["training"] = phase_gemma_training(fa)
    if gemma:
        log(card_line())
        gemma_numbers(fa, gemma.get("serving"), gemma.get("training"))
    if 14 in wanted:
        fleet = phase_fleet(fa)
        free_memory()
        fleet_numbers(fa, fleet["calls"])
    if 12 in wanted:
        phase_int8(fa)
        free_memory()
    if 13 in wanted:
        phase_disagg(fa)
        free_memory()
    if 11 in wanted:
        phase_speculation(fa)
        free_memory()
    if 9 in wanted:
        phase_serving(fa, {"moe_experts": MOE_EXPERTS}, "MoE llama 7b",
                      extra=moe_serving_extras)
        free_memory()
    if 10 in wanted:
        phase_moe_training(fa)
    log(card_line())
    return 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    import kubeflow_tpu_torch
    from kubeflow_tpu_torch.ops import flash_attention as fa

    pkg = Path(kubeflow_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        print(f"chip_smoke: kubeflow_tpu_torch was imported from {pkg}, not "
              f"from the checkout beside this script ({ROOT})",
              file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    if argv == ["--kernel-times"]:
        return kernel_times_only(fa)
    if len(argv) == 2 and argv[0] == "--phases":
        return some_phases(fa, argv[1])
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    errs = phase_kernels(fa)
    serving = phase_serving(fa)
    phase_profile()
    free_memory()
    prefix = phase_prefix_cache(fa)
    spec = phase_speculation(fa)
    free_memory()      # the phase's engines, reachable until it returned
    moe = phase_serving(fa, {"moe_experts": MOE_EXPERTS}, "MoE llama 7b",
                        extra=moe_serving_extras)
    free_memory()
    int8 = phase_int8(fa)
    free_memory()
    disagg = phase_disagg(fa, serving["streams"],
                          serving["decode_tok_per_s"])
    free_memory()
    fleet = phase_fleet(fa, serving["streams"])
    free_memory()
    gemma_serving = phase_gemma_serving(fa)
    free_memory()
    log(f"before training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card")
    bert = phase_training(fa, TRAIN_CONFIG, TRAIN_LAUNCHES, "BERT-large")
    check_training_step(fa, TRAIN_CONFIG, TRAIN_LAUNCHES, "BERT-large")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    llama = phase_training(fa, LLAMA_CONFIG, LLAMA_LAUNCHES,
                           f"Llama-7B-width x{LLAMA_LAYERS} layers")
    free_memory()
    check_training_step(fa, LLAMA_CONFIG, LLAMA_LAUNCHES,
                        f"Llama-7B-width x{LLAMA_LAYERS} layers")
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"Llama phase peak memory (max_memory_allocated over the counted run "
        f"and its checks): {peak / 1e9:.2f} GB, {100 * peak / card:.1f}% of "
        f"the card's {card / 1e9:.2f} GB")
    free_memory()
    moe_train = phase_moe_training(fa)
    free_memory()
    gemma_train = phase_gemma_training(fa)
    vision = phase_vision(fa)
    gangs = phase_gangs(fa, phase2=serving)
    gang, mesh, sp, moe_ep, multihost, p22 = (
        gangs[p] for p in (17, 18, 19, 20, 21, 22))
    log(card_line())
    serving_rows = phase_numbers(fa, main_path_shapes(), num_layers=32)
    prefix_rows = phase_numbers(fa, prefix_path_shapes(), num_layers=32)
    bert_rows = training_numbers(fa, TRAIN_SHAPE, bert["launches"],
                                 TRAIN_LAUNCHES)
    llama_rows = training_numbers(fa, LLAMA_SHAPE, llama["launches"],
                                  LLAMA_LAUNCHES)
    spec_rows = spec_numbers(fa, spec["shapes"])
    fleet_rows = fleet_numbers(fa, fleet["calls"])
    gemma_rows = gemma_numbers(fa, gemma_serving, gemma_train)
    gang_rows = gang_numbers(fa, gang, bert_rows)
    mesh_rows = mesh_numbers(fa, mesh)
    sp_rows = sp_numbers(fa, sp)
    moe_ep_rows = moe_ep_numbers(fa, moe_ep, mesh_rows)
    mh_rows = mh_numbers(fa, multihost)
    p22_rows = p22_numbers(fa, p22)
    causal_numbers(fa)
    log(f"phase 2: TTFT mean {serving['ttft_mean_s'] * 1e3:.1f} ms over the "
        f"4 concurrent requests; decode "
        f"{serving['decode_tok_per_s']:.1f} tok/s over 4 slots")
    log("phase 7: TTFT ms cold " + " ".join(
        f"{t:.2f}" for t in prefix["ttft_cold_ms"]) + ", warm " + " ".join(
        f"{t:.2f}" for t in prefix["ttft_warm_ms"])
        + f"; seed {prefix['seed_ms']:.4f} ms, commit "
        f"{prefix['commit_ms']:.4f} ms; spills {prefix['spills']}, faults "
        f"{prefix['faults']}; {prefix['same_streams']} of 4 warm streams "
        f"token-identical to cold")
    log(f"phase 9 (MoE): TTFT mean {moe['ttft_mean_s'] * 1e3:.1f} ms over "
        f"the 4 concurrent requests; decode {moe['decode_tok_per_s']:.1f} "
        f"tok/s over 4 slots; device time of a 512-token chunk "
        f"{moe['chunk_ms']:.3f} ms, of a 4-row decode step "
        f"{moe['decode_ms']:.3f} ms; capacity drops of the block check "
        f"{moe['moe_block_drops']}")
    log(f"phase 12 (int8 weights): TTFT mean "
        f"{int8['ttft_mean_s'] * 1e3:.1f} ms over the 4 concurrent requests;"
        f" decode {int8['decode_tok_per_s']:.1f} tok/s over 4 slots; device "
        f"time of a 512-token chunk {int8['chunk_ms']:.3f} ms, of a 4-row "
        f"decode step {int8['decode_ms']:.3f} ms (bf16: phase 3); "
        f"dequantizing every weight once {int8['dequant_ms']:.3f} ms; "
        f"weight_bytes {int8['weight_bytes']} against {int8['bf16_bytes']} "
        f"in bf16; int8 KV: {int8['kv_pages']} pages per {PC_CACHE_MB} MB "
        f"against {int8['kv_bf16_pages']}, perplexity ratio "
        f"{int8['ppl_ratio']:.6f}, TTFT ms " + " ".join(
            f"{t:.2f}" for t in int8["kv_ttft_ms"]))
    log("phase 13(a) (bf16 pages across processes), per request: " + "; ".join(
        f"{n} tokens {r['wire_bytes']} B, serialize "
        f"{r['serialize_s'] * 1e3:.1f} ms, POST {r['post_s'] * 1e3:.1f} ms, "
        f"deserialize {r['deserialize_s'] * 1e3:.1f} ms, TTFT "
        f"{r['ttft_s'] * 1e3:.1f} ms"
        for n, r in sorted(disagg["handoffs"].items()))
        + f"; phase 13(b) (int8 pages in process): decode "
        f"{disagg['int8_decode_tok_per_s']:.1f} tok/s against phase 2's "
        f"{serving['decode_tok_per_s']:.1f} colocated")
    res = fleet["residency"]
    log(f"phase 14: restore {fleet['restore']['restore_s']:.3f}s at "
        f"{fleet['restore']['restore_gb_s']:.2f} GB/s (pinned copy_ "
        f"{fleet['restore']['h2d_gb_s']:.2f} GB/s), checkpoint write "
        f"{fleet['restore']['save_s']:.2f}s, max_staged_bytes "
        f"{fleet['restore']['max_staged']}; int8 restore "
        f"{fleet['restore']['int8_restore_s']:.3f}s, peak "
        f"{fleet['restore']['int8_peak']} B over {fleet['restore']['int8_bytes']}"
        f" B of weights; load of b {res['load_b_s']:.3f}s, cold TTFT "
        f"{res['cold_ttft_s'] * 1e3:.1f} ms against resident "
        f"{res['resident_ttft_s'] * 1e3:.1f} ms, donated {res['donated']} "
        f"pages, reclaimed {res['reclaimed']}; victim TTFT "
        f"{fleet['tenants']['wfq']['ttft_s'] * 1e3:.1f} ms under WFQ "
        f"(position {fleet['tenants']['wfq']['pos']}) against "
        f"{fleet['tenants']['fifo']['ttft_s'] * 1e3:.1f} ms FIFO (position "
        f"{fleet['tenants']['fifo']['pos']}); decode "
        f"{fleet['tracing']['tok_s_rate0']:.1f} tok/s untraced, "
        f"{fleet['tracing']['tok_s_rate1']:.1f} traced; BERT-large logits "
        f"kernel vs plain route {fleet['bert_rel']:.3e}")
    log("phase 11 (tok/s): " + "; ".join(
        f"{m} " + " and ".join(f"{x:.2f}" for x in spec[m]["tok_per_s"])
        + (f", accept rate {spec[m]['accept_rate']:.3f} ({spec[m]['accepted']}"
           f" of {spec[m]['proposed']} in {spec[m]['rounds']} rounds)"
           if m != "off" else "")
        for m in SPEC_MODES))
    log(f"training samples/s: BERT-large {bert['samples_per_sec']:.2f}, "
        f"Llama-7B-width x{LLAMA_LAYERS} {llama['samples_per_sec']:.3f}, "
        f"MoE Llama-7B-width x{MOE_LAYERS} "
        f"{moe_train['samples_per_sec']:.3f} (peak "
        f"{moe_train['peak_gb']:.2f} GB), "
        + ", ".join(f"{m} {r['samples_per_sec']:.1f}"
                    for m, r in vision.items())
        + f", {GEMMA_LABEL} {gemma_train['samples_per_sec']:.3f} (peak "
        f"{gemma_train['peak_gb']:.2f} GB); phase 15: TTFT mean "
        f"{gemma_serving['ttft_mean_s'] * 1e3:.1f} ms, decode "
        f"{gemma_serving['decode_tok_per_s']:.1f} tok/s over 4 slots"
        + f"; phase 17: BERT-large gang of {GANG_RANKS} "
        f"{gang['BERT-large']['gang_samples_per_s']:.2f} against one process "
        f"{gang['BERT-large']['one_samples_per_s']:.2f} (all-reduce "
        f"{gang['BERT-large']['allreduce_s']:.4f} s and "
        f"{gang['BERT-large']['allreduce_bytes']:.0f} bytes per step), "
        f"ResNet-50 gang {gang['ResNet-50']['gang_samples_per_s']:.1f} "
        f"against {gang['ResNet-50']['one_samples_per_s']:.1f} (all-reduce "
        f"{gang['ResNet-50']['allreduce_s']:.4f} s and "
        f"{gang['ResNet-50']['allreduce_bytes']:.0f} bytes per step)"
        + "; phase 18: " + ", ".join(
            f"{label} {r['samples_per_s']:.2f} (peak {r['steps_peak_gb']:.2f}"
            f" GB over the steps, {r['peak_gb']:.2f} GB over the run)"
            for label, r in mesh.items())
        + f"; phase 19: one process {sp['one']['samples_per_s']:.3f}, "
        f"sp={SP_RANKS} {sp['sp_samples_per_s']:.3f} (rows of {SP_SEQ} "
        f"tokens)"
        + "; phase 20 (MoE): " + ", ".join(
            f"{label} {r['samples_per_s']:.3f}"
            for label, r in moe_ep.items())
        + "; phase 21 (load s, prefill s, decode tok/s): " + ", ".join(
            f"{label} {multihost[label]['load_s']:.2f} / "
            f"{multihost[label]['prefill_s']:.3f} / "
            f"{multihost[label]['decode_tok_s']:.1f}"
            for label, *_ in MH_LAYOUTS)
        + "; phase 22 (load s, decode tok/s, step records): " + ", ".join(
            f"{label} {p22[label]['load_s']:.2f} / "
            f"{p22[label]['decode_tok_s']:.1f} / "
            f"{p22[label]['records'].get('records', 0)}"
            for label, *_ in P22_LAYOUTS)
        + f", residency (c) {p22['residency']['wall_s']:.2f} s"
        + f", disaggregated (d) {p22['disagg']['wall_s']:.2f} s"
        + f"; total {time.perf_counter() - t_start:.1f}s")
    check(serving["launches"] == sum(r["launches"] for r in serving_rows),
          "serving launches")
    check(prefix["launches"] == sum(r["launches"] for r in prefix_rows),
          "prefix-cached serving launches")
    check(moe["launches"] == serving["launches"], "MoE serving launches")
    check(int8["launches"] == disagg["launches"] == disagg["int8_launches"]
          == serving["launches"], "int8 and disaggregated serving launches")
    check(int8["kv_launches"] == prefix["launches"], "int8 KV launches")
    check(spec["launches"] == sum(r["launches"] for r in spec_rows),
          "speculative serving launches")
    check(fleet["launches"] == sum(r["launches"] for r in fleet_rows),
          "phase 14 launches")
    # phases 9, 12 and 13 run K1 at phase 2's shapes, phase 12's int8 KV
    # traffic at phase 7's, phase 10 at phase 5's
    shared_rows = [with_launches(r, r["launches"], label)
                   for label in ("MoE", "int8", "disagg", "disagg int8 KV")
                   for r in serving_rows]
    shared_rows += [with_launches(r, r["launches"], "int8 KV")
                    for r in prefix_rows]
    moe_train_rows = {name: with_launches(
        llama_rows[name], moe_train["launches"][name], "MoE")
        for name in KERNEL_NAMES}
    kernels = [kernel_entry("flash_fwd", serving_rows + prefix_rows
                            + shared_rows + spec_rows + fleet_rows
                            + [bert_rows["flash_fwd"], llama_rows["flash_fwd"],
                               moe_train_rows["flash_fwd"]]
                            + gang_rows["flash_fwd"]
                            + mesh_rows["flash_fwd"] + sp_rows["flash_fwd"]
                            + moe_ep_rows["flash_fwd"] + mh_rows
                            + p22_rows, errs["flash_fwd"])]
    kernels += [kernel_entry(name, [bert_rows[name], llama_rows[name],
                                    moe_train_rows[name]] + gang_rows[name]
                             + mesh_rows[name] + sp_rows[name]
                             + moe_ep_rows[name], errs[name])
                for name in ("flash_bwd_dq", "flash_bwd_dkv")]
    # the D = 256 instantiations: K1 on phases 15 and 16, K2 and K3 on 16
    train_256 = gemma_rows["training"]
    kernels += [kernel_entry(f"{name}<256>", (
        gemma_rows["serving"] if name == "flash_fwd" else [])
        + [train_256[name]], errs[f"{name}<256>"]) for name in KERNEL_NAMES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
