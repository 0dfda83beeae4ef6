#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel built from ``tpushare_torch/ops/csrc/*.cu`` by
   ``nvcc`` for ``sm_90a`` (one compiler per source, started together);
   for K1, K3/K4 and K2's prefill arm (the wgmma kernels), ptxas's lines
   of every instantiation (registers, spills, any serialised wgmma: each
   must show 0 bytes of spill and no serialised wgmma) and whether their
   SASS holds ``HGMMA`` (wgmma),
   ``UTMALDG`` and ``UTMASTG`` (TMA), read with ``cuobjdump`` where the
   toolkit has it;
3. K1 (flash forward) against its plain PyTorch version at the serving
   ``/score`` shape (S = 2048, 32 heads over 8 kv heads, D = 128, causal),
   S = 2047 (the forward of a 2048-token ``/score``), a ragged S = 1000,
   a window of 256, D = 64 non-causal, and its tile edges (S around
   multiples of 64 and 128, causal or not, both head dims, GQA ratios
   1, 4 and 8, windows around a key tile); then its own device time and
   ``scaled_dot_product_attention``'s by ``torch.profiler`` at S = 2048
   and S = 8192 (``tpushare_torch.profile_k1``), and at the encoder's
   shape (B = 32, 12 heads, S = 128, D = 64, non-causal; SDPA with
   ``is_causal=False``) with its bound, and one BERT-base batch's
   profile (``bench.profile_batch``, for the bert phase), here early in
   the run because late in it the profiler has dropped launches of that
   21 µs kernel;
4. K2 (paged read) against its plain version at decode (8 rows of
   contexts 100-2000 over shuffled pages of the full Llama-3-8B pool,
   through the decode arm ``csrc/paged_decode.cu``) and at a 2000-token
   prefill window (``csrc/paged_attn.cu``), for the bf16 pool and for
   the int8 store (its own entry points); then K2's striped variants (one
   entry point a store and arm) on each of 2 position stripes of that
   pool, laid out as the batcher lays it, against the plain version (out,
   m, l), and the stripes merged against the unstriped K2 over the same
   keys; each entry point's device time by the profiler with the kernels
   it launched a call and, at decode, the split count the wrapper gave
   the timed launches; then K2 at the tp phase's per-shard shape (8
   rows of 2000 tokens, 16 q and 4 kv heads: both arms against the plain
   version, the decode arm timed against its bytes bound) and
   ``sharded_paged_decode_attention`` over a pool split on 2 tp shards
   against the whole pool's plain read; then the decode
   arm's edges, all four entry points (a 1-token context, contexts at
   split boundaries +-1 key, a window of 256 whose leading splits are
   empty, a table wider than every context, a stripe whose rows keep no
   key, n_rep 1, 4 and 8, D 64 and 128, B = 1); then the prefill arm's
   edges, all four entry points (the windowed ring's 64-token chunk at
   a context of ~2000, S not a multiple of 128 at n_rep 1 and 8, a
   window that skips whole key tiles, pages of 16, 8, 4, and 6 for the
   bf16 pool, a table of 20,000 entries); then the speculative VERIFY
   shape, all four entry points (``profile_k2.VERIFY_EDGES``: 8 rows from
   unaligned committed lengths over 100-2000, S = 1 + k for k = 4 and 8,
   n_rep 1, 4 and 8, blocks that cross a page, a window, rows whose tail
   runs past the table), and the bf16 pool's time at the verify shape
   (8 rows, k = 8);
5. K3 + K4 (flash backward, dK/dV and dQ) against their plain version at
   the training shape (B = 1, S = 2048, 32 heads over 8 kv heads,
   D = 128, causal), with an lse cotangent, at a ragged S = 1000 with and
   without a window of 256, D = 64 non-causal, and their tile edges (K1's
   edge S, windows around a tile, n_rep 1, 4 and 8 with and without the
   lse cotangent); then K3's and K4's own device time by the profiler,
   the port's whole backward's (dvec = rowsum(dO * O), K3, K4) and
   SDPA's backward's (its own dO * O preprocess included), at S = 2048
   and S = 8192 (``tpushare_torch.profile_k1 --bwd``);
6. sp_attention: sequence-parallel long-context attention on a mesh of 4
   ``sp`` shards on the one card (``make_mesh({"sp": 4}, devices=
   ["cuda:0"] * 4)``): the ring (plain and non-causal over native GQA,
   zigzag) and Ulysses (K/V expanded to the 32 q heads) alone at
   Llama-3-8B's attention shape (B = 1, 32 q heads over 8 kv heads,
   S = 8192, D = 128, bf16), each output against K1 over the whole
   sequence within OUT_TOL and dq, dk, dv of one random cotangent
   against the whole sequence's K1 + K3 + K4 within BWD_TOL, K1, K3 and
   K4 launched ``sp_launches`` times a call (plain causal n(n+1)/2 = 10,
   zigzag n(2n+1) = 36, non-causal n^2 = 16, Ulysses n = 4); by the
   profiler each shard's K1 under the plain and the zigzag ring, every
   schedule's forward and backward and the whole sequence's, beside the
   causal bound; then Llama-3-8B at full width and depth through
   ``forward(attention_fn=)`` with the plain ring, the zigzag ring and
   Ulysses on one 8192-token prompt (K1 10, 36 and 4 a layer), the
   logits at every position within LOGIT_TOL or 1.25x the hookless
   forward's distance from itself on the reference attention; then, at 2
   of its layers and 4096 tokens, the loss (LSE_TOL relative) and every
   leaf's gradient (BWD_TOL of its largest magnitude) through the ring
   hook against without it;
7. the server: Llama-3-8B at full width and depth with random seeded
   weights, an in-process ``LLMServer`` (8 slots, pages of 16; its
   service admits a prompt whole when no slot decodes, else streams it
   in 64-token windows through mixed rounds of a 128-token prefill
   budget and 8 decode steps), four concurrent ``/generate`` requests
   and one 2048-token ``/score``; the kernels' launch counters are
   zeroed just before and read just after; then the arrivals load
   (three decoders, the 2000-token prompt sent once they decode, which
   the service must stream; K2 in every layer of every forward); then
   fleet trace propagation, one request at a time: a ``/generate`` and a
   ``/generate_stream`` carrying a ``traceparent`` body field, every
   round span of their windows in ``/debug/trace?since=`` carrying the
   id in ``traces``, K2 (both arms) launched in those rounds, each one's
   ``admit`` event in ``/debug/events`` carrying ``trace``; a malformed
   ``traceparent`` answered 200 with untraced rounds; every family on
   ``/metrics`` a row of ``docs/METRICS_TORCH.md``; then
   the cost plane from ``/metrics``: ``tpushare_program_flops_total`` > 0
   in the prefill, decode and mixed phases, the MFU gauge in (0, 1] and
   ``tpushare_roofline_bound_info`` one-hot; then an 8-row decode step's
   cost-card FLOPs (without the context term: K2 has no profiler FLOPs)
   within 2% of ``torch.profiler``'s ``with_flops`` count of its mm /
   bmm / addmm; then
   the ``mixed`` check: the greedy prompts on a paged pool through
   ``admit_chunked(chunk=64)`` and ``tick_mixed(8, chunk=64,
   budget=128)`` against ``admit`` and ``tick``, their first-step and
   first decode-step logits within LOGIT_TOL or 1.25x the pool's own
   K2-against-gather distance, and on the weights widened to f32 through
   the gather read within F32_LOGIT_TOL; then the arrivals load on
   batchers both ways (the long prompt admitted whole or streamed): its
   time to the first token, the decoders' time to their last and their
   longest wait between rounds; then ``utils.profiler``: ``device_trace``
   around one decode step of an 8-row paged batcher writes a Chrome trace
   naming K2's decode kernel once a layer (32), and ``time_fn`` on that
   step prints ``compile_s`` and ``p50_s`` on a line of their own; then
   ``runtime.distributed`` on one host: ``init_distributed({})`` makes no
   process group and ``global_mesh({"dp": -1}, env={})`` is one shard
   on ``cuda:0``;
8. agreement: ``flagship-small`` in bf16, the K2 read path against the
   gather path, in f32 and in bf16 (first-step logits and greedy
   streams), and the no-cache forward through K1 against the gather
   path's prefill logits;
9. dense: Llama-3-8B at full width and depth (bf16 weights) served from
   DENSE slot rows, ``LLMServer(n_slots=8, page_size=0)`` (8 rows of
   8,192 tokens, 8.59 GB), the server phase's load; its ``storage_info``
   says dense with the pool's bytes; K1 launched once a layer for the
   ``/score`` and K2 never (the dense read is ``cached_attention`` in
   plain PyTorch); the greedy prompts' first-step logits, and their
   logits at the first decode step from the same token, against a paged
   pool's on the same weights, within LOGIT_TOL or 1.25x the paged pool's
   own K2-against-gather distance at those steps; a dense and a paged
   decode step's wall and device busy time (``profile_decode``'s
   profiler);
10. generate: ``LLMServer(n_slots=0)`` on the same weights, one 2000-token
   greedy ``/generate`` of 32 new tokens through ``generate_fused``, its
   tokens per second; its first-step and first decode-step logits
   against the dense batcher's within the same tolerance, its first two
   tokens their argmaxes, and beside them a one-row dense batcher's; on
   the weights widened to f32 its first-step and first decode-step logits
   against a one-row f32 dense batcher's within F32_LOGIT_TOL; no kernel
   runs;
11. spec: prompt-lookup speculation (depth 8, 4 verify rounds a call) on
    the dense phase's Llama-3-8B weights: ``LLMServer(n_slots=8,
    page_size=16, spec_k=8)`` serves the four greedy prompts, a sampled
    one and a 256-token prompt that repeats a 16-token pattern, 32 new
    tokens each, in turns with a server at ``spec_k`` 0 (its tokens per
    second beside the spec server's); the counters zeroed just before
    and read just after: K2's S > 1 arm once a layer of every prefill and
    verify forward, its decode arm of every decode step; ``/stats``'
    speculation block nonzero; in bf16 through K2 the greedy prompts'
    first tokens equal the ticked pool's and their first verify block's
    position-0 logits within LOGIT_TOL or 1.25x the pool's
    K2-against-gather distance of the ticked decode step's; on the
    weights widened to f32 the spec rounds' greedy streams equal
    ``tick_fused``'s on a paged pool (gather read) and on dense rows; a
    short spec pass on an int8 store and on 2 stripes, each verify
    forward one launch a layer (a stripe) of its S > 1 entry point;
12. rolling: Mistral-7B at full width and depth (bf16 random weights) on
    a ``ContinuousBatcher`` with AUTO rolling slots (4 rings of 4,096
    tokens, 2.15 GB, an eighth of a full row each): a 5,000-token greedy
    prompt that wraps the ring, admitted by ``admit_chunked(chunk=512)``
    and drained by ``tick_mixed``, 32 new tokens, no kernel run; its
    first-step logits, and in f32 its first decode step's past the wrap,
    against a one-slot full-row pool's on the same weights and rounds:
    in f32 (the weights widened) within F32_LOGIT_TOL, in bf16 no further
    from the f32 row than 1.25x the bf16 row is; then the same prompt
    through spec rounds on rings with 8 slots of slack (4,104 tokens);
13. sp_stripe: Llama-3-8B at full width and depth (bf16 weights) served by
    a ``ContinuousService`` whose pool of 2 x 257 pages is striped over a
    mesh of two shards on the one card (``make_mesh({"sp": 2}, devices=
    [cuda:0, cuda:0])``): the server phase's load plus a 6,000-token
    greedy prompt, which an unstriped pool of 257 pages (the same bytes a
    device) refuses; the counters are zeroed just before and read just
    after (K2's striped variant twice per layer of every paged forward,
    the unstriped K2 never); first-step logits of the greedy prompts
    against an unstriped pool of 700 pages on the same weights; a striped
    and an unstriped decode step's wall; then the same on int8 pools;
14. tp: Llama-3-8B at full width and depth served tensor-parallel on a
    mesh of two tp shards on the one card (``make_mesh({"tp": 2},
    devices=[cuda:0, cuda:0])``: the Megatron split of the weights, the
    pool's kv heads half a shard): the server phase's four requests
    through a ``ContinuousService`` over a 700-page bf16 pool, an int8
    pool and a ``{"tp": 2, "sp": 2}`` mesh of four shards, the counters
    zeroed just before each load and read just after (K2 twice per layer
    of every paged forward, four times striped under tp x sp, every
    launch at 16 q and 4 kv heads); the greedy prompts' first-step and
    first decode-step logits against a tp = 1 pool on the same weights,
    within LOGIT_TOL or 1.25x that pool's K2-against-gather distance;
    dense rows at tp = 2 (first-step logits against tp = 1);
    ``forward(mesh=)`` at a 2000-token prompt (K1 twice per layer, logits
    at every position against tp = 1 within LOGIT_TOL or 1.25x the tp = 1
    forward's distance from itself on the reference attention); a decode step of 8 rows at tp = 2 and at tp = 1
    (wall, busy, ops), each part's seconds;
14b. tp_quant: quantized weights split over tp: Llama-3-8B at full width
    and depth with int8, then grouped int4, weights on the same mesh of
    two tp shards (int8 ``q`` and int4 ``q4`` blocks by the reference's
    rule, the scales whole): every tp tree's codes exactly half of the
    whole tree's bytes; the server phase's four requests over a bf16
    pool, K2 twice a layer of every paged forward at 16 q and 4 kv heads;
    first-step and first decode-step logits against a tp = 1 pool on the
    same weights within LOGIT_TOL or 1.25x its K2-against-gather
    distance; int4 at tp = 1 against a bf16 model of ``dequantize4`` of
    the same codes, the same bound on that model; the 8-row decode step
    at tp = 2 and tp = 1 (wall, busy, ops); then QLoRA on an int8 base at
    Llama-3-8B's widths and 16 layers on ``{"tp": 2}``, one row of 2049
    tokens, 2 steps: the first loss within 1e-4 relative of the tp = 1
    step's, the losses falling, the base unchanged, K1 / K3 / K4 32 a
    step;
15. prefix: Llama-2-7B at full width and depth (bf16 random weights,
    32 heads over 32 kv heads: K2 at n_rep = 1) on
    ``LLMServer(n_slots=8, page_size=16, prefix_cache=True)`` (8 x 256
    pages + 1, 17.2 GB): four conversations, each a 1,024-token system
    prompt and a first user turn of 64-256 tokens, sent concurrently,
    then their second turns (the first prompt, its 32-token reply and a
    64-token user turn) concurrently, 32 new tokens each, and the same
    without the cache; the registry holds one prefix a conversation, the
    second turns prefill only the reply and the new turn, K2 in every
    paged layer; the second turns' first-step logits with the cache
    against without it (bf16 within LOGIT_TOL or 1.25x the
    K2-against-gather distance, f32 through the gather read within
    F32_LOGIT_TOL); the turns' TTFT both ways;
16. migrate: the session lifecycle on Llama-3-8B at full width and
    depth (bf16 random weights): four greedy sessions of 100-2000 tokens
    and a sampled one (temperature 0.8) moved, after 9 decode steps,
    from one paged batcher to another on the same weights, on a bf16 and
    an int8 pool: the receiver's first step within LOGIT_TOL of the
    uninterrupted run's (0.0 expected: the same operations), the streams
    token-equal, K2's decode arm in every layer of the receiver's steps;
    one session into a pool of 2 stripes, its first step within
    LOGIT_TOL or 1.25x the unstriped pool's K2-against-gather distance;
    the blobs' bytes a token, export and import walls and GB/s, the int8
    blob at most 0.55 of the bf16; the spill tier (a
    ``ContinuousService`` over a pool of two sessions' pages, a budget
    of four sessions, six requests): every request whole, peak admitted
    at least twice the run without it, restores timed, K2 in every
    layer, and on the weights widened to f32 through the gather read
    every stream equal to its run alone; two ``LLMServer``s on one set
    of weights: ``/drain {"migrate_to": B}`` while A decodes (every
    client's full row, A's ``/healthz`` drained), a ``phase: "prefill"``
    request on A finished by B's ``/migrate_in`` (its blob's header
    ``trace`` None and B's rounds untraced), the same with a
    ``traceparent`` (the header's ``trace`` its id, every round span of
    B's import carrying it, K2's decode arm in them), B's ``/metrics``
    migration families moved, and in f32 the drained streams equal the
    undrained run's (the f32 checks on the model's first 16 layers);
17. adapters: multi-adapter LoRA serving on Llama-3-8B at full width and
    depth (bf16 random weights, synthetic rank-8 adapters drawn from
    their names): 8 base rows of 256-2000 tokens, 32 new each, through a
    batcher with a pool of 4 adapters against a pool-less one, on the
    paged pool and on dense rows, streams equal and every step's logits
    0.0 apart; a mixed batch of the 8 rows over three adapters and the
    base against each row served alone in a batcher of the same slots
    and pool: the adapter rows' first-step and first decode-step logit
    distances no further than the base rows', every adapter's stream off
    the base stream for its prompt, one adapter's first-step logits
    against a plain f32 forward on weights merged as W + s A B (within
    2x the base rows' distance from the f32 forward on W, which the
    merge must exceed), and with the counters zeroed K2's
    prefill arm once a layer of every admission and its decode arm once
    a layer of every step; ``LLMServer(n_slots=8, adapter_slots=4)``:
    four requests pin four adapters, a fifth adapter gets 503 and
    ``Retry-After``, then loads with one ``capacity`` eviction, the
    pool's bytes (``/metrics``) 5 x ``adapter_entry_bytes`` and
    ``/stats``' merged bytes an adapter; a ``{"text": ...}`` prompt
    answered BOS, its bytes + 2, the generated ids and a text starting
    with it; an adapter session moved between two batchers after 9
    steps, its first step 0.0 from the unmoved run's, and refused by a
    pool-less receiver as a config mismatch; and a decode step's wall,
    busy time and ops with the mixed rows against the same rows without
    a pool (``profile_decode``'s profiler);
18. moe: mixture-of-experts serving at Mixtral-8x7B's widths (Mistral-7B's
    attention, 8 experts of d_ff 14,336, top-2, every layer routed;
    bf16 random seeded weights) and 16 of its 32 layers (45.1 GB of
    experts): the 16-layer Mistral-7B wrapped as ``n_experts=1`` (its FFN
    as expert 0, a zero router) against the dense model on the paged
    pool, first-step and first decode-step logits 0.0 apart and the
    streams equal; one layer's ``moe_ffn`` at the decode shape (8 tokens)
    within 1.25x the reference's literal per-token formula's distance
    (bf16) from that formula in f32; the adapters phase's 8 prompts (32
    new each) as one batch against each row alone in a batcher of the
    same 8 slots: 0.0 at the first step and the first decode step, every
    stream equal, K2's two arms once a layer of every forward; an
    ``LLMServer`` (8 slots, pages of 16) under the server phase's load
    (136 new tokens a request): K2 16 times a forward, both arms, K1 16
    for the ``/score``, ``/stats``' expert keys (8 experts, top-2,
    45,098,205,248 bytes, 1 shard) and ``/metrics``' expert families
    (``tpushare_moe_experts`` 8, ``tpushare_expert_load`` observed in
    multiples of 8); a decode step's wall, busy time and ops (8 rows)
    beside the bytes bound, and a 2000-token admission's beside the
    routed and the evaluated FLOPs; then expert parallelism on the same
    params, the ep shards the one card listed again: (a) one layer's
    ``moe_ffn`` at ep = 2 against ep = 1 at a 2000-token admission and an
    8-row decode step (0.0 expected; within the mixture check's slack);
    (b) the 8 prompts through a paged batcher on ``{"ep": 2}``, the
    first-step and first decode-step logits within LOGIT_TOL of the ep =
    1 batch's (0.0 expected) and the streams equal where they are, K2's
    arms once a layer of every forward, ``storage_info`` 2 shards of half
    the pool's bytes, an 8-row decode step's wall / busy / ops beside ep =
    1's; (c) the same on ``{"pp": 2, "ep": 2}`` against a flat ep = 1
    batch, both full-causal (the window's page ring refuses the staged
    step), the staged step's K2 decode arm n_layers x n_micro a step; (d) an ``LLMServer`` on the ep =
    2 mesh under the server phase's load (K1 16 for the ``/score``
    through the sharded mixture, K2 16 a forward, ``/stats``' mesh
    ``{"ep": 2}``, ``tpushare_expert_fallback_total`` unmoved), and an E =
    8 pool on ``{"ep": 3}`` demoted (``ep_experts``), counted once, named
    in ``storage_info``, serving;
19. grant: the server started as a pod is, by ``llm.start_server`` under
    the device plugin's env for a 14 GiB pod on an 80-unit card (the
    allocator capped at the fraction 0.175 before anything is built),
    Llama-3-8B at full width and depth with int8 weights (built one layer
    slice at a time) and a 1 GiB int8 KV pool, the server phase's load;
    checks the int8 K2 in every layer of every paged forward (the bf16
    one never), the peak reserved memory inside the grant, and an
    allocation past the grant refused; then the tenant plane: the env
    also names a stdlib ``/usage`` sink in this script
    (``TPUSHARE_STATUS_PORT``, a report a second), the registry and the
    health monitor reset just before the server starts; at least 3
    reports, each peak inside the grant, device time never falling and
    under the server's uptime, generated tokens equal to those the load
    received, ``flops`` > 0 (the cost plane's work counters),
    ``/metrics`` parsed by the port's ``parse_text`` and
    ``/healthz`` 200; then the sink answers ``pace:<r>``, r half the
    load's device-time rate, under a further 8-second closed-loop load:
    the device time the reports show over the paced window at most r x
    window + ``PACE_BURST_S`` x r + one round (the longest guard of the
    window, by its histogram bucket); then ``refuse``: ``/generate``
    answers 429 with ``Retry-After``; then ``ok``: it serves again; and
    beside them one request's wall, the device time its guards attributed
    and the rounds' walls, and the profiler's busy time for the same
    request again; then the fraction goes back to 1;
20. train, after the serving memory is freed: ``Trainer`` on
    Llama-3-8B at full width and depth (random seeded weights, AdamW,
    ``remat="layer"``, ``head_chunk=512``, lr 3e-4), four steps on one
    seeded [1, 2049] batch; the counters are zeroed just before and read
    after every step (K1, K3 and K4 each once per layer and step); then,
    that model freed, a QLoRA fine-tune: the int8 Llama-3-8B loraized at
    rank 8 on its seven projections, ``make_lora_train_step(remat=
    "layer")`` for 4 steps on the batch: the first loss bit-equal to the
    int8 base model's, every base leaf bit-unchanged and every adapter's
    ``b`` moved, the optimizer state over the adapter dict alone, K1, K3
    and K4 once a layer and step; the step's wall, busy time, ops and
    peak memory; ``merge_lora``'s bf16 weights against the loraized
    model's logits within 2x the distance that rounding the int8 base to
    bf16 weights moves them;
21. train_sharded, sharded training at Llama-3-8B's widths and 16
    layers on meshes that repeat the one card, tokens [4, 2049]: (a)
    ``pipeline_loss_and_grads`` on ``{"pp": 2}`` at 4 microbatches
    against the flat ``lm_loss`` gradient summed microbatch by
    microbatch in f32 (the loss within 1e-5 relative, each leaf within
    1e-2 of its largest magnitude after the bf16 cast, K1 / K3 / K4
    M.L.(2S-1)/S, M.L and M.L times); (b) ``Trainer(mesh={"pp": 2})``
    and (c) ``{"dp": 2, "pp": 2}`` for 3 steps (K1 / K3 / K4
    dp.M.L.(2S-1)/S, dp.M.L and dp.M.L a step, M the pp size), (d)
    ``{"fsdp": 2, "tp": 2}`` (remat "layer", head chunks of 512) for 2:
    the loss falling from within 1% of the flat loss, every parameter
    finite, one profiled step's wall, busy time and ops, the peak
    memory; (e) the (a) check on ``{"tp": 2, "pp": 2}``, each stage's
    slab through the tp split, against the flat gradient of the same tp
    split, and against the unsplit model: the loss within 1e-4 relative
    of (a)'s flat loss, each leaf no further from the unsplit f32
    gradient than 1.5x (a)'s flat bf16 leaf is (or 1e-2); K1 / K3 / K4
    twice (a)'s; (f) a rank-8
    LoRA ``Trainer`` on ``{"fsdp": 2, "tp": 2}`` (remat "layer", head
    chunks of 512) for 3 steps: the first loss bit-equal to the base
    model's on that mesh, the losses falling, every base leaf
    bit-unchanged, a ``b`` moved, K1 / K3 / K4 tp.L a step, one profiled
    step's wall, busy time and ops, the peak memory;
22. bert: K1 at the encoder shape (B = 32, 12 heads, S = 128, D = 64,
    non-causal) and at S = 512 against its plain version; then
    BERT-base and DistilBERT at full width and depth (random
    seeded bf16 weights) through ``InferenceEngine``: K1 launched once a
    layer of every forward over a ``measure_qps`` run, hidden states
    through K1 no further from the f32 reference (the dense mask path
    with an all-ones mask on the weights widened to f32) than 1.25x the
    bf16 dense mask path is; a ``pass_mask`` engine under ragged
    requests sent from four threads, each row within that bound of the
    request served alone; then ``tpushare_torch.bench``'s record, the
    counters zeroed just before (``bert_base_infer_qps``, MFU,
    ``vs_baseline``, TTFT, TPOT), with one batch's wall, busy time and
    operations split into GEMMs, K1 and the rest as its
    ``batch_profile``: that profile is taken in phase 3, early, where
    the profiler keeps every launch of a window;
23. cotenancy: ``tpushare_torch.probe_cotenancy``'s sections, tenants as
    worker processes under the allocation env: BERT-base and DistilBERT
    alone at 8 and 4 GiB, two BERT-base tenants at 8 GiB, four
    DistilBERT tenants at 4 GiB, and four 4 GiB tenants allocating
    256 MiB chunks until refused; every tenant ok, each one's peak
    reserved memory within its grant, each allocating tenant refused by
    its own allocator within one chunk of its grant while its
    neighbours hold theirs; the aggregates against solo.

Then it prints the ``kernels`` line (time on the card, the plain version's
time, one PyTorch library call's time, and the least time the card could
take; K2 a row per arm and entry point, ``paged_attn*`` timed at the
prefill window and ``paged_decode*`` at decode with the redesign's
``stage`` and the split count of its timed launches (``paged_decode``
and ``paged_decode_int8`` also with ``migrate_launches``, the migrate
phase's launches on imported and restored sessions, and ``paged_attn``
and ``paged_decode`` with ``adapter_launches``, the adapters phase's on
its mixed-adapter batch, ``moe_launches``, the moe phase's server's, and
``ep_launches``, its expert-parallel rows', staged batch's and server's;
K1 with ``moe_launches``, ``ep_launches`` (the ep server's ``/score``)
and ``qlora_launches``, K3/K4 with
``qlora_launches``), and
``paged_attn_verify`` at the verify shape with the spec phase's verify
launches, and beside them all its S > 1 launches and the prefills' share;
``paged_decode_tp_shard`` at the tp phase's per-shard shape with its bf16
load's decode launches and its int8 and tp x sp ones beside them, and
the tp_quant phase's (``tp_quant_launches``); K1, K3 and K4 with
``tp_qlora_launches``, the tp_quant phase's QLoRA steps;
``device_ms``,
the kernel's own time by the
profiler, and for K1
and K3/K4 ``library_device_ms`` and ``library_kernel`` the same of the
library call; for K1, K3 and K4 also ``tflops`` and ``bound_share`` on
their device time, and ``long_*`` at S = 8192, and for K1 ``bert_*``
at the encoder's shape with the bench run's launches; for K3/K4
``backward_device_ms``, the port's whole backward; for K1, K3 and K4
``sp_attention_launches``, the sp_attention phase's, and
``train_sharded_launches``, the train_sharded phase's, with its
launches a step), the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line, as does a machine without CUDA or a directory that
holds this script and nothing else of the repository.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: kernel vs its plain version on the card, bf16 inputs: P is rounded to
#: bf16 before PV in both, so the outputs differ by the accumulation order
#: and the rounding of P relative to a running (kernel) or final (plain)
#: max; the lse is f32 throughout
OUT_TOL = 2e-2
LSE_TOL = 1e-3
#: K3 / K4 vs their plain version, bf16 inputs: both round P and dS to
#: bf16 before the second product, the kernel from an ex2.approx
#: exponential, so an element may land one bf16 step away; each of dQ,
#: dK, dV within this share of the plain version's largest magnitude
BWD_TOL = 2e-2
#: first-step logits of a whole bf16 model (flagship-small) through the K2
#: read path against the same weights in f32 through the gather path; and
#: of Llama-3-8B through the striped read against the unstriped one, or,
#: where a 32-layer model's bf16 noise is larger, 1.25x the distance
#: between the unstriped pool's own two read paths (K2 and the gather)
LOGIT_TOL = 5e-2
#: one storage against another on the same weights widened to f32 (the
#: dense rows against the paged pool's gather read, Mistral-7B's rolling
#: ring against a full row), at the first step and the first decode
#: step: the two sum the same keys in other orders
F32_LOGIT_TOL = 1e-4

SEED = 0

#: the stages of K2's decode-arm redesign that csrc/paged_decode.cu holds
DECODE_STAGE = ("1-3: split-KV over the page table with the combine in the "
                "kernel's tail; every warp on the keys, over non-empty "
                "splits only; int8 dequantized in registers")
#: the stages of K2's prefill-arm redesign that csrc/paged_attn.cu holds
PREFILL_STAGE = ("1-4: 128 packed GQA rows a block, a producer warpgroup "
                 "copying 128-key tiles through the page table by cp.async "
                 "into swizzled stages, two consumer warpgroups on wgmma; "
                 "the int8 store dequantized by the producer; striped")


class PhaseFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, f"nvidia-smi failed: {smi.stderr}")
    return {"nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build():
    from tpushare_torch.ops import _cuda

    t0 = time.perf_counter()
    took = _cuda.build()
    regs = {}
    for name in _cuda.ENTRY_POINTS:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        regs[name] = [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln]
        _cuda.library(name)
    # K1, K3/K4 and K2's prefill arm on Hopper's own paths: wgmma (HGMMA)
    # and TMA (UTMALDG, UTMASTG) in their SASS, and ptxas's lines
    # (registers, spills, any serialised wgmma) for every instantiation
    # (two a kernel of K1 and K3/K4: D 64 and 128; eight of the prefill
    # arm: D, store and striped): no spill, no serialised wgmma
    out = {"seconds": time.perf_counter() - t0, "per_source_s": took,
           "arch": "sm_90a", "ptxas": regs}
    for key, lib, kernels, n in (
            ("k1", "flash_fwd", ("flash_fwd_kernel",), 2),
            ("k3k4", "flash_bwd", ("dkv_kernel", "dq_kernel"), 4),
            ("k2p", "paged_attn", ("paged_prefill_kernel",), 8)):
        report = {fn: lines for fn, lines in _cuda.ptxas_report(lib).items()
                  if any(k in fn for k in kernels)}
        check(len(report) == n, f"{key}'s ptxas report: {report}")
        for fn, lines in report.items():
            text = " ".join(lines)
            check("0 bytes spill stores, 0 bytes spill loads" in text
                  and "serializ" not in text,
                  f"{key}: {fn} spills or serialises its wgmmas: {lines}")
        sass = _cuda.sass_opcodes(lib, ("HGMMA", "UTMALDG", "UTMASTG"))
        if sass is not None:
            check(all(sass.values()), f"{key}'s SASS lacks an opcode: {sass}")
        out[f"{key}_ptxas"] = report
        out[f"{key}_sass"] = (sass if sass is not None
                              else "cuobjdump not in the toolkit")
    return out


def _flash_case(torch, attn, b, h, hkv, s, d, causal, window, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = (lambda *shape: torch.randn(*shape, generator=g, device="cuda",
                                     dtype=torch.bfloat16))
    q, k, v = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d)
    out, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                        window=window)
    p_out, p_lse = attn._flash_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (out.float() - p_out.float()).abs().max().item()
    lse_err = (lse - p_lse).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "K1 output not finite")
    check(err <= OUT_TOL and lse_err <= LSE_TOL,
          f"K1 {s=} {d=} {causal=} {window=}: out err {err}, "
          f"lse err {lse_err}")
    return (q, k, v), {"S": s, "D": d, "H": h, "Hkv": hkv, "causal": causal,
                       "window": window, "max_abs_err": err,
                       "lse_max_abs_err": lse_err}


#: K1's tile edges (its blocks own 128 query rows and walk keys 128 at a
#: time): S around multiples of 64 and 128, a lone row, the ragged /score
#: S and the main one, causal and not, both head dims, GQA ratios 1, 4
#: and 8 in turn, B = 2; then windows around a key tile
K1_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 1000, 2047, 2048)
K1_GQA = ((4, 4), (8, 2), (8, 1))
K1_EDGE_CASES = tuple(
    (2, *K1_GQA[i % len(K1_GQA)], s, d, causal, 0)
    for i, s in enumerate(K1_EDGE_S) for d in (64, 128)
    for causal in (True, False)) + tuple(
    (2, 8, 2, s, d, True, w) for w in (1, 127, 128, 129, 256)
    for s in (129, 1000, 2048) for d in (64, 128))


def phase_k1(torch, flush):
    from tpushare_torch import profile_k1
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.utils.cuda_timing import event_ms

    cases = []
    (q, k, v), main = _flash_case(torch, attn, 1, 32, 8, 2048, 128, True,
                                  0, SEED)
    for args in ((1, 32, 8, 2047, 128, True, 0),      # /score's forward
                 (1, 32, 8, 1000, 128, True, 0),      # ragged tail
                 (1, 32, 8, 2048, 128, True, 256),    # sliding window
                 (2, 8, 8, 512, 64, False, 0)):       # D = 64, non-causal
        cases.append(_flash_case(torch, attn, *args, SEED + 1)[1])
    edge_err = edge_lse_err = 0.0
    for i, args in enumerate(K1_EDGE_CASES):
        c = _flash_case(torch, attn, *args, SEED + 100 + i)[1]
        edge_err = max(edge_err, c["max_abs_err"])
        edge_lse_err = max(edge_lse_err, c["lse_max_abs_err"])
    torch.cuda.empty_cache()
    # events around the wrapper (host launch path included) and the plain
    # version, on the main case's inputs
    main["ms"] = event_ms(lambda: attn.flash_attention_lse(q, k, v),
                         20, flush)
    main["plain_ms"] = event_ms(
        lambda: attn._flash_plain(q, k, v, True, 0), 5, flush)
    del q, k, v
    # the kernel's own device time and the library's, by the profiler,
    # at the main shape and at a long /score (S = 8192, no plain version)
    for s, key in ((2048, "main"), (8192, "long")):
        res = profile_k1.profile_shape(s, 20, flush, seed=SEED + 2)
        if key == "main":
            main.update({"device_ms": res["device_ms"],
                         "library_device_ms": res["library_device_ms"],
                         "library_ms": res["library_event_ms"],
                         "library_kernel": res["library_kernel"],
                         "bound_ms": res["bound_ms"],
                         "bound_by": res["bound_by"],
                         "tflops": res["tflops"],
                         "bound_share": res["bound_share"],
                         "library_tflops": res["library_tflops"],
                         "profiled_event_ms": res["event_ms"]})
        else:
            main["long"] = res
        torch.cuda.empty_cache()
    return {"main": main, "encoder": _k1_encoder_times(torch, attn, flush),
            "bert_batch": _bert_batch_profile(torch),
            "cases": cases, "edge_cases": len(K1_EDGE_CASES),
            "edge_max_abs_err": edge_err,
            "edge_lse_max_abs_err": edge_lse_err}


#: the encoder's batch: BERT-base at the root bench's shape
BERT_BATCH, BERT_SEQ = 32, 128


def _k1_encoder_times(torch, attn, flush) -> dict:
    """K1 at the encoder's shape (B = 32, 12 heads, S = 128, D = 64,
    non-causal): events around the wrapper and the plain version, and
    the kernel's and SDPA's own device time by the profiler.  Taken here,
    early in the run: late in a long run the profiler has lost most of a
    window's launches of this 21 µs kernel (the bert phase holds K1 to
    its plain version at this shape)."""
    from tpushare_torch import profile_k1
    from tpushare_torch.utils.cuda_timing import event_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 302)
    q, k, v = (torch.randn(BERT_BATCH, 12, BERT_SEQ, 64, generator=g,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    out = {"ms": event_ms(lambda: attn.flash_attention_lse(
        q, k, v, causal=False), 20, flush),
        "plain_ms": event_ms(lambda: attn._flash_plain(q, k, v, False, 0),
                             5, flush)}
    del q, k, v
    res = profile_k1.profile_shape(BERT_SEQ, 20, flush, seed=SEED + 302,
                                   b=BERT_BATCH, h=12, hkv=12, d=64,
                                   causal=False)
    out.update({key: res[key] for key in (
        "B", "H", "Hkv", "S", "D", "causal", "device_ms",
        "library_device_ms", "library_kernel", "bound_ms", "bound_by",
        "bound_share", "flops", "bytes", "tflops")})
    out["library_ms"] = res["library_event_ms"]
    torch.cuda.empty_cache()
    return out


def _bert_batch_profile(torch) -> dict:
    """One BERT-base batch (B = 32, S = 128, seeded random bf16 weights)
    by ``bench.profile_batch``: wall, device busy time and operations
    split into GEMMs, K1 and the rest.  Taken here, early in the run,
    for the reason of ``_k1_encoder_times``: late in the run every
    window of three could come up short of K1 launches, and the bert
    phase's ``bench.measure`` then raised."""
    from tpushare_torch import bench
    from tpushare_torch.models import bert

    cfg = bench.MODELS["bert_base"]()
    params = bert.init_params(cfg, seed=bench.SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 303)
    tokens = torch.randint(1, 100, (BERT_BATCH, BERT_SEQ), generator=g,
                           device="cuda", dtype=torch.int32)
    res = bench.profile_batch(lambda t: bert.forward(params, t, cfg),
                              tokens, cfg.n_layers)
    del params, tokens
    torch.cuda.empty_cache()
    return res


def _paged_case(torch, attn, contexts, s, seed, int8=False):
    """q at the last ``s`` positions of each row's context, over pages of
    a full-size Llama-3-8B layer pool drawn without replacement; with
    ``int8`` the pool is quantized into int8 {"q","s"} stores first."""
    from tpushare_torch import profile_k2

    args = profile_k2.paged_operands(contexts, s, seed, int8=int8)
    out = attn.paged_decode_attention(*args)
    ref = attn._paged_plain(*args, None)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    kind = "int8" if int8 else "bf16"
    check(torch.isfinite(out.float()).all().item(),
          f"K2 ({kind}) output not finite")
    check(err <= OUT_TOL,
          f"K2 ({kind}) contexts={contexts} S={s}: out err {err}")
    # bytes this run's data needs: each row's live K and V once (an int8
    # store: one byte a value plus its key's f32 scale), q, o, the table
    # and positions; operations: QK and PV over the kept (query, key)
    # pairs
    flops, nbytes = profile_k2.read_cost(contexts, s, int8)
    return args, {"store": kind, "contexts": contexts, "S": s,
                  "max_abs_err": err, "flops": flops, "bytes": nbytes}


def _striped_case(torch, attn, contexts, s, seed, int8, sp=2, page=16):
    """K2's striped variant on each of ``sp`` position stripes of a
    full-size Llama-3-8B layer pool laid out as the batcher lays it
    (range j of a row on stripe j % sp, never a stripe's trash page),
    held to the plain version on the stripe's local table and pos_map:
    out within OUT_TOL, m within LSE_TOL, l within LSE_TOL relative; the
    stripes' partials merged (``sp_merge_partials``) held to the
    unstriped K2 over the same keys within OUT_TOL.  Returns stripe 0's
    arguments and the case's numbers, with the bytes and operations of
    stripe 0's launch: the keys its rows keep, and their (query, key)
    pairs."""
    from tpushare_torch import profile_k2

    q, k_pool, v_pool, table, positions, layer, per, mesh = \
        profile_k2.striped_operands(contexts, s, seed, int8=int8, sp=sp)
    outs, ms, ls, errs, args0 = [], [], [], [], None
    for t, (ks, vs) in enumerate(layer):
        tbl, pmap = attn.striped_local_view(table, sp, t, per, page)
        args = (q, ks, vs, tbl, positions)
        o, m, l = attn.paged_decode_attention(*args, pos_map=pmap,
                                              return_stats=True)
        po, pm, pl = attn._paged_plain(*args, None, pos_map=pmap,
                                       return_stats=True)
        torch.cuda.synchronize()
        errs.append({
            "out": (o.float() - po.float()).abs().max().item(),
            "m": (m - pm).abs().max().item(),
            "l_rel": ((l - pl).abs() / pl.clamp_min(1e-30)).max().item(),
            "rows_without_keys": int((pl == 0).sum().item())})
        check(torch.isfinite(o.float()).all().item(),
              f"striped K2 stripe {t} output not finite")
        outs.append(o)
        ms.append(m)
        ls.append(l)
        if t == 0:
            args0 = args + (pmap,)
    kind = "int8" if int8 else "bf16"
    for t, e in enumerate(errs):
        check(e["out"] <= OUT_TOL and e["m"] <= LSE_TOL
              and e["l_rel"] <= LSE_TOL,
              f"striped K2 ({kind}) S={s} stripe {t}: {e}")
    merged = attn.sp_merge_partials(outs, ms, ls, q.device)
    whole = attn.paged_decode_attention(q, k_pool, v_pool, table, positions)
    merge_err = (merged.float() - whole.float()).abs().max().item()
    check(merge_err <= OUT_TOL,
          f"striped K2 ({kind}) S={s}: merged stripes {merge_err} from the "
          f"unstriped K2")
    # stripe 0's launch: the keys of ranges 0, sp, 2sp, ... at or before
    # each row's last position, once; the (query, key) pairs its rows keep
    flops, nbytes = profile_k2.read_cost(contexts, s, int8, sp=sp)
    return args0, {"store": kind, "contexts": contexts, "S": s, "sp": sp,
                   "max_abs_err": max(e["out"] for e in errs),
                   "stripes": errs, "merged_vs_unstriped_err": merge_err,
                   "flops": flops, "bytes": nbytes}


def _time_k2(torch, attn, case, args, kw, iters, plain_iters, flush):
    """K2's times at one case: ms by events around the wrapper, its own
    device time by the profiler (at S = 1 the decode arm's one kernel,
    its splits' fold included) with the kernels it launched a call, the
    plain version's ms (``plain_iters`` 0: not timed), the bound and the
    rate; at S = 1 also the split plan the timed calls were given."""
    from tpushare_torch.utils.cuda_timing import (bound_ms, device_ms,
                                                  event_ms)

    kernel = lambda: attn.paged_decode_attention(*args, **kw)  # noqa: E731
    case["ms"] = event_ms(kernel, iters, flush)
    attn.paged_decode_attention.decode_plan = None
    case["device_ms"], case["kernels"] = device_ms(kernel, iters, flush)
    if case["S"] == 1:
        plan = attn.paged_decode_attention.decode_plan
        check(plan is not None, "K2's timed decode calls left no split plan")
        case["split_pages"], case["n_splits"] = plan
    if plain_iters:
        case["plain_ms"] = event_ms(
            lambda: attn._paged_plain(*args, None, **kw), plain_iters, flush)
    case["bound_ms"], case["bound_by"] = bound_ms(case["flops"],
                                                  case["bytes"])
    case["gbps"] = case["bytes"] / case["ms"] / 1e6


def _k2_edges(torch, attn, cases, arm: str, seed: int):
    """Every K2 entry point of one arm against the plain version at
    ``cases`` ((contexts, S, window, n_rep, d, page, n_tbl), q at each
    row's last S positions; the int8 entry points where the page is a
    multiple of 4), on a pool of 600 pages with 2 kv heads, striped as
    the batcher stripes it: out within OUT_TOL; striped, each stripe's m
    within LSE_TOL and l within LSE_TOL relative, and a row that keeps no
    key of a stripe out 0, m NEG_INF and l 0 exactly; every call one
    launch of its entry point of ``arm`` (``"_decode"`` or ``""``, the
    prefill arm)."""
    from tpushare_torch import profile_k2

    worst = {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    empty_rows = calls = 0
    k2 = attn.paged_decode_attention
    for i, (contexts, s, window, n_rep, d, page, n_tbl) in enumerate(cases):
        for int8 in (False, True) if page % 4 == 0 else (False,):
            q, kp, vp, table, pos, stripes, per, _ = \
                profile_k2.striped_operands(
                    contexts, s, seed + i, int8=int8, n_pages=600, hkv=2,
                    h=2 * n_rep, d=d, page=page, n_tbl=n_tbl)
            kind = "_int8" if int8 else ""
            what = (f"K2{kind} edge {contexts} S={s} {window=} {n_rep=} "
                    f"{d=} {page=}")
            counter = f"launches{arm}{kind}"
            before = getattr(k2, counter)
            out = k2(q, kp, vp, table, pos, window=window)
            ref = attn._paged_plain(q, kp, vp, table, pos, window)
            torch.cuda.synchronize()
            calls += 1
            err = (out.float() - ref.float()).abs().max().item()
            check(getattr(k2, counter) == before + 1,
                  f"{what} did not run its arm")
            check(torch.isfinite(out.float()).all().item() and
                  err <= OUT_TOL, f"{what}: out err {err}")
            worst["out"] = max(worst["out"], err)
            for t, (sk, sv) in enumerate(stripes):
                tbl, pmap = attn.striped_local_view(table, 2, t, per, page)
                before = getattr(k2, counter + "_striped")
                o, m, l = k2(q, sk, sv, tbl, pos, window=window,
                             pos_map=pmap, return_stats=True)
                po, pm, pl = attn._paged_plain(q, sk, sv, tbl, pos, window,
                                               pos_map=pmap,
                                               return_stats=True)
                torch.cuda.synchronize()
                calls += 1
                e = {"out": (o.float() - po.float()).abs().max().item(),
                     "m": (m - pm).abs().max().item(),
                     "l_rel": ((l - pl).abs() / pl.clamp_min(1e-30))
                     .max().item()}
                none = pl == 0
                check(getattr(k2, counter + "_striped") == before + 1
                      and e["out"] <= OUT_TOL and e["m"] <= LSE_TOL
                      and e["l_rel"] <= LSE_TOL
                      and bool((l[none] == 0).all())
                      and bool((m[none] == attn.NEG_INF).all())
                      and bool((o[none] == 0).all()),
                      f"striped {what} stripe {t}: {e}")
                empty_rows += int(none.sum())
                worst = {k: max(v, e[k]) for k, v in worst.items()}
            torch.cuda.empty_cache()
    return {"cases": len(cases), "calls": calls, "max_err": worst,
            "stripe_rows_without_keys": empty_rows}


def _k2_decode_edges(torch, attn):
    """The decode arm (S = 1) at ``profile_k2.DECODE_EDGES``, pages of 16
    and tables of 160 entries (``_k2_edges``); some stripe row keeps no
    key."""
    from tpushare_torch import profile_k2

    res = _k2_edges(torch, attn, [
        (contexts, 1, window, n_rep, d, 16, 160)
        for contexts, window, n_rep, d in profile_k2.DECODE_EDGES],
        "_decode", SEED + 300)
    check(res["stripe_rows_without_keys"] > 0,
          "no decode edge left a stripe row without keys")
    return res


def _k2_prefill_edges(torch, attn):
    """The prefill arm (S > 1) at ``profile_k2.PREFILL_EDGES``
    (``_k2_edges``)."""
    from tpushare_torch import profile_k2

    return _k2_edges(torch, attn, profile_k2.PREFILL_EDGES, "", SEED + 400)


def _k2_verify_edges(torch, attn):
    """The prefill arm at the speculative verify shape,
    ``profile_k2.VERIFY_EDGES`` (``_k2_edges``): 8 rows from unaligned
    committed lengths over 100-2000, S = 1 + k for k = 4 and 8, n_rep 1,
    4 and 8, blocks that cross a page, a window, rows whose tail runs
    past the table."""
    from tpushare_torch import profile_k2

    return _k2_edges(torch, attn, profile_k2.VERIFY_EDGES, "", SEED + 500)


def phase_k2(torch, flush):
    """The bf16 pool and the int8 store, each at decode and at a
    2000-token prefill window, unstriped and on 2 position stripes; the
    bf16 pool at the speculative verify shape (8 rows, a k = 8 block a
    row from its own unaligned start, the prefill arm); then the decode
    arm's edges (``_k2_decode_edges``), the prefill arm's
    (``_k2_prefill_edges``) and the verify shape's
    (``_k2_verify_edges``)."""
    from tpushare_torch import profile_k2
    from tpushare_torch.ops import attention as attn

    contexts = [100, 371, 642, 913, 1184, 1455, 1726, 2000]
    res = {}
    for int8 in (False, True):
        prefix = "int8_" if int8 else ""
        args, dec = _striped_case(torch, attn, contexts, 1, SEED + 4, int8)
        kw = {"pos_map": args[5], "return_stats": True}
        _time_k2(torch, attn, dec, args[:5], kw, 50, 5, flush)
        del args
        args, pre = _striped_case(torch, attn, [2000], 2000, SEED + 5, int8)
        kw = {"pos_map": args[5], "return_stats": True}
        _time_k2(torch, attn, pre, args[:5], kw, 10, 3, flush)
        del args
        torch.cuda.empty_cache()
        res.update({prefix + "striped_decode": dec,
                    prefix + "striped_prefill": pre})
    for int8 in (False, True):
        args, dec = _paged_case(torch, attn, contexts, 1, SEED + 2,
                                int8=int8)
        _time_k2(torch, attn, dec, args, {}, 50, 5, flush)
        del args
        pargs, pre = _paged_case(torch, attn, [2000], 2000, SEED + 3,
                                 int8=int8)
        _time_k2(torch, attn, pre, pargs, {}, 10, 3, flush)
        del pargs
        torch.cuda.empty_cache()
        prefix = "int8_" if int8 else ""
        res.update({prefix + "decode": dec, prefix + "prefill": pre})
    vcontexts, vs = profile_k2.SHAPES["verify"]
    args, ver = _paged_case(torch, attn, list(vcontexts), vs, SEED + 6)
    _time_k2(torch, attn, ver, args, {}, 50, 5, flush)
    del args
    torch.cuda.empty_cache()
    res["verify"] = ver
    res["tp_shard"] = _tp_k2_shard(torch, attn, flush)
    res["decode_edges"] = _k2_decode_edges(torch, attn)
    res["prefill_edges"] = _k2_prefill_edges(torch, attn)
    res["verify_edges"] = _k2_verify_edges(torch, attn)
    return res


def _bwd_case(torch, attn, b, h, hkv, s, d, causal, window, g_lse, seed):
    """K3 and K4 on random bf16 q, k, v, dO, the plain forward's lse and
    dvec = rowsum(dO * O) (minus a random lse cotangent), against
    ``_flash_bwd_plain`` on the same inputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = (lambda *shape: torch.randn(*shape, generator=g, device="cuda",
                                     dtype=torch.bfloat16))
    q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
        mk(b, h, s, d)
    out, lse = attn._flash_plain(q, k, v, causal, window)
    dvec = (do.float() * out.float()).sum(-1)
    if g_lse:
        dvec = dvec - torch.randn(b, h, s, generator=g, device="cuda")
    args = (q, k, v, do, lse.contiguous(), dvec.contiguous(), causal, window)
    dk, dv = attn.flash_bwd_dkv(*args)
    dq = attn.flash_bwd_dq(*args)
    ref = attn._flash_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(torch.isfinite(got.float()).all().item(),
              f"K3/K4 {name} not finite")
        errs[name] = ((got.float() - want.float()).abs().max()
                      / want.float().abs().max()).item()
    check(max(errs.values()) <= BWD_TOL,
          f"K3/K4 {s=} {d=} {causal=} {window=} {g_lse=}: relative errors "
          f"{errs}")
    return args, {"S": s, "D": d, "H": h, "Hkv": hkv, "causal": causal,
                  "window": window, "lse_cotangent": g_lse,
                  "rel_err": errs,
                  "max_abs_err": {"dq": (dq.float() - ref[0].float()).abs()
                                  .max().item(),
                                  "dk": (dk.float() - ref[1].float()).abs()
                                  .max().item(),
                                  "dv": (dv.float() - ref[2].float()).abs()
                                  .max().item()}}


#: K3/K4's tile edges, as ``tests/test_torch_cuda.py`` holds them (K3's
#: blocks own 64 keys and walk q tiles of 64, K4's own 128 queries and
#: walk key tiles of 64): K1's edge S causal or not, both head dims, GQA
#: ratios in turn, the lse cotangent at D = 64; windows around a tile;
#: n_rep 1, 4 and 8 with and without the lse cotangent.  Where each query
#: sees one key (S = 1, window 1) dS cancels to rounding noise, so those
#: cases carry the lse cotangent.
K3K4_EDGE_CASES = tuple(
    (2, *K1_GQA[i % len(K1_GQA)], s, d, causal, 0, d == 64 or s == 1)
    for i, s in enumerate(K1_EDGE_S) for d in (64, 128)
    for causal in (True, False)) + tuple(
    (2, 8, 2, s, d, True, w, w == 1) for w in (1, 127, 128, 129, 256)
    for s in (129, 1000, 2048) for d in (64, 128)) + tuple(
    (2, 8, hkv, 1000, 128, True, 0, g_lse) for hkv in (8, 2, 1)
    for g_lse in (False, True))


def phase_k3k4(torch, flush):
    from tpushare_torch import profile_k1
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.utils.cuda_timing import event_ms

    cases = []
    args, main = _bwd_case(torch, attn, 1, 32, 8, 2048, 128, True, 0, False,
                           SEED + 10)
    for case in ((1, 32, 8, 2048, 128, True, 0, True),    # lse cotangent
                 (1, 32, 8, 1000, 128, True, 0, False),   # ragged tail
                 (1, 32, 8, 1000, 128, True, 256, False),  # + window
                 (2, 8, 8, 512, 64, False, 0, False)):    # D = 64
        cases.append(_bwd_case(torch, attn, *case, SEED + 11)[1])
    edge_err = 0.0
    for i, case in enumerate(K3K4_EDGE_CASES):
        c = _bwd_case(torch, attn, *case, SEED + 200 + i)[1]
        edge_err = max(edge_err, *c["rel_err"].values())
    main["plain_ms"] = event_ms(lambda: attn._flash_bwd_plain(*args),
                               3, flush)
    del args
    torch.cuda.empty_cache()
    # by the profiler: K3, K4, the port's whole backward and SDPA's
    # backward (the library yardstick, its dO * O preprocess included),
    # at the training shape and at S = 8192 (no plain version there)
    for s, key in ((2048, "main"), (8192, "long")):
        res = profile_k1.profile_bwd_shape(s, 20, flush, seed=SEED + 12)
        if key == "main":
            main.update({k: v for k, v in res.items()
                         if k not in ("B", "H", "Hkv", "S", "D", "causal")})
            main.update({"dkv_ms": res["dkv_event_ms"],
                         "dq_ms": res["dq_event_ms"],
                         "library_ms": res["library_event_ms"],
                         "library_kernel": res["library_kernels"]})
        else:
            main["long"] = res
        torch.cuda.empty_cache()
    return {"main": main, "cases": cases,
            "edge_cases": len(K3K4_EDGE_CASES),
            "edge_max_rel_err": edge_err}


#: the sp_attention phase: Llama-3-8B's attention (B = 1, 32 q heads over
#: 8 kv heads, D = 128, bf16) at S = 8192 over 4 sp shards of the one card
#: (``make_mesh({"sp": 4}, devices=["cuda:0"] * 4)``); the model at full
#: width and depth on one 8192-token prompt; the gradient check at 2 of its
#: layers and S = 4096
SP_SHARDS = 4
SP_SEQ = 8192
SP_GRAD_SEQ = 4096
SP_GRAD_LAYERS = 2
#: profiled calls a timing
SP_ITERS = 10
#: the sp_attention phase's substrings of K1's, K3's and K4's kernel names
SP_KERNEL_NAMES = {"k1": "flash_fwd_kernel", "k3": "dkv_kernel",
                   "k4": "dq_kernel"}


def sp_launches(n: int) -> dict:
    """K1 launches of one attention call over n sp shards, and K3's and
    K4's each in its backward: the plain causal ring skips the masked
    blocks (n(n+1)/2), the zigzag ring computes three half-blocks a shard
    at t = 0 and two a step after (n(2n+1)), a non-causal ring every block
    (n^2), Ulysses one whole-sequence call a shard (n)."""
    return {"plain": n * (n + 1) // 2, "zigzag": n * (2 * n + 1),
            "noncausal": n * n, "ulysses": n}


@contextlib.contextmanager
def _k134_counted(tally: list):
    """Zero K1's, K3's and K4's launch counters, run the block, and leave
    what it launched in the yielded [k1, k3, k4], added to ``tally``."""
    from tpushare_torch.ops import attention as attn

    fns = (attn.flash_attention_lse, attn.flash_bwd_dkv, attn.flash_bwd_dq)
    for fn in fns:
        fn.launches = 0
    got = [0, 0, 0]
    yield got
    for i, fn in enumerate(fns):
        got[i] = fn.launches
        tally[i] += fn.launches


def _sp_families(kernels: dict) -> dict:
    """Device ms a call of K1, K3, K4 and of everything, from
    ``device_kernel_ms``' {name: (ms, launches)}."""
    out = {fam: sum(ms for name, (ms, _) in kernels.items() if sub in name)
           for fam, sub in SP_KERNEL_NAMES.items()}
    out["all"] = sum(ms for ms, _ in kernels.values())
    return out


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _sp_attention_alone(torch, mesh, tally, flush) -> dict:
    """The four schedules on random bf16 q, k, v at Llama-3-8B's
    attention shape: outputs against K1 over the whole sequence, dq, dk,
    dv of one random cotangent against the whole sequence's K1 + K3 + K4,
    K1, K3, K4 launches a call; then device times by the profiler: each
    shard's K1 under plain and zigzag, each schedule's forward and
    backward, the whole sequence's, and the bounds."""
    import functools

    from tpushare_torch import profile_k1
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel import ring, ulysses
    from tpushare_torch.utils.cuda_timing import bound_ms, device_kernel_ms

    b, h, hkv, s, d, n = 1, 32, 8, SP_SEQ, 128, SP_SHARDS
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    mk = (lambda *shape: torch.randn(*shape, generator=g, device="cuda",
                                     dtype=torch.bfloat16))
    q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
        mk(b, h, s, d)
    rep = h // hkv
    expand = functools.partial(attn.expand_kv, n_rep=rep)
    calls = {
        "plain": lambda q, k, v: ring.ring_attention(q, k, v, mesh),
        "zigzag": lambda q, k, v: ring.ring_attention(
            q, k, v, mesh, schedule="zigzag"),
        "noncausal": lambda q, k, v: ring.ring_attention(
            q, k, v, mesh, causal=False),
        # the model hook's contract: K/V expanded to q's heads
        "ulysses": lambda q, k, v: ulysses.ulysses_attention(
            q, expand(k), expand(v), mesh),
    }
    want_n = sp_launches(n)

    def leaves():
        return [x.detach().clone().requires_grad_() for x in (q, k, v)]

    whole = {}
    for causal in (True, False):
        lv = leaves()
        out = attn.flash_attention(*lv, causal=causal)
        whole[causal] = (out.detach(), torch.autograd.grad(out, lv, do))
    res = {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d, "sp": n}
    for name, fn in calls.items():
        causal = name != "noncausal"
        lv = leaves()
        with _k134_counted(tally) as fwd_n:
            out = fn(*lv)
            torch.cuda.synchronize()
        with _k134_counted(tally) as bwd_n:
            grads = torch.autograd.grad(out, lv, do)
            torch.cuda.synchronize()
        w_out, w_grads = whole[causal]
        check(torch.isfinite(out.float()).all().item()
              and out.shape == q.shape, f"sp {name}: output not finite")
        err = (out.float() - w_out.float()).abs().max().item()
        rel = {x: _rel_err(gr, wg) for x, gr, wg in
               zip(("dq", "dk", "dv"), grads, w_grads)}
        check(err <= OUT_TOL, f"sp {name}: output {err} from K1 over the "
                              f"whole sequence, past {OUT_TOL}")
        check(max(rel.values()) <= BWD_TOL,
              f"sp {name}: gradients {rel} from the whole sequence's "
              f"K1 + K3 + K4, past {BWD_TOL}")
        check(fwd_n == [want_n[name], 0, 0] and bwd_n == [0, want_n[name],
                                                           want_n[name]],
              f"sp {name}: K1/K3/K4 {fwd_n} forward, {bwd_n} backward, not "
              f"{want_n[name]}")
        res[name] = {"causal": causal, "max_abs_err": err,
                     "grad_rel_err": rel,
                     "launches": {"flash_fwd": fwd_n[0],
                                  "flash_bwd_dkv": bwd_n[1],
                                  "flash_bwd_dq": bwd_n[2]}}
    del whole, out, grads

    # device times by the profiler
    t = {"shard_k1_ms": {}, "forward": {}, "backward": {}}
    with torch.no_grad():
        for sched in ("plain", "zigzag"):
            qs, blocks, body, devs, _ = ring.ring_shards(
                q, k, v, mesh, schedule=sched)
            t["shard_k1_ms"][sched] = [
                _sp_families(device_kernel_ms(
                    functools.partial(
                        lambda me: body(qs[me], ring._arrival(blocks, me,
                                                              devs), me),
                        me), SP_ITERS, flush))["k1"]
                for me in range(n)]
        for name, fn in calls.items():
            t["forward"][name] = _sp_families(device_kernel_ms(
                functools.partial(fn, q, k, v), SP_ITERS, flush))
        for causal in (True, False):
            key = "whole" if causal else "whole_noncausal"
            t["forward"][key] = _sp_families(device_kernel_ms(
                functools.partial(attn.flash_attention, q, k, v,
                                  causal=causal), SP_ITERS, flush))
    backward = dict(calls, whole=functools.partial(attn.flash_attention))
    for name, fn in backward.items():
        lv = leaves()
        out = fn(*lv)
        t["backward"][name] = _sp_families(device_kernel_ms(
            lambda: torch.autograd.grad(out, lv, do, retain_graph=True),
            SP_ITERS, flush))
        del out, lv
    flops, nbytes, fwd_bound, fwd_by = profile_k1.flash_cost(b, h, hkv, s,
                                                             d, True)
    nc = profile_k1.flash_cost(b, h, hkv, s, d, False)
    bc = profile_k1.bwd_cost(b, h, hkv, s, d)
    bwd_bound, bwd_by = bound_ms(bc["dkv_flops"] + bc["dq_flops"],
                                 bc["dkv_bytes"] + bc["dq_bytes"])
    t["bound_ms"] = {"forward_causal": fwd_bound, "forward_by": fwd_by,
                     "forward_noncausal": nc[2], "backward_causal":
                     bwd_bound, "backward_by": bwd_by,
                     "backward_k3": bc["dkv_bound_ms"],
                     "backward_k4": bc["dq_bound_ms"]}
    shard = t["shard_k1_ms"]
    t["plain_slowest_over_fastest"] = max(shard["plain"]) / min(
        shard["plain"])
    t["zigzag_slowest_over_plain_slowest"] = max(shard["zigzag"]) / max(
        shard["plain"])
    res["times"] = t
    return res


def _sp_model(torch, params, cfg, mesh, tally) -> dict:
    """``forward(attention_fn=)`` with each hook at full width and depth on
    one SP_SEQ-token prompt: K1 a layer as ``sp_launches`` says, the
    logits at every position against ``forward`` without a hook within
    max(LOGIT_TOL, 1.25x that forward's distance from itself on the
    reference attention)."""
    import functools

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel import ring, ulysses

    hooks = {
        "plain": functools.partial(ring.ring_attention, mesh=mesh),
        "zigzag": functools.partial(ring.ring_attention, mesh=mesh,
                                    schedule="zigzag"),
        "ulysses": functools.partial(ulysses.ulysses_attention, mesh=mesh)}
    tokens = torch.as_tensor(np.random.default_rng(SEED + 31).integers(
        0, cfg.vocab, (1, SP_SEQ)), device="cuda")
    res = {"S": SP_SEQ, "layers": cfg.n_layers}
    with torch.inference_mode():
        want = transformer.forward(params, tokens, cfg)
        use_flash = attn.use_flash
        attn.use_flash = lambda q, k: False
        try:
            gap = (transformer.forward(params, tokens, cfg)
                   - want).abs().max().item()
        finally:
            attn.use_flash = use_flash
        torch.cuda.empty_cache()
        limit = max(LOGIT_TOL, 1.25 * gap)
        res.update({"k1_vs_reference_max_abs_err": gap, "limit": limit})
        for name, hook in hooks.items():
            t0 = time.perf_counter()
            with _k134_counted(tally) as got:
                out = transformer.forward(params, tokens, cfg,
                                          attention_fn=hook)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = (out - want).abs().max().item()
            check(_all_finite(torch, out) and err <= limit,
                  f"sp model {name}: logits {err} from the forward without "
                  f"a hook, past {limit}")
            per_layer = sp_launches(SP_SHARDS)[name]
            check(got == [per_layer * cfg.n_layers, 0, 0],
                  f"sp model {name}: K1/K3/K4 {got}, not "
                  f"{per_layer} a layer")
            res[name] = {"max_abs_err": err, "k1_launches": got[0],
                         "wall_s": wall}
            del out
    return res


def _sp_grads(torch, cfg, mesh, tally) -> dict:
    """The loss of ``tests/test_longcontext_training.py`` and every leaf's
    gradient at SP_GRAD_LAYERS layers of ``cfg``'s widths and SP_GRAD_SEQ
    tokens, with the plain ring hook against without it: the loss within
    LSE_TOL relative, each leaf's gradient within BWD_TOL of its largest
    magnitude; K1, K3, K4 each sp_launches' plain count a layer.  Beside
    them, for scale, the hookless model's loss and gradients against its
    own on the reference attention."""
    import dataclasses
    import functools

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel import ring

    c2 = dataclasses.replace(cfg, n_layers=SP_GRAD_LAYERS)
    params = transformer.init_params(c2, seed=SEED, device="cuda")
    names, leaves = [], []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                names.append(prefix + key)
                leaves.append(val.requires_grad_(True))

    walk(params, "")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 32).integers(
        0, cfg.vocab, (1, SP_GRAD_SEQ + 1)), device="cuda")

    def loss_and_grads(hook):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = transformer.forward(params, inputs, c2, attention_fn=hook)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
        del logits, logp
        return loss.detach(), torch.autograd.grad(loss, leaves)

    want_loss, want = loss_and_grads(None)
    # the bf16 noise of these gradients: the hookless model's own, with
    # its attention through the reference instead of K1 + K3 + K4
    use_flash = attn.use_flash
    attn.use_flash = lambda q, k: False
    try:
        ref_loss, ref = loss_and_grads(None)
    finally:
        attn.use_flash = use_flash
    noise = max(_rel_err(r, w) for r, w in zip(ref, want))
    del ref
    with _k134_counted(tally) as got:
        loss, grads = loss_and_grads(functools.partial(ring.ring_attention,
                                                       mesh=mesh))
        torch.cuda.synchronize()
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    rel = {name: _rel_err(gr, wg)
           for name, gr, wg in zip(names, grads, want)}
    n = sp_launches(SP_SHARDS)["plain"] * SP_GRAD_LAYERS
    check(np.isfinite(loss.item()) and loss_err <= LSE_TOL,
          f"sp grads: loss {loss.item()} against {want_loss.item()}")
    check(all(_all_finite(torch, gr) for gr in grads)
          and max(rel.values()) <= BWD_TOL,
          f"sp grads: relative errors {rel} past {BWD_TOL}")
    check(got == [n, n, n], f"sp grads: K1/K3/K4 {got}, not {n} each")
    worst = max(rel, key=rel.get)
    return {"S": SP_GRAD_SEQ, "layers": SP_GRAD_LAYERS,
            "loss": loss.item(), "loss_without_hook": want_loss.item(),
            "loss_rel_err": loss_err, "grad_rel_err": rel,
            "worst_leaf": worst, "max_grad_rel_err": rel[worst],
            "k1_vs_reference_loss_rel_err": abs(
                ref_loss.item() - want_loss.item()) / abs(want_loss.item()),
            "k1_vs_reference_max_grad_rel_err": noise,
            "launches": {"flash_fwd": got[0], "flash_bwd_dkv": got[1],
                         "flash_bwd_dq": got[2]}}


def phase_sp_attention(torch, card: str, flush):
    """Sequence-parallel long-context attention on 4 sp shards of the one
    card: the ring (plain, zigzag, non-causal) and Ulysses alone at
    Llama-3-8B's attention shape and S = 8192, forward and backward
    against the whole sequence's K1 + K3 + K4, with their launch counts
    and device times; Llama-3-8B at full width and depth through
    ``forward(attention_fn=)`` with each hook on one 8192-token prompt;
    loss and gradients through the ring hook at 2 layers and S = 4096.
    ``launches`` is K1's, K3's and K4's over these driven runs (the
    whole-sequence comparisons left out)."""
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.serving.llm import build_model

    t0 = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    mesh = make_mesh({"sp": SP_SHARDS}, devices=["cuda:0"] * SP_SHARDS)
    tally = [0, 0, 0]
    res = {"card": card, "sp": SP_SHARDS,
           "devices": [str(d) for d in mesh.devices],
           "expected_launches_a_call": sp_launches(SP_SHARDS)}
    res["attention"] = _sp_attention_alone(torch, mesh, tally, flush)
    mark("attention")
    torch.cuda.empty_cache()
    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    res["model"] = _sp_model(torch, params, cfg, mesh, tally)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mark("model")
    res["grads"] = _sp_grads(torch, cfg, mesh, tally)
    mark("grads")
    res["launches"] = {"flash_fwd": tally[0], "flash_bwd_dkv": tally[1],
                       "flash_bwd_dq": tally[2]}
    res["part_s"] = parts
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _post(port, path, body, timeout=900):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def _check_llama3_8b(cfg) -> None:
    check(cfg.d_model == 4096 and cfg.n_layers == 32 and cfg.vocab == 128256
          and cfg.n_kv_heads == 8 and cfg.d_ff == 14336,
          "llama3-8b config is not full width and depth")


def _load_prompts(cfg):
    """The serving load's seeded prompts (256/512/1000/2000 tokens) and
    its 2048-token ``/score`` row."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (256, 512, 1000, 2000)]
    return prompts, rng.integers(0, cfg.vocab, 2048).tolist()


def _drive_server(port: int, cfg, max_new: int = 32) -> dict:
    """The serving load of the server, dense, grant and moe phases,
    through HTTP: four concurrent ``/generate`` (prompts of
    256/512/1000/2000 tokens, ``max_new`` new each, the last sampled),
    then one 2048-token ``/score``.  The kernels' launch counters are
    zeroed just before and read just after; every response is checked
    for form."""
    import math

    from tpushare_torch.serving.llm import kernel_launches

    prompts, score_row = _load_prompts(cfg)
    lens = [len(p) for p in prompts]
    reqs = [{"tokens": [p], "max_new_tokens": max_new} for p in prompts]
    reqs[3].update({"temperature": 0.8, "top_k": 50, "seed": 7})

    _zero_launch_counts()
    results = [None] * len(reqs)

    def send(i):
        try:
            results[i] = _post(port, "/generate", reqs[i])
        except Exception as e:      # reported below
            results[i] = (None, repr(e))

    t1 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    gen_wall = time.perf_counter() - t1
    t2 = time.perf_counter()
    s_code, s_body = _post(port, "/score", {"tokens": [score_row]})
    score_s = time.perf_counter() - t2
    launches = kernel_launches()
    h_code, h_body = _get(port, "/healthz")
    _, stats = _get(port, "/stats")
    stats = json.loads(stats)

    received = 0
    for i, (code, body) in enumerate(results):
        check(code == 200, f"/generate {i} failed: {body}")
        row = body["tokens"][0]
        received += len(row) - lens[i]
        check(row[:lens[i]] == prompts[i]
              and len(row) == lens[i] + max_new,
              f"/generate {i}: malformed tokens (len {len(row)})")
        check(all(0 <= t < cfg.vocab for t in row), "token out of vocab")
    check(s_code == 200, f"/score failed: {s_body}")
    lp = s_body["scores"][0]["logprobs"]
    check(len(lp) == 2047 and all(math.isfinite(x) and x <= 0 for x in lp),
          "/score logprobs malformed or not finite")
    check(h_code == 200, f"/healthz {h_code}: {h_body}")
    b = stats["batcher"]
    check(launches["flash_fwd"] >= cfg.n_layers,
          f"K1 launched {launches['flash_fwd']} times on the main path")
    return {"generate_wall_s": gen_wall,
            "tokens_per_s": max_new * len(reqs) / gen_wall,
            "ttft_s": stats["ttft_s"], "score_s": score_s,
            "rounds": b["rounds"], "prefill_tokens": b["prefill_tokens"],
            "admitted_whole": b["admitted_whole"],
            "admitted_chunked": b["admitted_chunked"],
            "prefills": b["prefills"], "decode_steps": b["decode_steps"],
            "forwards": b["prefills"] + b["decode_steps"],
            "launches": launches, "kv_storage": stats["kv_storage"],
            "tokens_received": received,
            "sampled_tokens": results[3][1]["tokens"][0][lens[3]:]}


def _check_k2_arms(res, kind: str, n_layers: int) -> None:
    """K2 of the pool's kind (``""`` or ``"_int8"``) in every layer of
    every paged forward: the S > 1 arm (``paged_attn``) in every prefill,
    the decode arm (``paged_decode``) in every decode step; no other K2
    entry point."""
    got = res["launches"]
    pre, dec = got[f"paged_attn{kind}"], got[f"paged_decode{kind}"]
    check(pre + dec >= n_layers * res["forwards"] and pre > 0 and dec > 0,
          f"K2{kind} launched {pre} (S > 1) + {dec} (decode) times for "
          f"{res['forwards']} forwards")
    check(dec >= n_layers * res["decode_steps"],
          f"K2{kind}'s decode arm launched {dec} times for "
          f"{res['decode_steps']} decode steps")
    others = {k: n for k, n in got.items() if k.startswith("paged_")
              and k not in (f"paged_attn{kind}", f"paged_decode{kind}")}
    check(not any(others.values()), f"another K2 entry point ran: {others}")


#: the cost card's GEMM FLOPs of an 8-row decode step against the
#: profiler's count of the step's mm / bmm / addmm (relative)
CARD_FLOPS_RTOL = 0.02
#: the analytical work phases the server phase's load runs: whole
#: admissions, fused decode rounds, the arrival's mixed rounds
COST_PHASES = ("prefill", "decode", "mixed")


def _cost_plane(port) -> dict:
    """The cost plane after a server's load, from its ``/metrics`` (which
    re-derives the roofline gauges): ``tpushare_program_flops_total`` > 0
    in every phase the load ran, ``tpushare_model_flops_utilization`` in
    (0, 1], ``tpushare_roofline_bound_info`` one-hot.  The service
    flushes its counts when it goes idle, so the read waits (10 s at
    most) for that flush."""
    deadline = time.perf_counter() + 10
    while True:
        parsed = _metrics(port)
        flops = {p: _count_metric(parsed, "tpushare_program_flops_total",
                                  phase=p) for p in COST_PHASES}
        if all(flops.values()) or time.perf_counter() > deadline:
            break
        time.sleep(0.25)
    check(all(v > 0 for v in flops.values()),
          f"cost plane: program FLOPs by phase {flops}")
    hbm = {p: _count_metric(parsed, "tpushare_program_hbm_bytes_total",
                            phase=p) for p in COST_PHASES}
    samples = parsed["samples"]
    check(samples.get("tpushare_model_flops_utilization"),
          "cost plane: no tpushare_model_flops_utilization on the card")
    mfu = _count_metric(parsed, "tpushare_model_flops_utilization")
    bw = _count_metric(parsed, "tpushare_hbm_bandwidth_utilization")
    check(0.0 < mfu <= 1.0, f"cost plane: MFU {mfu} outside (0, 1]")
    bounds = {lab["bound"]: v for lab, v in
              samples.get("tpushare_roofline_bound_info", ())}
    check(sorted(bounds.values()) == [0.0, 0.0, 1.0],
          f"cost plane: tpushare_roofline_bound_info {bounds}")
    return {"program_flops": flops, "program_hbm_bytes": hbm,
            "ici_bytes": _count_metric(parsed, "tpushare_ici_bytes_total"),
            "mfu": mfu, "hbm_bandwidth_utilization": bw,
            "bound": next(b for b, v in bounds.items() if v == 1.0)}


def _card_flops_check(torch, params, cfg) -> dict:
    """One 8-row decode step of a paged batcher on these weights (contexts
    256-2000): its cost card's per-token FLOPs times the rows, without
    the ``ctx`` term (K2, which the profiler counts no FLOPs of), against
    ``torch.profiler``'s ``with_flops`` count of the step's mm, bmm and
    addmm, within CARD_FLOPS_RTOL."""
    from torch.profiler import ProfilerActivity, profile

    from tpushare_torch.serving.paged import PagedContinuousBatcher

    prompts = _adapter_prompts(cfg)
    b = PagedContinuousBatcher(params, cfg, n_slots=len(prompts),
                               page_size=16, n_pages=ADAPTER_PAGES,
                               device="cuda")
    for p in prompts:
        check(b.admit(p, 4) is not None, "card flops: admission refused")
    b.tick()                                     # warm
    torch.cuda.synchronize()
    rows = len(b.slots)
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        b.tick()
        torch.cuda.synchronize()
    gemm = {e.key: e.flops for e in prof.key_averages()
            if e.key in ("aten::mm", "aten::bmm", "aten::addmm")}
    b.run_until_drained()
    measured = float(sum(gemm.values()))
    card = b._cost_card.flops_per_token * rows
    rel = abs(card - measured) / measured if measured else float("inf")
    check(rel <= CARD_FLOPS_RTOL,
          f"cost card: {card} GEMM FLOPs a {rows}-row step, the profiler "
          f"counted {measured} ({gemm})")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "card_flops": card, "profiler_flops": measured,
            "profiler_ops": gemm, "rel_err": rel,
            "flops_per_token": card / rows, "limit": CARD_FLOPS_RTOL}


def _trace_seq(port) -> int:
    """The newest span's seq in the server's trace ring (0: empty)."""
    events = json.loads(_get(port, "/debug/trace")[1])["traceEvents"]
    return max((e.get("seq", 0) for e in events), default=0)


def _batcher_spans(port, since: int) -> list:
    """The batcher's round spans after ``since`` in ``/debug/trace``."""
    events = json.loads(_get(port, f"/debug/trace?since={since}")[1])
    return [e for e in events["traceEvents"]
            if e.get("name", "").startswith("batcher.")]


def _stream_post(port, body) -> list:
    """``/generate_stream``'s NDJSON lines, read to the end."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate_stream",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=900) as r:
        check(r.status == 200, f"/generate_stream {r.status}")
        return [json.loads(line) for line in r.read().decode().splitlines()
                if line.strip()]


#: the traced requests' prompt length and new tokens (the server phase)
TRACE_PROMPT, TRACE_NEW = 300, 12


def _trace_plane(torch, port, cfg) -> dict:
    """Fleet trace propagation through the server, one request at a time:
    a ``/generate`` and a ``/generate_stream`` carrying a ``traceparent``
    body field (``telemetry.propagation``): every round span of their
    window in ``/debug/trace?since=`` carries the id in ``traces``, K2
    launched in those rounds (both arms), and each one's ``admit`` event
    in ``/debug/events`` carries ``trace``; then a malformed
    ``traceparent`` answered 200 whose rounds carry no trace."""
    import numpy as np

    from tpushare_torch.serving.llm import kernel_launches
    from tpushare_torch.telemetry import propagation

    prompt = np.random.default_rng(SEED + 71).integers(
        0, cfg.vocab, TRACE_PROMPT).tolist()
    body = {"tokens": [prompt], "max_new_tokens": TRACE_NEW}
    out = {}
    for route in ("/generate", "/generate_stream"):
        ctx = propagation.new_context()
        seq = _trace_seq(port)
        _zero_launch_counts()
        traced = propagation.inject(body, ctx)
        if route == "/generate":
            code, res = _post(port, route, traced)
            check(code == 200 and len(res["tokens"][0])
                  == TRACE_PROMPT + TRACE_NEW, f"traced {route}: {code}")
        else:
            lines = _stream_post(port, traced)
            check(len(lines[-1]["done"]) == TRACE_PROMPT + TRACE_NEW,
                  f"traced {route}: {lines[-1]}")
        launches = kernel_launches()
        spans = _batcher_spans(port, seq)
        check(spans and all(e["args"].get("traces") == [ctx.trace_id]
                            for e in spans),
              f"traced {route}: spans {[e['args'] for e in spans][:4]}")
        check(launches["paged_attn"] > 0 and launches["paged_decode"]
              >= cfg.n_layers, f"traced {route}: K2 {launches}")
        events = [json.loads(line) for line in
                  _get(port, "/debug/events")[1].splitlines()
                  if line.strip()]
        admits = [e for e in events if e["kind"] == "admit"]
        check(admits and admits[-1].get("trace") == ctx.trace_id,
              f"traced {route}: admit event {admits[-1:]}")
        out[route] = {"spans": len(spans),
                      "span_names": sorted({e["name"] for e in spans}),
                      "paged_attn": launches["paged_attn"],
                      "paged_decode": launches["paged_decode"]}
    seq = _trace_seq(port)
    code, res = _post(port, "/generate",
                      {**body, propagation.TRACEPARENT_FIELD: "garbage"})
    spans = _batcher_spans(port, seq)
    check(code == 200 and spans and all(e["args"].get("traces") == []
                                        for e in spans),
          f"malformed traceparent: {code}, spans {len(spans)}")
    out["malformed"] = {"code": code, "spans": len(spans)}
    return out


def _catalog_check(port) -> dict:
    """Every family on the server's ``/metrics`` is a row of
    ``docs/METRICS_TORCH.md`` (``telemetry/catalog.py``'s render)."""
    families = sorted({line.split()[2] for line in
                       _get(port, "/metrics")[1].splitlines()
                       if line.startswith("# TYPE ")})
    with open(os.path.join(HERE, "docs", "METRICS_TORCH.md")) as f:
        catalog = f.read()
    missing = [n for n in families if f"| `{n}` |" not in catalog]
    check(families and not missing,
          f"/metrics families missing from docs/METRICS_TORCH.md: {missing}")
    return {"families": len(families)}


#: the rows of the profiler plane's decode step, and its timed steps
PROFILER_ROWS, PROFILER_ITERS = 8, 10


def _profiler_plane(torch, params, cfg) -> dict:
    """``utils.profiler`` on the card: ``device_trace`` around one decode
    step of an 8-row paged batcher writes a Chrome trace naming K2's
    decode kernel once a layer; ``time_fn`` on that step (its first call
    apart), printed on a line of its own."""
    import numpy as np

    from tpushare_torch.serving.paged import PagedContinuousBatcher
    from tpushare_torch.utils.profiler import device_trace, time_fn

    rng = np.random.default_rng(SEED + 73)
    b = PagedContinuousBatcher(params, cfg, n_slots=PROFILER_ROWS,
                               page_size=16, n_pages=ADAPTER_PAGES,
                               device="cuda")
    for n in np.linspace(256, 2000, PROFILER_ROWS).astype(int):
        check(b.admit(rng.integers(0, cfg.vocab, int(n)).tolist(),
                      PROFILER_ITERS + 8) is not None,
              "profiler plane: admission refused")
    logdir = os.path.join(HERE, "build", "chip_smoke_traces")
    with device_trace(logdir) as d:
        b.tick()
    paths = sorted((os.path.join(d, f) for f in os.listdir(d)
                    if f.startswith("trace_")), key=os.path.getmtime)
    with open(paths[-1]) as f:
        events = json.load(f)["traceEvents"]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "paged_decode_kernel" in e.get("name", "")]
    check(len(k2) == cfg.n_layers,
          f"device_trace: K2's decode kernel {len(k2)} times in one step "
          f"of {cfg.n_layers} layers")
    times = time_fn(b.tick, iters=PROFILER_ITERS, warmup=1)
    emit({"phase": "server.time_fn", "rows": PROFILER_ROWS,
          "compile_s": times["compile_s"], "p50_s": times["p50_s"]})
    b.run_until_drained()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return {"trace_file": os.path.basename(paths[-1]),
            "trace_events": len(events), "k2_decode_kernels": len(k2),
            "time_fn": times}


def _distributed_plane(torch) -> dict:
    """``runtime.distributed`` on one host: ``init_distributed({})`` is a
    no-op and ``global_mesh({"dp": -1}, env={})`` is one shard on
    ``cuda:0``."""
    import torch.distributed as dist

    from tpushare_torch.runtime import distributed

    topo = distributed.init_distributed({})
    check(not topo.is_multihost and not dist.is_initialized(),
          "init_distributed({}) made a process group")
    mesh = distributed.global_mesh({"dp": -1}, env={})
    check(mesh.shape == {"dp": 1}
          and mesh.devices == (torch.device("cuda", 0),),
          f"global_mesh on one card: {mesh}")
    return {"hosts": topo.n_hosts, "mesh": mesh.shape,
            "devices": [str(d) for d in mesh.devices]}


def phase_server(torch, card: str):
    """The serving load on an ``LLMServer`` over the paged pool (its
    service loop on mixed rounds) and the cost plane it leaves, then the
    cost card against the profiler's FLOPs (:func:`_card_flops_check`)
    and the ``mixed`` check (:func:`_mixed_check`) on the same
    weights."""
    from tpushare_torch.models.transformer import param_count
    from tpushare_torch.serving.llm import LLMServer, build_model

    t0 = time.perf_counter()
    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _check_llama3_8b(cfg)
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    device="cuda").start()
    try:
        res = _drive_server(srv.port, cfg)
        arrivals = _drive_arrivals(srv, cfg)
        cost = _cost_plane(srv.port)
        res["trace"] = _trace_plane(torch, srv.port, cfg)
        res["catalog"] = _catalog_check(srv.port)
    finally:
        srv.stop()
    del srv
    _check_k2_arms(res, "", cfg.n_layers)
    _check_k2_arms(arrivals, "", cfg.n_layers)
    res.update({"model": "llama3-8b", "card": card,
                "params_b": param_count(params) / 1e9, "init_s": init_s,
                "kv_pool_bytes": res.pop("kv_storage")["pool_bytes"],
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    gc.collect()
    torch.cuda.empty_cache()
    cost["card_vs_profiler"] = _card_flops_check(torch, params, cfg)
    res["cost"] = cost
    res["mixed"] = _mixed_check(torch, params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    arrivals["batcher"] = _arrivals_check(torch, params, cfg)
    res["arrivals"] = arrivals
    res["profiler"] = _profiler_plane(torch, params, cfg)
    res["distributed"] = _distributed_plane(torch)
    return res


#: the mixed rounds the service runs by default: 64-token windows, a
#: prefill budget of two windows, 8 decode steps a round
MIXED_CHUNK = 64
MIXED_STEPS = 8


def _served_steps(b, prompts, max_new: int, chunk=None, tokens=None,
                  budget=None):
    """Greedy ``prompts`` through batcher ``b``: admitted together by
    ``admit`` and drained by ``tick`` (``chunk`` None), or by
    ``admit_chunked(chunk=)`` and drained by ``tick_mixed(8, chunk=,
    budget=)`` (default two windows).  Returns (the streams' new
    tokens, each prompt's first-step logits, taken where its slot
    activates, and its first decode step's logits, read from the
    sampler, as f32, the mixed rounds run, and the walls in seconds of
    their prefill blocks and of their decode steps, each
    synchronized).  ``tokens[i]``, where given,
    replaces prompt i's first token, so that every batcher compared
    decodes the same one."""
    import torch

    base = b._next_id
    firsts, steps, pending = {}, {}, {}
    activate = b._activate

    def capture(slot, rid, prompt, logits_v, *rest):
        firsts[rid] = logits_v.float().clone()
        activate(slot, rid, prompt, logits_v, *rest)
        if slot in b.slots:
            if tokens is not None:
                s = b.slots[slot]
                s.last_token = s.output[-1] = int(tokens[rid - base])
            pending[slot] = rid

    def on_step(logits):
        for slot, rid in pending.items():
            steps[rid] = logits[slot].float().clone()
        pending.clear()

    walls = {"prefill_block": [], "decode_step": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            n = args[-1] if key == "decode_step" else 1
            walls[key] += [(time.perf_counter() - t0) / n] * n
            return out
        return run

    hooks = (b._prefill_block, b._step_n)
    b._activate = capture
    if chunk is not None:
        b._prefill_block = timed(hooks[0], "prefill_block")
        b._step_n = timed(hooks[1], "decode_step")
    rounds = 0
    try:
        with _sampler_logits(on_step):
            if chunk is None:
                rids = [b.admit(p, max_new) for p in prompts]
                check(None not in rids, "admission refused")
                b.run_until_drained()
            else:
                rids = [b.admit_chunked(p, max_new, chunk=chunk)
                        for p in prompts]
                check(None not in rids, "chunked admission refused")
                while b.prefilling or b.slots:
                    b.tick_mixed(MIXED_STEPS, chunk=chunk,
                                 budget=budget or 2 * chunk)
                    rounds += 1
                    check(rounds < 1000, "the mixed rounds did not drain")
    finally:
        b._activate = activate
        b._prefill_block, b._step_n = hooks
    news = [b.completed[r][len(p):] for r, p in zip(rids, prompts)]
    return (news, [firsts[r] for r in rids],
            [steps.get(r) for r in rids], rounds, walls)


def _mixed_check(torch, params, cfg):
    """The server load's four prompts (256/512/1000/2000 tokens, greedy)
    on a paged pool of 8 slots through ``admit_chunked(chunk=64)`` and
    ``tick_mixed(8, chunk=64, budget=128)`` against the same prompts
    through ``admit`` and ``tick``.  On the K2 route (bf16): first-step
    logits, and the first decode step's from the same first token,
    within LOGIT_TOL or 1.25x the pool's own K2-against-gather distance
    at those steps; 32 greedy tokens each, the first equal wherever the
    reference's top two logits lie more than twice that apart (closer,
    bf16 noise may swap them).  On the weights widened to f32 through the
    gather read, 2 tokens each: both steps within F32_LOGIT_TOL and the
    first tokens equal (a block row that reads a wrong page, or a frozen
    row that wanders, fails there)."""
    import dataclasses

    import numpy as np

    from tpushare_torch.serving.paged import PagedContinuousBatcher

    prompts, _ = _load_prompts(cfg)

    def pool(p, c):
        return PagedContinuousBatcher(p, c, n_slots=8, page_size=16,
                                      n_pages=300, device="cuda")

    t0 = time.perf_counter()
    ref = _served_steps(pool(params, cfg), prompts, 32)
    tick_s = time.perf_counter() - t0
    first_tokens = [int(x.argmax()) for x in ref[1]]
    t0 = time.perf_counter()
    mix = _served_steps(pool(params, cfg), prompts, 32, chunk=MIXED_CHUNK,
                        tokens=first_tokens)
    mixed_s = time.perf_counter() - t0
    gather = _served_steps(
        pool(params, dataclasses.replace(cfg, attn_kernel="gather")),
        prompts, 2, tokens=first_tokens)
    noise = [(g - w).abs().max().item()
             for g, w in zip(gather[1] + gather[2], ref[1] + ref[2])]
    tol = max(LOGIT_TOL, 1.25 * max(noise))
    errs = [(m - w).abs().max().item()
            for m, w in zip(mix[1] + mix[2], ref[1] + ref[2])]
    check(all(torch.isfinite(x).all().item() for x in mix[1] + mix[2]),
          "mixed logits not finite")
    check(max(errs) <= tol,
          f"mixed first-step and decode-step logits {errs} from the ticked "
          f"ones, past LOGIT_TOL and 1.25x the K2-against-gather distance "
          f"{noise}")
    margins = [float(x.topk(2).values[0] - x.topk(2).values[1])
               for x in ref[1]]
    natural = [int(x.argmax()) for x in mix[1]]
    for i, (m, a, b) in enumerate(zip(margins, natural, first_tokens)):
        check(m <= 2 * tol or a == b,
              f"prompt {i}: mixed first token {a}, ticked {b}, their "
              f"margin {m} past twice the tolerance {tol}")
    agree = [sum(x == y for x, y in zip(a[1:], b[1:])) / (len(b) - 1)
             for a, b in zip(mix[0], ref[0])]

    gc.collect()
    torch.cuda.empty_cache()
    p32 = _widened(params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attn_kernel="gather")
    ref32 = _served_steps(pool(p32, c32), prompts, 2)
    tokens32 = [int(x.argmax()) for x in ref32[1]]
    mix32 = _served_steps(pool(p32, c32), prompts, 2, chunk=MIXED_CHUNK,
                          tokens=tokens32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    err32 = [(m - w).abs().max().item()
             for m, w in zip(mix32[1] + mix32[2], ref32[1] + ref32[2])]
    check([int(x.argmax()) for x in mix32[1]] == tokens32,
          "f32 mixed and ticked first tokens differ")
    check(max(err32) <= F32_LOGIT_TOL,
          f"f32 mixed first-step and decode-step logits {err32} from the "
          f"ticked ones, past {F32_LOGIT_TOL}")
    return {"chunk": MIXED_CHUNK, "budget": 2 * MIXED_CHUNK,
            "decode_steps_a_round": MIXED_STEPS, "rounds": mix[3],
            "ticked_wall_s": tick_s, "mixed_wall_s": mixed_s,
            # where the mixed rounds' wall goes (synchronized around each
            # prefill block and each round's decode steps)
            "prefill_blocks": len(mix[4]["prefill_block"]),
            "prefill_block_ms": 1e3 * float(np.mean(mix[4]["prefill_block"])),
            "decode_steps": len(mix[4]["decode_step"]),
            "decode_step_ms": 1e3 * float(np.mean(mix[4]["decode_step"])),
            "first_logit_max_abs_err": errs[:4],
            "step_logit_max_abs_err": errs[4:],
            "kernel_vs_gather_max_abs_err": noise, "logit_tol": tol,
            "first_token_margins": margins,
            "first_tokens_equal": [a == b for a, b in
                                   zip(natural, first_tokens)],
            "later_token_agreement": agree,
            "f32_first_logit_max_abs_err": err32[:4],
            "f32_step_logit_max_abs_err": err32[4:],
            "f32_rounds": mix32[3]}


#: the arrivals load: three greedy decoders (256-token prompts, 96 new
#: tokens each) are decoding when the serving load's 2000-token prompt
#: (32 new tokens) arrives
ARRIVAL_DECODERS = 3
ARRIVAL_NEW = 96


def _arrival_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    short = [rng.integers(0, cfg.vocab, 256).tolist()
             for _ in range(ARRIVAL_DECODERS)]
    return short, _load_prompts(cfg)[0][3]


def _drive_arrivals(srv, cfg) -> dict:
    """The arrivals load through the running server: the decoders posted
    together; once the service shows them all decoding, the long prompt,
    which the loop must then stream through mixed rounds.  The counters
    are zeroed just before and read just after."""
    from tpushare_torch.serving.llm import kernel_launches

    short, long_ = _arrival_prompts(cfg)
    svc = srv._service
    before = svc.snapshot()
    n_timed = len(svc.timings)
    outs = [None] * (len(short) + 1)

    def send(i, tokens, n):
        try:
            outs[i] = _post(srv.port, "/generate",
                            {"tokens": [tokens], "max_new_tokens": n})
        except Exception as e:      # reported below
            outs[i] = (None, repr(e))

    _zero_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i, p, ARRIVAL_NEW))
               for i, p in enumerate(short)]
    for t in threads:
        t.start()
    while True:      # every decoder activated, and a round has run
        now = svc.snapshot()
        if (now["active"] == len(short)
                and now["decode_steps"] > before["decode_steps"]):
            break
        check(time.perf_counter() - t0 < 120, "the decoders never decoded")
        time.sleep(0.005)
    t_long = time.perf_counter()
    threads.append(threading.Thread(target=send,
                                    args=(len(short), long_, 32)))
    threads[-1].start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    snap = svc.snapshot()
    timings = list(svc.timings)[n_timed:]
    for i, (code, body) in enumerate(outs):
        check(code == 200, f"arrivals request {i} failed: {body}")
        row = body["tokens"][0]
        want = short[i] if i < len(short) else long_
        n = ARRIVAL_NEW if i < len(short) else 32
        check(row[:len(want)] == want and len(row) == len(want) + n
              and all(0 <= t < cfg.vocab for t in row),
              f"arrivals request {i}: malformed tokens (len {len(row)})")
    delta = {k: snap[k] - before[k] for k in (
        "rounds", "admitted_whole", "admitted_chunked", "prefills",
        "decode_steps", "prefill_tokens")}
    check(delta["admitted_chunked"] >= 1,
          f"the long prompt was not streamed: {delta}")
    longs = [t for t in timings if t["new_tokens"] == 32]
    decs = [t for t in timings if t["new_tokens"] == ARRIVAL_NEW]
    check(len(longs) == 1 and len(decs) == len(short),
          f"arrivals timings {timings}")
    return {**delta, "forwards": delta["prefills"] + delta["decode_steps"],
            "launches": launches, "wall_s": wall,
            "long_sent_after_s": t_long - t0,
            "long_ttft_s": longs[0]["ttft_s"],
            "long_total_s": longs[0]["total_s"],
            "decoders_total_s": [t["total_s"] for t in decs]}


def _arrivals(torch, b, chunked: bool) -> dict:
    """The arrivals load on batcher ``b``, as the service's loop would run
    it under either choice: the decoders admitted whole and one round of
    8 fused steps, then the long prompt arrives, admitted whole
    (``admit``, then ``tick_fused`` rounds) or streamed
    (``admit_chunked(chunk=64)``, ``tick_mixed(8, chunk=64, budget=128)``
    rounds while it prefills).  Returns the long prompt's seconds from
    its arrival to its first token, the decoders' to their last, the
    longest wait between two rounds' ends while the decoders live (the
    longest they go without tokens), the rounds, and the tokens."""
    import numpy as np

    short, long_ = _arrival_prompts(b.cfg)
    rids = [b.admit(p, ARRIVAL_NEW) for p in short]
    check(None not in rids, "arrivals: decoder admission refused")
    b.tick_fused(MIXED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = (b.admit_chunked(long_, 32, chunk=MIXED_CHUNK) if chunked
           else b.admit(long_, 32))
    check(rid is not None, "arrivals: the long prompt was refused")
    ends, done, rounds = [t0], None, 0
    while b.slots or b.prefilling:
        if b.prefilling:
            b.tick_mixed(MIXED_STEPS, chunk=MIXED_CHUNK,
                         budget=2 * MIXED_CHUNK)
        else:
            b.tick_fused(MIXED_STEPS)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        rounds += 1
        check(rounds < 1000, "arrivals: the rounds did not drain")
        if done is None and all(r in b.completed for r in rids):
            done = len(ends) - 1
    gaps = np.diff(ends[:done + 1])
    return {"long_ttft_s": b.activated_at[rid] - t0,
            "decoders_s": ends[done] - t0,
            "longest_gap_ms": 1e3 * float(gaps.max()),
            "mean_gap_ms": 1e3 * float(gaps.mean()), "rounds": rounds,
            "tokens": [b.completed[r][len(p):]
                       for r, p in zip(rids + [rid], short + [long_])]}


def _arrivals_check(torch, params, cfg) -> dict:
    """The arrivals load on paged pools of 8 slots both ways (whole and
    streamed admission of the prompt that arrives while slots decode):
    the trade the service's loop makes when it streams."""
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    out = {}
    for name, chunked in (("whole", False), ("streamed", True)):
        b = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                   n_pages=300, device="cuda")
        out[name] = _arrivals(torch, b, chunked)
        del b
    toks = [out[k].pop("tokens") for k in ("whole", "streamed")]
    out["first_tokens_equal"] = [a[0] == c[0] for a, c in zip(*toks)]
    return out


#: the device plugin's allocation env for a 14 GiB pod on an 80 GiB card
GRANT_ENV = {"ALIYUN_COM_TPU_MEM_IDX": "0", "ALIYUN_COM_TPU_MEM_POD": "14",
             "ALIYUN_COM_TPU_MEM_DEV": "80",
             "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.175"}
#: the grant phase's int8 KV pool (992 pages of 16 tokens; the same bytes
#: buy 512 bf16 pages)
GRANT_POOL_BYTES = 1 << 30
#: the grant phase's usage-report cadence and paced window (seconds), and
#: the closed-loop clients of the paced load
REPORT_S = 1.0
PACED_WINDOW_S = 8.0
PACED_CLIENTS = 4


class _UsageSink:
    """A stdlib stand-in for the node daemon's ``/usage`` listener: keeps
    each report with its arrival time (``time.perf_counter``) and answers
    with the verdict it holds."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.reports = []
        self.verdict = {"mode": "enforce", "policy": "ok"}
        self._lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                with sink._lock:
                    sink.reports.append((time.perf_counter(), body))
                    data = json.dumps(sink.verdict).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._http = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True)
        self._thread.start()

    def answer(self, policy: str) -> None:
        with self._lock:
            self.verdict = {"mode": "enforce", "policy": policy}

    def next_after(self, t: float, timeout: float = 30.0):
        """The first report that arrived after ``t``: (arrival, body)."""
        t_end = time.perf_counter() + timeout
        while time.perf_counter() < t_end:
            with self._lock:
                late = [r for r in self.reports if r[0] > t]
            if late:
                return late[0]
            time.sleep(0.05)
        raise AssertionError(f"no usage report within {timeout} s")

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._thread.join(timeout=10)


def _post_code(port, path, body, timeout=300):
    """(status, headers, parsed body) of a POST, an error status too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _guard_seconds(parsed) -> tuple:
    """(count, sum, {le: cumulative count}) of tpushare_device_time_seconds
    over its phases, from a parsed /metrics."""
    s = parsed["samples"]
    buckets = {}
    for labels, v in s.get("tpushare_device_time_seconds_bucket", ()):
        buckets[labels["le"]] = buckets.get(labels["le"], 0.0) + v
    return (sum(v for _, v in s.get("tpushare_device_time_seconds_count",
                                    ())),
            sum(v for _, v in s.get("tpushare_device_time_seconds_sum",
                                    ())), buckets)


def _longest_guard_bound(before, after) -> float:
    """An upper bound of the longest guard between two /metrics reads:
    the least bucket bound whose count grew by all the guards between
    them."""
    n = after[0] - before[0]
    for le in sorted((k for k in after[2] if k != "+Inf"), key=float):
        if after[2][le] - before[2].get(le, 0.0) >= n:
            return float(le)
    return float("inf")


def _metrics(port):
    from tpushare_torch.telemetry import parse_text

    return parse_text(_get(port, "/metrics")[1])


def _tenant_plane(torch, srv, cfg, sink, t_up: float, t_load0: float,
                  t_load1: float, served: int) -> dict:
    """The grant phase's tenant-plane checks (see the module docstring,
    phase 14), on the running server ``srv`` whose usage reports reach
    ``sink``; ``served`` is the tokens the load received, over
    [t_load0, t_load1]."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpushare_torch.serving.policy import PACE_BURST_S

    port = srv.port
    # the second report after the load: its books were read after the
    # load's last response (the first may have been read just before)
    _, rep = sink.next_after(sink.next_after(t_load1)[0])
    check(rep["generated_tokens"] == served,
          f"the report counts {rep['generated_tokens']} generated tokens, "
          f"the load received {served}")
    # the cost plane: the report carries the serving programs' FLOPs
    check(rep["flops"] > 0, f"the report carries flops {rep['flops']}")
    code, text = _get(port, "/healthz")
    check(code == 200, f"/healthz {code}: {text}")
    parsed = _metrics(port)
    check(parsed["samples"].get("tpushare_device_time_seconds_count"),
          "/metrics has no device-time series")
    rate = rep["device_time_s"] / (t_load1 - t_load0)
    r = rate / 2

    # the paced window under a closed-loop load
    rng = np.random.default_rng(SEED + 14)
    stop = threading.Event()
    sent = []

    def client(i):
        prompt = rng.integers(0, cfg.vocab, 256 + 64 * i).tolist()
        while not stop.is_set():
            c, _, body = _post_code(port, "/generate",
                                    {"tokens": [prompt],
                                     "max_new_tokens": 64})
            sent.append(c)

    g_before = _guard_seconds(_metrics(port))
    sink.answer(f"pace:{r:.6f}")
    t_ask = time.perf_counter()
    sink.next_after(t_ask)            # this report's answer applied r
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(PACED_CLIENTS)]
    for t in threads:
        t.start()
    w0, rep0 = sink.next_after(time.perf_counter())
    w1, rep1 = sink.next_after(w0 + PACED_WINDOW_S)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    g_after = _guard_seconds(_metrics(port))
    _, stats = _get(port, "/stats")
    stats = json.loads(stats)
    pacer = stats["batcher"]["policy"]
    check(abs(pacer["rate"] - r) <= 1e-6 * max(1.0, r),
          f"the pacer runs at {pacer['rate']}, the verdict said {r}")
    longest = _longest_guard_bound(g_before, g_after)
    paced = rep1["device_time_s"] - rep0["device_time_s"]
    window = w1 - w0
    bound = r * window + PACE_BURST_S * r + longest
    check(paced <= bound, f"{paced} s of device time in a {window} s paced "
          f"window at {r}/s, over the bound {bound}")
    check(sent and all(c == 200 for c in sent),
          f"the paced load's requests answered {sorted(set(sent))}")

    # refuse: 429 + Retry-After; then ok: served again
    small = {"tokens": [list(range(1, 17))], "max_new_tokens": 4}
    sink.answer("refuse")
    t_end = time.perf_counter() + 30
    code = 200
    while time.perf_counter() < t_end:
        code, headers, body = _post_code(port, "/generate", small)
        if code == 429:
            break
        time.sleep(0.2)
    check(code == 429, f"/generate answered {code} under refuse")
    retry_after = headers.get("Retry-After")
    check(retry_after is not None and int(retry_after) >= 1,
          f"429 without a Retry-After: {headers}")
    sink.answer("ok")
    t_end = time.perf_counter() + 30
    while time.perf_counter() < t_end:
        code, _, body = _post_code(port, "/generate", small)
        if code == 200:
            break
        time.sleep(0.25)
    check(code == 200 and len(body["tokens"][0]) == 20,
          f"/generate answered {code} after ok: {body}")
    refusals = sum(v for _, v in _metrics(port)["samples"].get(
        "tpushare_policy_admission_refused_total", ()))
    check(refusals >= 1, "no refusal counted")

    # one request's wall, the device time its guards attributed and its
    # rounds' walls; the profiler's busy time for the same request again
    one = {"tokens": [rng.integers(0, cfg.vocab, 1000).tolist()],
           "max_new_tokens": 32}
    _post_code(port, "/generate", one)          # the same request warm
    m0 = _metrics(port)
    t0 = time.perf_counter()
    _post_code(port, "/generate", one)
    wall = time.perf_counter() - t0
    m1 = _metrics(port)

    def total(parsed, name):
        return sum(v for _, v in parsed["samples"].get(name, ()))

    guard_s = _guard_seconds(m1)[1] - _guard_seconds(m0)[1]
    rounds_s = (total(m1, "tpushare_tick_duration_seconds_sum")
                - total(m0, "tpushare_tick_duration_seconds_sum"))
    n_rounds = (total(m1, "tpushare_tick_duration_seconds_count")
                - total(m0, "tpushare_tick_duration_seconds_count"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _post_code(port, "/generate", one)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0)
    reports = [b for _, b in sink.reports]
    return {"reports": len(reports), "report_s": REPORT_S,
            "load_device_time_rate": rate, "pace_rate": r,
            "paced_window_s": window, "paced_device_s": paced,
            "paced_rate": paced / window, "paced_bound_s": bound,
            "longest_guard_bound_s": longest,
            "paced_requests": len(sent), "pacer": pacer,
            "retry_after": retry_after, "refusals": refusals,
            "peak_bytes_max": max((b["peak_bytes"] for b in reports
                                   if b["peak_bytes"] is not None),
                                  default=None),
            "grant_bytes_reported": reports[-1]["grant_bytes"],
            "report_flops": rep["flops"],
            "one_request": {"wall_s": wall, "guard_device_s": guard_s,
                            "rounds": n_rounds, "rounds_wall_s": rounds_s,
                            "profiled_wall_s": prof_wall,
                            "profiler_busy_s": busy_us / 1e6},
            "last_report": reports[-1],
            "_reports": [(t - t_up, b) for t, b in sink.reports]}


def phase_grant(torch, card: str):
    """Llama-3-8B at full width and depth, int8 weights and an int8 KV
    pool, served inside a 14 GiB grant: started by the server's own
    start-up (``llm.start_server``: contract, then the allocator capped at
    the granted fraction, then a model built one layer slice at a time),
    driven by the server phase's load.  Checks that the int8 K2 ran in
    every paged forward's every layer and the bf16 one never, that the
    peak reserved memory stayed inside the grant, and that the allocator
    refuses an allocation past it; then restores the whole card."""
    from tpushare_torch import telemetry
    from tpushare_torch.ops.quant import hbm_bytes
    from tpushare_torch.runtime import contract
    from tpushare_torch.serving import llm

    args = llm.parse_args([
        "--model", "llama3-8b", "--int8", "--kv-dtype", "int8",
        "--slots", "8", "--page-size", "16",
        "--kv-pool-bytes", str(GRANT_POOL_BYTES), "--port", "0",
        "--device", "cuda"])
    sink = _UsageSink()
    env = dict(GRANT_ENV, HOSTNAME="chip-smoke-grant",
               TPUSHARE_STATUS_PORT=str(sink.port),
               TPUSHARE_USAGE_REPORT_S=str(REPORT_S))
    gc.collect()
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    # this tenant's own books: the reports count its work alone
    telemetry.REGISTRY.reset()
    telemetry.health.MONITOR.reset()
    t0 = time.perf_counter()
    srv = llm.start_server(args, env=env).start()
    try:
        torch.cuda.synchronize()
        t_up = time.perf_counter()
        init_s = t_up - t0
        cfg = srv.cfg
        _check_llama3_8b(cfg)
        check(cfg.kv_dtype == "int8" and isinstance(
            srv.params["layers"]["wq"], dict), "the model is not int8")
        weights_bytes = hbm_bytes(srv.params)
        t_load0 = time.perf_counter()
        res = _drive_server(srv.port, cfg)
        t_load1 = time.perf_counter()
        torch.cuda.synchronize()
        peak_reserved = torch.cuda.max_memory_reserved()
        peak_allocated = torch.cuda.max_memory_allocated()
        budget = contract.verify_budget("cuda", GRANT_ENV)
        check(budget is not None and budget["enforced"],
              f"the grant is not enforced: {budget}")
        grant = budget["grant_bytes"]
        # one allocation that would take the process past the grant: the
        # cache emptied first, so the request cannot land in memory that
        # is reserved but free, and sized from the live allocations
        torch.cuda.empty_cache()
        reserved_after = torch.cuda.memory_reserved()
        over = grant - torch.cuda.memory_allocated() + (1 << 30)
        try:
            torch.empty(over, dtype=torch.uint8, device="cuda")
            refused = False
        except torch.OutOfMemoryError:
            refused = True
        tenant = _tenant_plane(torch, srv, cfg, sink, t_up, t_load0,
                               t_load1, res["tokens_received"])
    finally:
        srv.stop()
        sink.stop()
        torch.cuda.set_per_process_memory_fraction(1.0)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    _check_k2_arms(res, "_int8", cfg.n_layers)
    check(peak_reserved <= grant,
          f"peak reserved {peak_reserved} past the grant {grant}")
    check(refused, f"an allocation of {over} bytes past the grant "
                   f"was not refused")
    kv = res.pop("kv_storage")
    check(kv["kv_dtype"] == "int8" and kv["pool_bytes"] <= GRANT_POOL_BYTES,
          f"kv storage {kv}")
    # every report: inside the grant, device time never falling and under
    # the server's uptime at its arrival
    reports = tenant.pop("_reports")
    check(len(reports) >= 3, f"{len(reports)} usage reports")
    last = 0.0
    for up, rep in reports:
        check(rep["peak_bytes"] is not None and rep["peak_bytes"] <= grant,
              f"a report's peak {rep['peak_bytes']} past the grant {grant}")
        check(last <= rep["device_time_s"] <= up,
              f"device time {rep['device_time_s']} after {last}, "
              f"{up} s into the server's life")
        last = rep["device_time_s"]
    res["tenant"] = tenant
    res.update({"model": "llama3-8b", "card": card, "weights": "int8",
                "kv_dtype": "int8", "init_s": init_s, "env": GRANT_ENV,
                "grant_bytes": grant, "limit_bytes": budget["limit_bytes"],
                "reserved_before_bytes": reserved_before,
                "peak_reserved_bytes": peak_reserved,
                "peak_allocated_bytes": peak_allocated,
                "weights_bytes": weights_bytes,
                "kv_pool_bytes": kv["pool_bytes"], "kv_pages": kv["n_pages"],
                "kv_bytes_per_page": kv["bytes_per_page"],
                "reserved_after_serving_bytes": reserved_after,
                "over_grant_refused_bytes": over})
    return res


def phase_agreement(torch):
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg = tf.flagship_small()
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (37, 120, 300)]

    def first_logits(c, p):
        b = PagedContinuousBatcher(p, c, n_slots=1, page_size=16,
                                   device="cuda")
        check(b._reserve(0, len(prompts[0]), 1), "no pages")
        return b._prefill_into(0, prompts[0]).float()

    # the same weights in f32 through the gather path: the yardstick both
    # bf16 read paths are measured against
    p32 = _widened(params)
    ref32 = first_logits(dataclasses.replace(
        cfg, dtype=torch.float32, attn_kernel="gather"), p32)
    del p32
    first = {}
    streams = {}
    for kind in ("kernel", "gather"):
        c = dataclasses.replace(cfg, attn_kernel=kind)
        first[kind] = first_logits(c, params)
        b2 = PagedContinuousBatcher(params, c, n_slots=3, page_size=16,
                                    device="cuda")
        rids = [b2.admit(p, 16) for p in prompts]
        b2.run_until_drained()
        streams[kind] = [b2.completed[r][len(p):]
                         for r, p in zip(rids, prompts)]
    # the no-cache forward through K1: last-position logits of the prompt
    toks = torch.tensor([prompts[0]], device="cuda")
    before = attn.flash_attention_lse.launches
    with torch.inference_mode():
        first["k1_forward"] = tf.forward(params, toks, cfg)[0, -1]
    check(attn.flash_attention_lse.launches == before + cfg.n_layers,
          "forward did not run K1 in every layer")
    # Every bf16 path sits ~5e-2 from the f32 model on these logits
    # (|logit| <= 4): bf16 noise through four layers, not the read path.
    # So the kernel paths are held to the f32 gather within LOGIT_TOL, and
    # to be no less faithful than the bf16 gather path (25% slack).
    to32 = {k: (v - ref32).abs().max().item() for k, v in first.items()}
    for arm in ("kernel", "k1_forward"):
        check(to32[arm] <= LOGIT_TOL,
              f"{arm} logits {to32[arm]} from the f32 gather path")
        check(to32[arm] <= 1.25 * to32["gather"],
              f"{arm} {to32[arm]} vs bf16 gather {to32['gather']} from "
              f"the f32 model")
    agree = np.mean([a == b for sa, sb in zip(streams["kernel"],
                                              streams["gather"])
                     for a, b in zip(sa, sb)])
    return {"model": "flagship-small",
            "kernel_vs_gather_max_abs_err":
                (first["kernel"] - first["gather"]).abs().max().item(),
            "vs_f32_max_abs_err": to32,
            "f32_logit_absmax": ref32.abs().max().item(),
            "greedy_token_agreement": float(agree),
            "streams_kernel": streams["kernel"],
            "streams_gather": streams["gather"]}


#: the step profile's fields a phase keeps (``profile_decode._profiled``)
STEP_KEYS = ("wall_ms_per_step", "device_busy_ms_per_step",
             "device_busy_share", "device_ops_per_step")


def _step_profile(b, prompts, steps=8) -> dict:
    """Wall, device busy time and ops of one decode step of batcher
    ``b`` with one greedy request a prompt in flight, by
    ``profile_decode``'s profiler (a warm-up step, ``steps`` timed, then
    ``steps`` profiled), and its five busiest kernels."""
    from tpushare_torch.profile_decode import _profiled

    for p in prompts:
        check(b.admit(p, 2 * steps + 4) is not None, "step-profile admission")
    prof = _profiled(b.tick, steps)
    b.run_until_drained()
    out = {k: prof[k] for k in STEP_KEYS}
    out["top_kernels"] = prof["top_kernels"][:5]
    return out


def _zero_launch_counts() -> None:
    from tpushare_torch.ops import attention as attn

    attn.flash_attention_lse.launches = 0
    for kind in attn.K2_KINDS:
        setattr(attn.paged_decode_attention, f"launches{kind}", 0)
        setattr(attn.paged_decode_attention, f"launches_decode{kind}", 0)


def _dense_f32_errors(torch, params, cfg, prompts):
    """``params`` widened to f32: each prompt's first-step logits and its
    first decode step's (from the dense rows' argmax) on dense rows
    against the paged pool's gather read, as max abs differences."""
    import dataclasses

    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    gc.collect()
    torch.cuda.empty_cache()
    p32 = _widened(params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    dense = ContinuousBatcher(p32, c32, len(prompts), device="cuda")
    first = _first_logits(dense, prompts)
    tokens = [int(x.argmax()) for x in first]
    got = first + _step_logits(dense, prompts, tokens)
    del dense
    gather = PagedContinuousBatcher(
        p32, dataclasses.replace(c32, attn_kernel="gather"),
        n_slots=len(prompts), page_size=16, n_pages=300, device="cuda")
    want = _first_logits(gather, prompts) + _step_logits(gather, prompts,
                                                         tokens)
    del gather, p32
    gc.collect()
    torch.cuda.empty_cache()
    return [(g - w).abs().max().item() for g, w in zip(got, want)]


def phase_dense(torch, card: str, shared: dict):
    """Llama-3-8B at full width and depth on DENSE slot rows: an
    ``LLMServer(n_slots=8, page_size=0)`` (8 rows of 8,192 tokens) serves
    the server phase's load; its ``storage_info`` says dense with the
    pool's bytes; ``/score`` ran K1 once a layer and nothing ran K2 (the
    dense read is ``cached_attention`` in plain PyTorch).  The greedy
    prompts' first-step logits, and their logits at the first decode
    step from the same token (the bf16 GEMM over a row read to the
    longest row's length), are held to a paged pool's on the same
    weights, within LOGIT_TOL or 1.25x the paged pool's own K2-against-
    gather distance at those steps where that is larger.  bf16 noise
    hides a single key, so the same weights widened to f32 hold the
    dense rows' first-step and decode-step logits to the paged pool's
    gather read within F32_LOGIT_TOL (a read bound one key short fails
    there).  Then a dense and a paged decode step's wall and busy time.
    Leaves the weights,
    the 2000-token prompt, its dense first-step and decode-step logits,
    the step's token and the tolerance in ``shared`` for the generate
    phase."""
    import dataclasses

    from tpushare_torch.ops.quant import kv_cache_bytes
    from tpushare_torch.serving.llm import LLMServer, build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=0,
                    device="cuda").start()
    try:
        res = _drive_server(srv.port, cfg)
    finally:
        srv.stop()
    b = srv._service._batcher
    del srv
    kv = res.pop("kv_storage")
    want_bytes = 8 * kv_cache_bytes(cfg, cfg.max_seq)
    check(kv["kind"] == "dense" and kv["pool_bytes"] == want_bytes
          and kv["slot_tokens"] == cfg.max_seq, f"dense storage {kv}")
    got = res["launches"]
    check(got["flash_fwd"] == cfg.n_layers,
          f"K1 launched {got['flash_fwd']} times for one /score")
    check(not any(n for k, n in got.items() if k.startswith("paged_")),
          f"K2 ran on dense storage: {got}")

    prompts, _ = _load_prompts(cfg)
    greedy = prompts[:3]
    dense_first = _first_logits(b, prompts)
    tokens = [int(x.argmax()) for x in dense_first]
    dense_step = _step_logits(b, prompts, tokens)
    check(all(torch.isfinite(x).all().item()
              for x in dense_first + dense_step),
          "dense first-step or decode-step logits not finite")
    ref = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                 n_pages=300, device="cuda")
    want = _first_logits(ref, greedy) + _step_logits(ref, greedy, tokens)
    gather = PagedContinuousBatcher(
        params, dataclasses.replace(cfg, attn_kernel="gather"), n_slots=3,
        page_size=16, n_pages=300, device="cuda")
    noise = [(g - w).abs().max().item() for g, w in zip(
        _first_logits(gather, greedy) + _step_logits(gather, greedy, tokens),
        want)]
    del gather
    errs = [(d - w).abs().max().item()
            for d, w in zip(dense_first[:3] + dense_step[:3], want)]
    tol = max(LOGIT_TOL, 1.25 * max(noise))
    check(max(errs) <= tol,
          f"dense first-step and decode-step logits {errs} from the paged "
          f"pool's, past LOGIT_TOL and 1.25x the paged read paths' own "
          f"distance {noise}")
    step = {"dense": _step_profile(b, prompts),
            "paged": _step_profile(ref, prompts)}
    del b, ref
    err32 = _dense_f32_errors(torch, params, cfg, greedy)
    check(max(err32) <= F32_LOGIT_TOL,
          f"f32 dense first-step and decode-step logits {err32} from the "
          f"f32 paged gather read's, past {F32_LOGIT_TOL}")
    res.update({"model": "llama3-8b", "card": card, "storage": kv,
                "first_logit_max_abs_err": errs[:3],
                "step_logit_max_abs_err": errs[3:],
                "f32_first_logit_max_abs_err": err32[:3],
                "f32_step_logit_max_abs_err": err32[3:],
                "paged_kernel_vs_gather_max_abs_err": noise,
                "logit_tol": tol,
                "logit_absmax": max(w.abs().max().item() for w in want),
                "decode_step": step})
    shared.update({"cfg": cfg, "params": params, "prompt": prompts[3],
                   "dense_first": dense_first[3], "token": tokens[3],
                   "dense_step": dense_step[3], "tol": tol})
    return res


def phase_generate(torch, card: str, shared: dict):
    """``LLMServer(n_slots=0)`` on the dense phase's weights: one
    2000-token greedy ``/generate`` of 32 new tokens through
    ``generate_fused`` (a dense cache of one row), sent twice (the same
    tokens; the second timed).  No kernel of the port runs.  Its
    first-step logits, from the same prefill ``generate_fused`` runs, and
    its first decode step's (``make_decode_fns``' step, which
    ``generate_fused`` runs) are held to the dense batcher's within the
    dense phase's tolerance; its first token is the dense batcher's
    argmax and its second the decode step's.  The same two steps of a
    one-row dense batcher are read beside them (the bf16 gap traced to
    the rows a GEMM holds), and on the weights widened to f32 both of
    generate's steps are held to a one-row f32 dense batcher's within
    F32_LOGIT_TOL, where bf16 noise no longer hides a wrong key."""
    from tpushare_torch.models import transformer as tf
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.generate import make_decode_fns
    from tpushare_torch.serving.llm import LLMServer, kernel_launches

    cfg, params, prompt = shared["cfg"], shared["params"], shared["prompt"]
    srv = LLMServer(cfg, params, port=0, n_slots=0, device="cuda").start()
    try:
        _zero_launch_counts()
        body = {"tokens": [prompt], "max_new_tokens": 32}
        outs, walls = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            code, out = _post(srv.port, "/generate", body)
            walls.append(time.perf_counter() - t0)
            check(code == 200, f"/generate failed: {out}")
            outs.append(out["tokens"][0])
        launches = kernel_launches()
        _, stats = _get(srv.port, "/stats")
        stats = json.loads(stats)
    finally:
        srv.stop()
    row = outs[0]
    check(row[:len(prompt)] == prompt and len(row) == len(prompt) + 32
          and all(0 <= t < cfg.vocab for t in row),
          f"/generate: malformed tokens (len {len(row)})")
    check(outs[1] == row, "two greedy requests gave different tokens")
    check(not any(launches.values()), f"a kernel ran: {launches}")
    check("kv_storage" not in stats, "the no-slot server built a pool")
    prefill, step = make_decode_fns(cfg)
    caches = tf.init_kv_caches(cfg, 1, device="cuda")
    logits, _ = prefill(params, torch.tensor([prompt], device="cuda"),
                        caches, len(prompt))
    first = logits[0].float()
    tok = shared["token"]
    check(int(first.argmax()) == row[len(prompt)] == tok,
          "the first generated token is not the prefill's argmax, or not "
          "the dense batcher's")
    logits, _ = step(params, torch.tensor([tok], device="cuda"), caches,
                     len(prompt))
    second = logits[0].float()
    del caches
    check(int(second.argmax()) == row[len(prompt) + 1],
          "the second generated token is not the decode step's argmax")
    err = [(first - shared["dense_first"]).abs().max().item(),
           (second - shared["dense_step"]).abs().max().item()]
    check(max(err) <= shared["tol"],
          f"generate's first-step and decode-step logits {err} from the "
          f"dense batcher's, past {shared['tol']}")
    # the bf16 decode-step gap, traced: the dense batcher holding this
    # one row alone (its GEMMs over one row, as generate's) from the same
    # token
    one = ContinuousBatcher(params, cfg, 1, device="cuda")
    one_err = [(_first_logits(one, [prompt])[0] - first).abs().max().item(),
               (_step_logits(one, [prompt], [tok])[0]
                - second).abs().max().item()]
    del one
    torch.cuda.empty_cache()
    err32 = _generate_f32_errors(torch, params, cfg, prompt)
    check(max(err32) <= F32_LOGIT_TOL,
          f"f32 generate first-step and decode-step logits {err32} from "
          f"the f32 dense batcher's, past {F32_LOGIT_TOL}")
    return {"model": "llama3-8b", "card": card, "prompt": len(prompt),
            "new_tokens": 32, "walls_s": walls,
            "tokens_per_s": 32 / walls[1],
            "first_logit_max_abs_err": err[0],
            "step_logit_max_abs_err": err[1], "logit_tol": shared["tol"],
            "one_row_dense_first_logit_max_abs_err": one_err[0],
            "one_row_dense_step_logit_max_abs_err": one_err[1],
            "f32_first_logit_max_abs_err": err32[0],
            "f32_step_logit_max_abs_err": err32[1],
            "launches": launches, "tokens": row[len(prompt):]}


def _generate_f32_errors(torch, params, cfg, prompt):
    """``params`` widened to f32: ``make_decode_fns``' first-step logits
    for ``prompt`` and its first decode step's (from the dense batcher's
    argmax) against a one-row f32 dense batcher's, as max abs
    differences.  Both hold one row, beside the bf16 weights."""
    import dataclasses

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.generate import make_decode_fns

    gc.collect()
    torch.cuda.empty_cache()
    p32 = _widened(params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    dense = ContinuousBatcher(p32, c32, 1, device="cuda")
    want = _first_logits(dense, [prompt])
    tok = int(want[0].argmax())
    want += _step_logits(dense, [prompt], [tok])
    del dense
    torch.cuda.empty_cache()
    prefill, step = make_decode_fns(c32)
    caches = tf.init_kv_caches(c32, 1, device="cuda")
    logits, _ = prefill(p32, torch.tensor([prompt], device="cuda"), caches,
                        len(prompt))
    got = [logits[0].float()]
    logits, _ = step(p32, torch.tensor([tok], device="cuda"), caches,
                     len(prompt))
    got.append(logits[0].float())
    del caches, p32
    gc.collect()
    torch.cuda.empty_cache()
    return [(g - w).abs().max().item() for g, w in zip(got, want)]


#: the spec phase: prompt-lookup speculation of depth 8, the service's
#: default of 4 verify rounds a call (half its 8 fused decode steps)
SPEC_K = 8
SPEC_ROUNDS = 4


def _spec_prompts(cfg):
    """The serving load's four greedy prompts (256/512/1000/2000 tokens),
    a 300-token prompt to be sampled, and a 256-token prompt that repeats
    one 16-token pattern (prompt lookup's home ground)."""
    import numpy as np

    prompts, _ = _load_prompts(cfg)
    rng = np.random.default_rng(SEED + 21)
    pattern = rng.integers(0, cfg.vocab, 16).tolist()
    return prompts, rng.integers(0, cfg.vocab, 300).tolist(), pattern * 16


def _serve_spec_load(port: int, cfg) -> dict:
    """The spec load through HTTP: the four greedy prompts, the sampled
    one (temperature 0.8, top-k 50) and the repeating one, 32 new tokens
    each, sent together; the kernels' launch counters zeroed just before
    and read just after.  Returns the streams' new tokens, the wall, the
    launches and ``/stats``."""
    from tpushare_torch.serving.llm import kernel_launches

    greedy, sampled, repeat = _spec_prompts(cfg)
    prompts = greedy + [sampled, repeat]
    reqs = [{"tokens": [p], "max_new_tokens": 32} for p in prompts]
    reqs[4].update({"temperature": 0.8, "top_k": 50, "seed": 7})
    results = [None] * len(reqs)

    def send(i):
        try:
            results[i] = _post(port, "/generate", reqs[i])
        except Exception as e:      # reported below
            results[i] = (None, repr(e))

    _zero_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    _, stats = _get(port, "/stats")
    news = []
    for i, (code, body) in enumerate(results):
        check(code == 200, f"spec /generate {i} failed: {body}")
        row = body["tokens"][0]
        check(row[:len(prompts[i])] == prompts[i]
              and len(row) == len(prompts[i]) + 32
              and all(0 <= t < cfg.vocab for t in row),
              f"spec /generate {i}: malformed tokens (len {len(row)})")
        news.append(row[len(prompts[i]):])
    return {"news": news, "wall_s": wall, "launches": launches,
            "stats": json.loads(stats)}


def _served_spec(b, prompts, max_new: int, tokens=None, chunk=None):
    """Greedy ``prompts`` through batcher ``b``'s spec rounds (depth
    SPEC_K, SPEC_ROUNDS a call): admitted together by ``admit`` and
    drained by ``tick_spec``, or with ``chunk`` by ``admit_chunked`` and
    drained by ``tick_mixed_spec`` (a budget of one window) while a
    prompt streams.  Returns (the streams' new tokens, each prompt's
    first-step logits, the position-0 logits of its first verify block
    (its first decode step's), as f32, and the spec rounds run).
    ``tokens[i]``, where given, replaces prompt i's first token."""
    base = b._next_id
    firsts, verify0, pending = {}, {}, {}
    activate, verify = b._activate, b._verify_logits

    def capture(slot, rid, prompt, logits_v, *rest):
        firsts[rid] = logits_v.float().clone()
        activate(slot, rid, prompt, logits_v, *rest)
        if slot in b.slots:
            if tokens is not None:
                s = b.slots[slot]
                s.last_token = s.output[-1] = int(tokens[rid - base])
            pending[slot] = rid

    def spy(blocks, n_ctxs, live, operand, *rest):
        logits = verify(blocks, n_ctxs, live, operand, *rest)
        for slot, rid in pending.items():
            verify0[rid] = logits[slot, 0].float().clone()
        pending.clear()
        return logits

    b._activate, b._verify_logits = capture, spy
    rounds0 = b._spec_stats["rounds"]
    try:
        if chunk is None:
            rids = [b.admit(p, max_new) for p in prompts]
        else:
            rids = [b.admit_chunked(p, max_new, chunk=chunk)
                    for p in prompts]
        check(None not in rids, "spec admission refused")
        for _ in range(2000):
            if not b.prefilling and not b.slots:
                break
            if b.prefilling:
                b.tick_mixed_spec(SPEC_ROUNDS, chunk=chunk, budget=chunk,
                                  k=SPEC_K)
            else:
                b.tick_spec(SPEC_ROUNDS, k=SPEC_K)
        check(not b.prefilling and not b.slots, "the spec rounds did not "
              "drain")
    finally:
        b._activate, b._verify_logits = activate, verify
    news = [b.completed[r][len(p):] for r, p in zip(rids, prompts)]
    return (news, [firsts[r] for r in rids], [verify0.get(r) for r in rids],
            b._spec_stats["rounds"] - rounds0)


def _fused_streams(b, prompts, max_new: int):
    """Greedy ``prompts`` admitted together on batcher ``b`` and drained
    by ``tick_fused(8)``: their new tokens."""
    rids = [b.admit(p, max_new) for p in prompts]
    check(None not in rids, "fused admission refused")
    while b.slots:
        b.tick_fused(MIXED_STEPS)
    return [b.completed[r][len(p):] for r, p in zip(rids, prompts)]


def _spec_f32_streams(torch, params, cfg, prompts):
    """The weights widened to f32: the prompts' greedy streams (32 new
    tokens) through spec rounds against ``tick_fused``'s, on a paged pool
    read by the gather path and on dense rows; returns the spec rounds'
    streams and counts a storage and whether they equal the fused
    ones."""
    import dataclasses

    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    gc.collect()
    torch.cuda.empty_cache()
    p32 = _widened(params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attn_kernel="gather")
    out = {}
    for kind in ("paged", "dense"):
        def make(spec_k, kind=kind):
            if kind == "paged":
                return PagedContinuousBatcher(
                    p32, c32, n_slots=len(prompts), page_size=16,
                    n_pages=300, device="cuda", spec_k=spec_k)
            return ContinuousBatcher(p32, c32, len(prompts), device="cuda",
                                     spec_k=spec_k)

        b = make(SPEC_K)
        news, _, _, rounds = _served_spec(b, prompts, 32)
        stats = dict(b._spec_stats)
        del b
        torch.cuda.empty_cache()
        b = make(0)
        fused = _fused_streams(b, prompts, 32)
        del b
        torch.cuda.empty_cache()
        check(news == fused, f"f32 spec streams on {kind} storage differ "
              f"from tick_fused's: {news} / {fused}")
        out[kind] = {"rounds": rounds, "tokens": stats["tokens"],
                     "tokens_per_round": stats["tokens"] / stats["rounds"],
                     "streams_equal_fused": news == fused}
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _spec_pass(torch, b, prompts, counter: str, per_forward: int) -> dict:
    """A short spec pass on batcher ``b`` (int8 store, stripes): the
    prompts admitted whole, then the counters zeroed and the slots
    drained by ``tick_spec``; K2's ``counter`` entry point launched
    ``per_forward`` times a verify forward and no other K2 entry point."""
    from tpushare_torch.ops import attention as attn

    rids = [b.admit(p, 16) for p in prompts]
    check(None not in rids, "spec-pass admission refused")
    _zero_launch_counts()
    r0 = b._spec_stats["rounds"]
    while b.slots:
        b.tick_spec(SPEC_ROUNDS, k=SPEC_K)
    torch.cuda.synchronize()
    rounds = b._spec_stats["rounds"] - r0
    k2 = attn.paged_decode_attention
    got = {f"launches{a}{k}": getattr(k2, f"launches{a}{k}")
           for a in ("", "_decode") for k in attn.K2_KINDS}
    check(got[counter] == per_forward * rounds and rounds > 0
          and sum(got.values()) == got[counter],
          f"spec pass: {got} for {rounds} verify forwards")
    news = [b.completed[r][len(p):] for r, p in zip(rids, prompts)]
    check(all(len(n) == 16 for n in news), "spec pass: malformed streams")
    return {"rounds": rounds, "launches": got[counter],
            "tokens_per_round": sum(map(len, news)) / rounds,
            "storage": b.storage_info()}


def phase_spec(torch, card: str, shared: dict):
    """Prompt-lookup speculation on Llama-3-8B at full width and depth
    (the dense phase's bf16 weights): ``LLMServer(n_slots=8,
    page_size=16, spec_k=8)`` serves the spec load (``_serve_spec_load``)
    twice in turns with a server at ``spec_k`` 0 (plain, spec, spec,
    plain): its ``/stats`` speculation block nonzero; K2's S > 1 arm once
    a layer of every prefill and every verify forward, its decode arm of
    every decode step, no other entry point.  Then on batchers: in bf16
    through K2, the greedy prompts' first tokens equal the ticked pool's
    and the position-0 logits of their first verify block are within
    LOGIT_TOL or 1.25x the pool's K2-against-gather distance of the
    ticked first decode step's (the same first token); on the weights
    widened to f32, the streams of the greedy and repeating prompts
    through spec rounds equal ``tick_fused``'s, on a paged pool (gather
    read) and on dense rows; then a short spec pass on an int8 store
    (K2's int8 S > 1 entry point once a layer a verify forward) and on
    a pool of 2 stripes (K2's striped S > 1 entry point twice a layer)."""
    import dataclasses

    import numpy as np

    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.serving.llm import LLMServer
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg, params = shared["cfg"], shared["params"]
    _check_llama3_8b(cfg)
    n_layers = cfg.n_layers
    runs = {}
    for spec_k in (0, SPEC_K, SPEC_K, 0):
        srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                        spec_k=spec_k, device="cuda").start()
        try:
            runs.setdefault(spec_k, []).append(
                _serve_spec_load(srv.port, cfg))
        finally:
            srv.stop()
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    spec, plain = runs[SPEC_K][0], runs[0][0]
    st = spec["stats"]["batcher"]
    sp = st["speculation"]
    got = spec["launches"]
    check(sp["spec_k"] == SPEC_K and sp["rounds"] > 0 and sp["tokens"] > 0
          and sp["calls"] > 0, f"speculation block {sp}")
    check(spec["stats"]["kv_storage"]["spec_k"] == SPEC_K,
          "the server's storage does not report spec_k")
    verify_forwards = sp["rounds"]
    check(got["paged_attn"] >= n_layers * (st["prefills"] + verify_forwards)
          and got["paged_decode"] >= n_layers * st["decode_steps"],
          f"K2 launched {got} for {st['prefills']} prefills, "
          f"{verify_forwards} verify forwards and {st['decode_steps']} "
          f"decode steps")
    others = {k: n for k, n in got.items() if k.startswith("paged_")
              and k not in ("paged_attn", "paged_decode")}
    check(not any(others.values()), f"another K2 entry point ran: {others}")
    tps = {k: [32 * len(r["news"]) / r["wall_s"] for r in v]
           for k, v in runs.items()}
    greedy = [0, 1, 2, 3, 5]
    agree = float(np.mean([a == b for i in greedy
                           for a, b in zip(spec["news"][i],
                                           plain["news"][i])]))

    # bf16 through K2: the first verify block against the ticked step
    prompts, _, repeat = _spec_prompts(cfg)

    def pool(c, spec_k=0):
        return PagedContinuousBatcher(params, c, n_slots=8, page_size=16,
                                      n_pages=300, device="cuda",
                                      spec_k=spec_k)

    ref = _served_steps(pool(cfg), prompts, 2)
    first_tokens = [int(x.argmax()) for x in ref[1]]
    gather = _served_steps(pool(dataclasses.replace(cfg,
                                                    attn_kernel="gather")),
                           prompts, 2, tokens=first_tokens)
    noise = [(g - w).abs().max().item()
             for g, w in zip(gather[1] + gather[2], ref[1] + ref[2])]
    tol = max(LOGIT_TOL, 1.25 * max(noise))
    news, firsts, verify0, _ = _served_spec(pool(cfg, SPEC_K), prompts, 2,
                                            tokens=first_tokens)
    check([int(x.argmax()) for x in firsts] == first_tokens,
          "spec and ticked first tokens differ")
    check(all(v is not None and torch.isfinite(v).all().item()
              for v in verify0), "verify logits missing or not finite")
    errs = [(v - w).abs().max().item() for v, w in zip(verify0, ref[2])]
    check(max(errs) <= tol,
          f"first verify block's position-0 logits {errs} from the ticked "
          f"decode step's, past LOGIT_TOL and 1.25x the K2-against-gather "
          f"distance {noise}")
    gc.collect()
    torch.cuda.empty_cache()

    f32 = _spec_f32_streams(torch, params, cfg, prompts + [repeat])

    short = [prompts[0], prompts[1], repeat]
    int8 = _spec_pass(torch, PagedContinuousBatcher(
        params, dataclasses.replace(cfg, kv_dtype="int8"), n_slots=4,
        page_size=16, n_pages=300, device="cuda", spec_k=SPEC_K), short,
        "launches_int8", n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    striped = _spec_pass(torch, PagedContinuousBatcher(
        params, cfg, n_slots=4, page_size=16, n_pages=2 * 150,
        mesh=make_mesh({"sp": 2}, devices=["cuda:0", "cuda:0"]),
        spec_k=SPEC_K), short, "launches_striped", 2 * n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": "llama3-8b", "card": card, "spec_k": SPEC_K,
            "spec_rounds": SPEC_ROUNDS, "speculation": sp,
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "verify_forwards": verify_forwards,
            "verify_launches": n_layers * verify_forwards, "launches": got,
            "tokens_per_s": tps[SPEC_K], "plain_tokens_per_s": tps[0],
            "walls_s": [r["wall_s"] for r in runs[SPEC_K]],
            "plain_walls_s": [r["wall_s"] for r in runs[0]],
            "greedy_agreement_with_plain_bf16": agree,
            "repeat_tokens": spec["news"][5],
            "verify0_logit_max_abs_err": errs,
            "kernel_vs_gather_max_abs_err": noise, "logit_tol": tol,
            "f32": f32, "int8": int8, "striped": striped}


#: the rolling phase's prompt, longer than Mistral-7B's 4,096-token ring
ROLLING_PROMPT = 5000
ROLLING_CHUNK = 512


def _serve_chunked_mixed(torch, b, prompt, max_new: int):
    """One greedy request (``max_new`` >= 2) admitted by
    ``admit_chunked(chunk=512)`` and drained by ``tick_mixed`` with a
    budget of one window on batcher ``b``; returns (its new tokens, its
    first-step logits, its first decode step's logits, rounds, wall
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    news, firsts, steps, rounds, _ = _served_steps(
        b, [prompt], max_new, chunk=ROLLING_CHUNK, budget=ROLLING_CHUNK)
    torch.cuda.synchronize()
    return news[0], firsts[0], steps[0], rounds, time.perf_counter() - t0


def phase_rolling(torch, card: str):
    """Mistral-7B at full width and depth (bf16 random seeded weights):
    a ``ContinuousBatcher`` with AUTO rolling slots (4 rings of 4,096
    tokens, an eighth of a 32,768-token row each) serves a 5,000-token
    greedy prompt that wraps its ring, admitted by
    ``admit_chunked(chunk=512)`` and drained by ``tick_mixed``, 32 new
    tokens; nothing runs K1 or K2.  Its first-step logits are held to a
    one-slot full-row pool's (``rolling_slots=False``) on the same weights
    and rounds.  The ring and the row sum their keys in other orders, so
    in bf16 they differ by the model's rounding noise (as the agreement
    phase finds for two read paths): the same weights widened to f32 hold
    the ring to the row within F32_LOGIT_TOL, at the first step and at the
    first decode step (position 5,000, past the wrap: the ring's commit
    then attend), after the same first token; and the bf16 ring is held
    to be no further from the f32 row than 1.25x the bf16 row is.  Then
    speculation on rolling rows built with SPEC_K slots of slack: the
    prompt through ``tick_mixed_spec`` and ``tick_spec`` (depth SPEC_K),
    32 new tokens, its first-step logits held to the f32 row as the
    plain ring's are."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models.transformer import param_count
    from tpushare_torch.ops.quant import kv_cache_bytes
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.llm import build_model, kernel_launches

    cfg, params = build_model("mistral-7b", seed=SEED, device="cuda")
    check(cfg.d_model == 4096 and cfg.n_layers == 32 and cfg.vocab == 32000
          and cfg.n_kv_heads == 8 and cfg.d_ff == 14336
          and cfg.window == 4096 and cfg.max_seq == 32768,
          "mistral-7b config is not full width and depth")
    n_params = param_count(params)
    prompt = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab, ROLLING_PROMPT).tolist()
    b = ContinuousBatcher(params, cfg, 4, device="cuda")
    info = b.storage_info()
    check(info["kind"] == "rolling" and info["slot_tokens"] == cfg.window
          and 8 * info["bytes_per_slot"] == kv_cache_bytes(cfg, cfg.max_seq),
          f"rolling storage {info}")
    _zero_launch_counts()
    new, first, _, rounds, wall = _serve_chunked_mixed(torch, b, prompt, 32)
    launches = kernel_launches()
    check(not any(launches.values()), f"a kernel ran: {launches}")
    check(len(new) == 32 and all(0 <= t < cfg.vocab for t in new),
          f"rolling: malformed tokens (len {len(new)})")
    check(torch.isfinite(first).all().item(), "rolling logits not finite")
    del b
    torch.cuda.empty_cache()
    full = ContinuousBatcher(params, cfg, 1, device="cuda",
                             rolling_slots=False)
    full_info = full.storage_info()
    check(full_info["kind"] == "dense"
          and full_info["slot_tokens"] == cfg.max_seq,
          f"full-row storage {full_info}")
    new_f, first_f, _, _, wall_f = _serve_chunked_mixed(torch, full, prompt,
                                                        32)
    del full
    # speculation on rolling rows of spec_k slots of slack: the prompt by
    # admit_chunked(chunk=512) and tick_mixed_spec, then tick_spec
    spec_b = ContinuousBatcher(params, cfg, 4, device="cuda", spec_k=SPEC_K)
    spec_info = spec_b.storage_info()
    check(spec_info["kind"] == "rolling"
          and spec_info["slot_tokens"] == cfg.window + SPEC_K,
          f"rolling storage with spec slack {spec_info}")
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec_new, spec_first, _, spec_rounds = _served_spec(
        spec_b, [prompt], 32, chunk=ROLLING_CHUNK)
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t0
    spec_stats = dict(spec_b._spec_stats)
    del spec_b
    torch.cuda.empty_cache()
    check(not any(kernel_launches().values()), "a kernel ran in the "
          "rolling spec pass")
    check(spec_rounds > 0 and len(spec_new[0]) == 32
          and all(0 <= t < cfg.vocab for t in spec_new[0]),
          f"rolling spec pass: {spec_rounds} rounds, malformed tokens")
    # the same weights in f32: the ring's first-step and first
    # decode-step logits against the row's, one slot each
    p32 = _widened(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    f32 = {}
    for rolling in (None, False):
        b32 = ContinuousBatcher(p32, c32, 1, device="cuda",
                                rolling_slots=rolling)
        f32[b32.storage_info()["kind"]] = _serve_chunked_mixed(
            torch, b32, prompt, 2)
        del b32
        torch.cuda.empty_cache()
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    ring, row = f32["rolling"], f32["dense"]
    err32 = [(ring[i] - row[i]).abs().max().item() for i in (1, 2)]
    check(ring[0][0] == row[0][0],
          f"the f32 ring and row chose different first tokens (first-step "
          f"logits {err32[0]} apart)")
    err = (first - first_f).abs().max().item()
    to32 = {"rolling": (first - row[1]).abs().max().item(),
            "full_row": (first_f - row[1]).abs().max().item(),
            "spec_rolling": (spec_first[0] - row[1]).abs().max().item()}
    check(max(err32) <= F32_LOGIT_TOL,
          f"f32 rolling first-step and decode-step logits {err32} from the "
          f"f32 full row's, past {F32_LOGIT_TOL}")
    check(max(to32["rolling"], to32["spec_rolling"])
          <= max(LOGIT_TOL, 1.25 * to32["full_row"]),
          f"bf16 rolling logits (plain, and with spec slack) {to32} from "
          f"the f32 row, past 1.25x the bf16 row's")
    return {"model": "mistral-7b", "card": card, "params_b": n_params / 1e9,
            "storage": info, "full_row_storage": full_info,
            "prompt": len(prompt), "chunk": ROLLING_CHUNK, "rounds": rounds,
            "wall_s": wall, "full_row_wall_s": wall_f,
            "first_logit_max_abs_err": err,
            "f32_first_logit_max_abs_err": err32[0],
            "f32_step_logit_max_abs_err": err32[1],
            "vs_f32_full_row_max_abs_err": to32,
            "logit_absmax": first_f.abs().max().item(),
            "greedy_token_agreement": float(np.mean(
                [a == c for a, c in zip(new, new_f)])),
            "launches": launches, "tokens": new,
            "spec": {"storage": spec_info, "spec_k": SPEC_K,
                     "rounds": spec_rounds, "wall_s": spec_wall,
                     "tokens_per_round": (spec_stats["tokens"]
                                          / spec_stats["rounds"]),
                     "greedy_token_agreement": float(np.mean(
                         [a == c for a, c in zip(spec_new[0], new)]))},
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


#: the sp_stripe phase's pool: 2 stripes of 257 pages, each 256 usable
#: pages (4,096 tokens) and its trash page
SP_PAGES_PER_STRIPE = 257
#: its long prompt: 6,032 tokens with the new ones, 377 pages, more than
#: one stripe's (or an unstriped pool of the same bytes a device) holds
SP_LONG_PROMPT = 6000


def _first_logits(b, prompts):
    """Each prompt's first-step logits through batcher ``b``'s own pool
    (slot 0, its pages reserved and released around the prefill)."""
    out = []
    for p in prompts:
        check(b._reserve(0, len(p), 1), "no pages for a first-step prefill")
        out.append(b._prefill_into(0, p).float())
        b._release(0)
    return out


def _widened(params):
    """The params with every tensor widened to f32."""
    p32 = {k: v.float() for k, v in params.items() if k != "layers"}
    p32["layers"] = {k: v.float() for k, v in params["layers"].items()}
    return p32


@contextlib.contextmanager
def _sampler_logits(on_call=None):
    """The logits every decode step hands the batchers' sampler while the
    block runs ([B, V], as f32 copies, in order), or each handed to
    ``on_call`` instead."""
    from tpushare_torch.serving import continuous

    seen, sample = [], continuous._sample_next

    def spy(logits, *rest):
        if on_call is None:
            seen.append(logits.float().clone())
        else:
            on_call(logits)
        return sample(logits, *rest)

    continuous._sample_next = spy
    try:
        yield seen
    finally:
        continuous._sample_next = sample


def _step_logits(b, prompts, tokens):
    """Each prompt's logits at its first decode step through batcher
    ``b``'s own ``tick``: the prompts admitted greedy together, each
    slot's first token set to ``tokens[i]`` (so that every storage
    compared reads the same token), then one tick, which finishes
    them."""
    rows = []
    for p, tok in zip(prompts, tokens):
        rid = b.admit(p, 2)
        check(rid is not None, "step-logit admission")
        slot = next(i for i, s in b.slots.items() if s.request_id == rid)
        b.slots[slot].last_token = b.slots[slot].output[-1] = int(tok)
        rows.append(slot)
    with _sampler_logits() as seen:
        b.tick()
    check(not b.slots, "the step-logit requests did not finish")
    return [seen[0][r] for r in rows]


def _decode_step_ms(torch, b, prompts, steps=8) -> float:
    """Median wall of ``steps`` decode ticks of batcher ``b`` with one
    greedy request a prompt in flight (two warm-up ticks first)."""
    import numpy as np

    for p in prompts:
        check(b.admit(p, steps + 3) is not None, "decode-step admission")
    walls = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.tick()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    b.run_until_drained()
    return float(np.median(walls))


def phase_sp_stripe(torch, card: str):
    """Position-striped serving of Llama-3-8B at full width and depth:
    a ``ContinuousService`` over a pool of 2 x 257 pages striped on a
    mesh of two shards on this one card serves the server phase's four
    requests and a 6,000-token greedy prompt that an unstriped pool of
    257 pages (the bytes of one stripe) refuses.  The launch counters are
    zeroed just before the load and read just after: K2's striped
    variant twice per layer of every paged forward, the unstriped K2
    never.  The greedy prompts' first-step logits are held to an
    unstriped pool of 700 pages on the same weights.  Then the same on
    int8 pools."""
    import dataclasses

    import numpy as np

    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.serving.continuous import ContinuousService
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    mesh = make_mesh({"sp": 2}, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(SEED + 11)
    lens = [256, 512, 1000, 2000, SP_LONG_PROMPT]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
    greedy = [0, 1, 2, 4]
    k2 = attn.paged_decode_attention
    counters = tuple(f"launches{arm}{kind}" for arm in ("", "_decode")
                     for kind in attn.K2_KINDS)
    res = {"model": "llama3-8b", "card": card, "sp": 2,
           "devices": [str(d) for d in mesh.devices],
           "pages_per_stripe": SP_PAGES_PER_STRIPE}

    single = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                    n_pages=SP_PAGES_PER_STRIPE,
                                    device="cuda")
    try:
        single.validate_request(prompts[4], 32)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None, "an unstriped pool of one stripe's pages "
                               "took the 6,000-token prompt")
    res["unstriped_refusal"] = refusal
    del single
    torch.cuda.empty_cache()

    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_dtype=kv)
        svc = ContinuousService(params, c, 8, page_size=16,
                                n_pages=2 * SP_PAGES_PER_STRIPE, mesh=mesh)
        b = svc._batcher
        info = svc.storage_info()
        check(info["sp_shards"] == 2
              and info["n_pages"] == 2 * SP_PAGES_PER_STRIPE,
              f"striped storage {info}")
        svc.validate(prompts[4], 32)       # the striped pool takes it
        svc.start()
        try:
            for name in counters:
                setattr(k2, name, 0)
            t0 = time.perf_counter()
            sinks = [svc.submit(p, 32, **(sampled if i == 3 else {}))
                     for i, p in enumerate(prompts)]
            outs = [s.get(timeout=600) for s in sinks]
            wall = time.perf_counter() - t0
            launches = {name: getattr(k2, name) for name in counters}
            snap = svc.snapshot()
            timings = list(svc.timings)
        finally:
            svc.stop()
        for i, o in enumerate(outs):
            check(isinstance(o, list) and o[:lens[i]] == prompts[i]
                  and len(o) == lens[i] + 32
                  and all(0 <= t < cfg.vocab for t in o),
                  f"sp_stripe {kv}: request {i} came back {str(o)[:200]}")
        forwards = snap["prefills"] + snap["decode_steps"]
        kind = "_int8_striped" if kv == "int8" else "_striped"
        mine = (f"launches{kind}", f"launches_decode{kind}")
        check(launches[mine[0]] + launches[mine[1]]
              == 2 * cfg.n_layers * forwards and forwards > 0
              and launches[mine[1]] >= 2 * cfg.n_layers
              * snap["decode_steps"] and launches[mine[0]] > 0,
              f"sp_stripe {kv}: {launches} for {forwards} forwards")
        check(all(n == 0 for name, n in launches.items()
                  if name not in mine),
              f"sp_stripe {kv}: another K2 entry point ran: {launches}")

        ref = PagedContinuousBatcher(params, c, n_slots=8, page_size=16,
                                     n_pages=700, device="cuda")
        greedy_prompts = [prompts[i] for i in greedy]
        want = _first_logits(ref, greedy_prompts)
        got = _first_logits(b, greedy_prompts)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got),
              f"sp_stripe {kv}: logits not finite")
        # the bf16 noise of this model: the unstriped pool's two read
        # paths (K2 and the gather) on the same weights and prompts
        gather = PagedContinuousBatcher(
            params, dataclasses.replace(c, attn_kernel="gather"), n_slots=1,
            page_size=16, n_pages=700, device="cuda")
        noise = [(g - w).abs().max().item() for g, w in
                 zip(_first_logits(gather, greedy_prompts), want)]
        del gather
        torch.cuda.empty_cache()
        check(max(errs) <= max(LOGIT_TOL, 1.25 * max(noise)),
              f"sp_stripe {kv}: first-step logits {errs} from the unstriped "
              f"pool, past LOGIT_TOL and 1.25x the unstriped read paths' "
              f"own distance {noise}")
        step_prompts = [prompts[i] for i in range(4)]
        step = {"striped": _decode_step_ms(torch, b, step_prompts),
                "unstriped": _decode_step_ms(torch, ref, step_prompts)}
        ttfts = [t["ttft_s"] for t in timings]
        res[kv] = {"launches": launches, "forwards": forwards,
                   "rounds": snap["rounds"],
                   "prefill_tokens": snap["prefill_tokens"],
                   "prefills": snap["prefills"],
                   "decode_steps": snap["decode_steps"],
                   "generate_wall_s": wall,
                   "tokens_per_s": 32 * len(prompts) / wall,
                   "ttft_s": {"mean": float(np.mean(ttfts)),
                              "max": float(np.max(ttfts))},
                   "first_logit_max_abs_err": errs,
                   "unstriped_kernel_vs_gather_max_abs_err": noise,
                   "logit_absmax": max(w.abs().max().item() for w in want),
                   "decode_step_ms": step,
                   "pool_bytes": info["pool_bytes"],
                   "pool_bytes_per_shard": info["pool_bytes_per_shard"],
                   "sampled_tokens": outs[3][lens[3]:]}
        del svc, b, ref
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the tp phase: a pool of 700 pages (every shard its half of the kv
#: heads of every page), the decode step's 8 rows and the per-shard K2
TP_PAGES = 700
TP_STEP_LENS = (256, 512, 768, 1000, 1250, 1500, 1750, 2000)
TP_FORWARD_LEN = 2000


@contextlib.contextmanager
def _launch_heads():
    """Every K2 and K1 launch in the block, counted by (q heads, kv
    heads) of the launch: ``{"k2": Counter, "k1": Counter}``; and K2's
    by (q rows, S) under ``"k2_rows"``."""
    import collections

    from tpushare_torch.ops import attention as attn

    seen = {"k2": collections.Counter(), "k1": collections.Counter(),
            "k2_rows": collections.Counter()}
    k2, k1 = attn.launch_k2, attn.flash_attention

    def spy_k2(cuda, q, leaves, *rest, **kw):
        seen["k2"][(q.shape[1], leaves[0].shape[1])] += 1
        seen["k2_rows"][(q.shape[0], q.shape[2])] += 1
        return k2(cuda, q, leaves, *rest, **kw)

    def spy_k1(q, k, v, *rest, **kw):
        seen["k1"][(q.shape[1], k.shape[1])] += 1
        return k1(q, k, v, *rest, **kw)

    attn.launch_k2, attn.flash_attention = spy_k2, spy_k1
    try:
        yield seen
    finally:
        attn.launch_k2, attn.flash_attention = k2, k1


def _tp_serve(torch, params, cfg, mesh, prompts, sampled, **svc_kw) -> dict:
    """The server phase's four requests (the last sampled) through a
    ``ContinuousService`` over a ``TP_PAGES`` paged pool on ``mesh``
    (``svc_kw``: the service's other keywords, e.g. ``pp``), the launch
    counters zeroed just before the load and read just after, each K2
    launch's head counts and (rows, S) beside them.  Returns the numbers
    and the service's batcher, stopped."""
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.serving.continuous import ContinuousService

    k2 = attn.paged_decode_attention
    counters = tuple(f"launches{arm}{kind}" for arm in ("", "_decode")
                     for kind in attn.K2_KINDS)
    svc = ContinuousService(params, cfg, 8, page_size=16, n_pages=TP_PAGES,
                            mesh=mesh, **svc_kw)
    svc.start()
    try:
        _zero_launch_counts()
        with _launch_heads() as heads:
            t0 = time.perf_counter()
            sinks = [svc.submit(p, 32, **(sampled if i == 3 else {}))
                     for i, p in enumerate(prompts)]
            outs = [s.get(timeout=600) for s in sinks]
            wall = time.perf_counter() - t0
        launches = {name: getattr(k2, name) for name in counters}
        snap = svc.snapshot()
        info = svc.storage_info()
    finally:
        svc.stop()
    for i, o in enumerate(outs):
        check(isinstance(o, list) and o[:len(prompts[i])] == prompts[i]
              and len(o) == len(prompts[i]) + 32
              and all(0 <= t < cfg.vocab for t in o),
              f"tp: request {i} came back {str(o)[:200]}")
    return svc._batcher, {
        "launches": launches, "launch_heads": {
            f"{h}q/{kv}kv": n for (h, kv), n in heads["k2"].items()},
        "launch_rows": {f"{r}x{q}": n
                        for (r, q), n in heads["k2_rows"].items()},
        "forwards": snap["prefills"] + snap["decode_steps"],
        "prefills": snap["prefills"], "decode_steps": snap["decode_steps"],
        "rounds": snap["rounds"], "generate_wall_s": wall,
        "tokens_per_s": 32 * len(prompts) / wall,
        "pool_bytes": info["pool_bytes"], "sp_shards": info["sp_shards"],
        "sampled_tokens": outs[3][len(prompts[3]):]}


def _tp_logits(torch, b, ref, noise_b, prompts, what="tp") -> dict:
    """The greedy prompts' first-step and first decode-step logits (the
    step from the reference's argmax token) of batcher ``b`` against
    ``ref``'s, and ``noise_b``'s (the gather read) against ``ref``'s: the
    bf16 noise of this model; max abs differences."""
    want = _first_logits(ref, prompts)
    tokens = [int(w.argmax()) for w in want]
    want_step = _step_logits(ref, prompts, tokens)
    got = _first_logits(b, prompts) + _step_logits(b, prompts, tokens)
    noise = (_first_logits(noise_b, prompts)
             + _step_logits(noise_b, prompts, tokens))
    check(all(torch.isfinite(g).all().item() for g in got),
          f"{what}: logits not finite")
    dist = [(g - w).abs().max().item()
            for g, w in zip(got, want + want_step)]
    gap = [(g - w).abs().max().item()
           for g, w in zip(noise, want + want_step)]
    return {"max_abs_err": dist, "kernel_vs_gather_max_abs_err": gap,
            "limit": max(LOGIT_TOL, 1.25 * max(gap))}


def _tp_k2_shard(torch, attn, flush) -> dict:
    """K2 at the per-shard shape of Llama-3-8B at tp = 2 (B = 8 rows of a
    2000-token context, 16 q and 4 kv heads, D = 128, bf16): the decode
    arm held to its plain version and timed (events, the profiler) beside
    its bytes bound; the S > 1 arm held at a 2000-token window of that
    shape; and ``sharded_paged_decode_attention`` over a whole layer
    pool split on a mesh of two tp shards on this card held to the whole
    pool's plain read.  Timed in phase_k2, early, where the profiler
    keeps every launch (after the tp phase's own profiles it saw no
    kernel of the L2 flush)."""
    from tpushare_torch import profile_k2
    from tpushare_torch.parallel.mesh import make_mesh, shard_kv_storage

    mesh = make_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"])

    contexts = [2000] * 8
    args = profile_k2.paged_operands(contexts, 1, SEED + 21, hkv=4, h=16)
    out = attn.paged_decode_attention(*args)
    ref = attn._paged_plain(*args, None)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item() and err <= OUT_TOL,
          f"tp: per-shard K2 decode arm {err} from its plain version")
    flops, nbytes = profile_k2.read_cost(contexts, 1, False, hkv=4, h=16)
    case = {"contexts": contexts, "S": 1, "H": 16, "Hkv": 4,
            "max_abs_err": err, "flops": flops, "bytes": nbytes}
    _time_k2(torch, attn, case, args, {}, 50, 5, flush)
    del args, out, ref
    pargs = profile_k2.paged_operands([2000], 2000, SEED + 22, hkv=4, h=16)
    pout = attn.paged_decode_attention(*pargs)
    pref = attn._paged_plain(*pargs, None)
    torch.cuda.synchronize()
    case["prefill_max_abs_err"] = (pout.float()
                                   - pref.float()).abs().max().item()
    check(case["prefill_max_abs_err"] <= OUT_TOL,
          f"tp: per-shard K2 S > 1 arm {case['prefill_max_abs_err']}")
    del pargs, pout, pref
    q, kp, vp, table, positions = profile_k2.paged_operands(
        contexts, 1, SEED + 23)
    shards = shard_kv_storage((kp[None], vp[None]), mesh)
    got = attn.sharded_paged_decode_attention(
        q, [k[0] for k, _ in shards], [v[0] for _, v in shards], table,
        positions, mesh)
    want = attn._paged_plain(q, kp, vp, table, positions, None)
    torch.cuda.synchronize()
    case["sharded_max_abs_err"] = (got.float()
                                   - want.float()).abs().max().item()
    check(case["sharded_max_abs_err"] <= OUT_TOL,
          f"tp: sharded K2 read {case['sharded_max_abs_err']} from the "
          f"whole pool's plain read")
    del q, kp, vp, shards, got, want
    torch.cuda.empty_cache()
    return case


def phase_tp(torch, card: str):
    """Tensor-parallel serving of Llama-3-8B at full width and depth on a
    mesh of two tp shards on this one card (``make_mesh({"tp": 2},
    devices=["cuda:0", "cuda:0"])``): the server phase's four requests
    through a ``ContinuousService`` over a bf16 pool, an int8 pool and a
    ``{"tp": 2, "sp": 2}`` mesh of four shards, the launch counters
    zeroed just before each load and read just after: K2 twice a layer
    of every paged forward at 16 q and 4 kv heads (four times, striped,
    under tp x sp); the greedy prompts' first-step and first decode-step
    logits held to a tp = 1 pool on the same weights within LOGIT_TOL or
    1.25x that pool's own K2-against-gather distance.  Then the dense
    rows at tp = 2 (first-step logits against tp = 1), ``forward(mesh=)``
    at a 2000-token prompt (K1 twice a layer at 16 and 4 heads, the
    logits at every position against tp = 1 within LOGIT_TOL or 1.25x the
    tp = 1 forward's distance from itself on the reference attention), a
    decode step of 8 rows at tp = 2 against tp = 1 (wall, busy, ops);
    K2 at the per-shard shape is phase_k2's (``_tp_k2_shard``)."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.mesh import make_mesh, shard_params
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    t0 = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    mesh = make_mesh({"tp": 2}, devices=["cuda:0", "cuda:0"])
    mesh4 = make_mesh({"tp": 2, "sp": 2}, devices=["cuda:0"] * 4)
    prompts, _ = _load_prompts(cfg)
    greedy = prompts[:3]
    sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
    res = {"model": "llama3-8b", "card": card, "tp": 2,
           "devices": [str(d) for d in mesh.devices],
           "pages": TP_PAGES}
    step_rng = np.random.default_rng(SEED + 24)
    step_prompts = [step_rng.integers(0, cfg.vocab, n).tolist()
                    for n in TP_STEP_LENS]
    noise = {}
    for name, m, kv in (("bf16", mesh, "bf16"), ("int8", mesh, "int8"),
                        ("tp_sp", mesh4, "bf16")):
        c = dataclasses.replace(cfg, kv_dtype=kv)
        b, run = _tp_serve(torch, params, c, m, prompts, sampled)
        n_shards = len(m.devices)
        kind = ("_int8" if kv == "int8" else "") + (
            "_striped" if name == "tp_sp" else "")
        mine = (f"launches{kind}", f"launches_decode{kind}")
        got = run["launches"]
        check(got[mine[0]] + got[mine[1]]
              == n_shards * cfg.n_layers * run["forwards"]
              and run["forwards"] > 0 and got[mine[0]] > 0
              and got[mine[1]] >= n_shards * cfg.n_layers
              * run["decode_steps"],
              f"tp {name}: K2 {got} for {run['forwards']} forwards "
              f"({run['decode_steps']} decode steps)")
        check(all(n == 0 for k, n in got.items() if k not in mine),
              f"tp {name}: another K2 entry point ran: {got}")
        check(run["launch_heads"] == {"16q/4kv": got[mine[0]]
                                      + got[mine[1]]},
              f"tp {name}: K2 launched at {run['launch_heads']}")
        if name != "tp_sp":
            ref = PagedContinuousBatcher(params, c, n_slots=8, page_size=16,
                                         n_pages=TP_PAGES, device="cuda")
            noise_b = PagedContinuousBatcher(
                params, dataclasses.replace(c, attn_kernel="gather"),
                n_slots=8, page_size=16, n_pages=TP_PAGES, device="cuda")
            noise[kv] = (ref, noise_b)
        ref, noise_b = noise[kv]
        run["logits"] = _tp_logits(torch, b, ref, noise_b, greedy)
        check(max(run["logits"]["max_abs_err"]) <= run["logits"]["limit"],
              f"tp {name}: logits {run['logits']} past the limit")
        if name == "bf16":
            mark("bf16_load_and_logits")
            res["step"] = {"tp2": _step_profile(b, step_prompts, steps=4),
                           "tp1": _step_profile(ref, step_prompts,
                                                steps=4)}
        res[name] = run
        mark(name)
        del b
        if name == "int8":
            del noise["int8"], ref, noise_b
        gc.collect()
        torch.cuda.empty_cache()
    bound = res["bf16"]["logits"]["limit"]
    del noise
    gc.collect()
    torch.cuda.empty_cache()

    dense = ContinuousBatcher(params, cfg, n_slots=2, mesh=mesh)
    check(len(dense.caches) == 2 and transformer._kv_leaf(
        dense.caches[0][0]).shape[2] == 4, "tp: dense rows not split")
    got = _first_logits(dense, greedy)
    del dense
    dref = ContinuousBatcher(params, cfg, n_slots=2, device="cuda")
    want = _first_logits(dref, greedy)
    del dref
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    check(max(errs) <= bound, f"tp dense: first-step logits {errs} past "
                              f"{bound}")
    res["dense"] = {"max_abs_err": errs, "limit": bound}
    mark("dense")
    gc.collect()
    torch.cuda.empty_cache()

    split = shard_params(params, mesh, cfg)
    tokens = torch.tensor([step_prompts[-1][:TP_FORWARD_LEN]],
                          device="cuda")
    with torch.inference_mode():
        _zero_launch_counts()
        with _launch_heads() as heads:
            got = transformer.forward(split, tokens, cfg, mesh=mesh)
            torch.cuda.synchronize()
        k1 = attn.flash_attention_lse.launches
        want = transformer.forward(params, tokens, cfg)
        err = (got - want).abs().max().item()
        # the bf16 noise of this forward over the same 2000 positions: its
        # attention through the reference instead of K1
        use_flash = attn.use_flash
        attn.use_flash = lambda q, k: False
        try:
            gap = (transformer.forward(params, tokens, cfg)
                   - want).abs().max().item()
        finally:
            attn.use_flash = use_flash
    limit = max(LOGIT_TOL, 1.25 * gap)
    check(k1 == 2 * cfg.n_layers and dict(heads["k1"]) == {(16, 4): k1},
          f"tp forward: K1 {k1} launches at {dict(heads['k1'])}")
    check(torch.isfinite(got).all().item() and err <= limit,
          f"tp forward: logits {err} from tp = 1, past {limit}")
    res["forward"] = {"S": TP_FORWARD_LEN, "k1_launches": k1,
                      "max_abs_err": err, "k1_vs_reference_max_abs_err": gap,
                      "limit": limit}
    del split, got, want, params
    mark("forward")
    res["part_s"] = parts
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the tp_quant phase's QLoRA: an int8 base at Llama-3-8B's widths and
#: TP_QLORA_LAYERS of its layers, rank TP_QLORA_RANK, TP_QLORA_STEPS steps
#: on one row of TP_QLORA_SEQ tokens; its first loss within TP_QLORA_RTOL
#: of the tp = 1 step's
TP_QLORA_LAYERS = 16
TP_QLORA_RANK = 8
TP_QLORA_STEPS = 2
TP_QLORA_SEQ = 2049
TP_QLORA_LR = 1e-3
TP_QLORA_RTOL = 1e-4


def _codes_bytes(torch, layers) -> int:
    """The bytes of the int8 / int4 codes (``q``, ``q4``) of every
    projection of a layers tree (a stacked tree, or one tp tree)."""
    from tpushare_torch.models import transformer

    total = 0
    for name in transformer.TP_COL_LEAVES + transformer.TP_ROW_LEAVES:
        leaf = layers[name]
        codes = leaf["q4"] if "q4" in leaf else leaf["q"]
        total += codes.numel() * codes.element_size()
    return total


def _dequantized4(params, dtype):
    """An int4 tree's every ``{"q4","s"}`` leaf widened by ``dequantize4``
    to a ``dtype`` tensor: the same codes as a plain model."""
    from tpushare_torch.ops import quant

    def visit(leaf):
        if isinstance(leaf, dict) and "q4" in leaf:
            return quant.dequantize4(leaf, dtype=dtype)
        if isinstance(leaf, dict):
            return {k: visit(v) for k, v in leaf.items()}
        return leaf

    return visit(params)


def _tp_quant_qlora(torch) -> dict:
    """QLoRA on ``{"tp": 2}``: the int8 base at Llama-3-8B's widths and
    TP_QLORA_LAYERS layers, loraized at rank TP_QLORA_RANK, laid out by
    ``shard_params`` (every projection's codes split by the reference's
    rule), ``make_lora_train_step(mesh=, remat="layer")`` for
    TP_QLORA_STEPS steps on one seeded row of TP_QLORA_SEQ tokens: the
    first loss within TP_QLORA_RTOL of the tp = 1 step's first loss on
    the same adapters, the losses falling, every base leaf bit-unchanged,
    K1 / K3 / K4 2 x TP_QLORA_LAYERS a step (once a layer and tp shard:
    the remat's recompute keeps K1's saved output); each step's wall and
    the peak memory."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import lora
    from tpushare_torch.parallel import mesh as pmesh
    from tpushare_torch.parallel.train import make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=TP_QLORA_LAYERS)
    mesh = pmesh.make_mesh({"tp": 2}, devices=["cuda:0"] * 2)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 25).integers(
        0, cfg.vocab, (1, TP_QLORA_SEQ))).to("cuda")
    lp = lora.loraize_params(tf.init_params(cfg, seed=SEED, device="cuda",
                                            quantize_bits=8),
                             rank=TP_QLORA_RANK, seed=SEED)
    adapters, frozen = lora.partition(lp)
    start = {k: v.clone() for k, v in adapters.items()}
    one = make_optimizer(lr=TP_QLORA_LR)
    with _k134_counted([0, 0, 0]) as flat_launches:
        _, _, flat = lora.make_lora_train_step(cfg, one, remat="layer")(
            lp, one.init(adapters), tokens)
        flat = flat.item()
    del lp, adapters
    placed = pmesh.shard_params(lora.combine(start, frozen), mesh, cfg)
    check(tf.tp_splits(placed["layers"], cfg, 2)
          and "q" in placed["layers"][1]["wo"],
          "tp_quant qlora: the int8 base did not take the tp split")
    base = []
    lora._map_tensors(lambda path, t: base.append(t)
                      if not lora._is_adapter(path) else t, placed)
    base = list({id(t): t for t in base}.values())
    before = [t.clone() for t in base]
    opt = make_optimizer(lr=TP_QLORA_LR)
    state = opt.init(lora.placed_adapters(placed))
    step = lora.make_lora_train_step(cfg, opt, remat="layer", mesh=mesh)
    losses, walls, per_step = [], [], []
    for _ in range(TP_QLORA_STEPS):
        with _k134_counted([0, 0, 0]) as got:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            placed, state, loss = step(placed, state, tokens)
            losses.append(loss.item())
            walls.append(time.perf_counter() - t0)
        per_step.append(list(got))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    unchanged = all(torch.equal(a, b) for a, b in zip(before, base))
    del placed, state, base, before, frozen, start
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(losses[0] - flat) / abs(flat)
    check(rel <= TP_QLORA_RTOL,
          f"tp_quant qlora: first loss {losses[0]!r} is {rel:.3g} from the "
          f"tp = 1 step's {flat!r}")
    check(all(np.isfinite(losses)) and all(
        b < a for a, b in zip(losses, losses[1:])),
          f"tp_quant qlora: losses {losses} do not fall")
    check(unchanged, "tp_quant qlora: a base leaf moved")
    n = cfg.n_layers
    check(list(flat_launches) == [n] * 3,
          f"tp_quant qlora: K1/K3/K4 {list(flat_launches)} in the tp = 1 "
          f"step, not {n}")
    check(all(c == [2 * n] * 3 for c in per_step),
          f"tp_quant qlora: K1/K3/K4 a step {per_step}, not {2 * n}")
    return {"layers": n, "rank": TP_QLORA_RANK, "lr": TP_QLORA_LR,
            "seq": TP_QLORA_SEQ, "tp1_first_loss": flat, "losses": losses,
            "first_loss_rel_err": rel, "step_walls_s": walls,
            "peak_memory_gb": peak_gb,
            "launches_per_step": {"flash_fwd": per_step[0][0],
                                  "flash_bwd_dkv": per_step[0][1],
                                  "flash_bwd_dq": per_step[0][2]},
            "launches": {k: sum(c[i] for c in per_step) for i, k in
                         enumerate(("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq"))}}


def phase_tp_quant(torch, card: str):
    """Quantized weights split over tp: Llama-3-8B at full width and depth
    with int8, then grouped int4, weights on ``make_mesh({"tp": 2},
    devices=["cuda:0"] * 2)``.  For each: every tp tree's projection
    codes exactly half of the whole tree's bytes (counted from the
    tensors); the server phase's four requests through a
    ``ContinuousService`` over a bf16 pool (``_tp_serve``), K2 twice a
    layer of every paged forward, both arms, every launch at 16 q and 4
    kv heads; the greedy prompts' first-step and first decode-step
    logits held to a tp = 1 pool on the same weights within LOGIT_TOL or
    1.25x that pool's own K2-against-gather distance; the 8-row decode
    step at TP_STEP_LENS at tp = 2 and tp = 1 (wall, busy, ops; no bar).
    Int4 at tp = 1 is also held to a bf16 model of ``dequantize4`` of the
    same codes, within LOGIT_TOL or 1.25x that model's own distance.
    Then QLoRA on tp (``_tp_quant_qlora``)."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.mesh import make_mesh, shard_params
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    t0 = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    mesh = make_mesh({"tp": 2}, devices=["cuda:0"] * 2)
    res = {"model": "llama3-8b", "card": card, "tp": 2,
           "devices": [str(d) for d in mesh.devices], "pages": TP_PAGES}
    sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
    for bits in (8, 4):
        kind = f"int{bits}"
        cfg, params = build_model("llama3-8b", seed=SEED, device="cuda",
                                  quantize_int8=bits == 8,
                                  quantize_int4=bits == 4)
        _check_llama3_8b(cfg)
        check(transformer.tp_splits(params["layers"], cfg, 2),
              f"tp_quant {kind}: the model does not take the tp split")
        prompts, _ = _load_prompts(cfg)
        greedy = prompts[:3]
        step_prompts = [np.random.default_rng(SEED + 24).integers(
            0, cfg.vocab, n).tolist() for n in TP_STEP_LENS]
        whole = _codes_bytes(torch, params["layers"])
        trees = shard_params(params, mesh, cfg)["layers"]
        shard_bytes = [_codes_bytes(torch, tree) for tree in trees]
        del trees
        check(all(2 * b == whole for b in shard_bytes),
              f"tp_quant {kind}: codes {shard_bytes} a tp tree against "
              f"{whole} whole")
        b, run = _tp_serve(torch, params, cfg, mesh, prompts, sampled)
        got = run["launches"]
        mine = ("launches", "launches_decode")
        check(got[mine[0]] + got[mine[1]] == 2 * cfg.n_layers
              * run["forwards"] and got[mine[0]] > 0
              and got[mine[1]] >= 2 * cfg.n_layers * run["decode_steps"],
              f"tp_quant {kind}: K2 {got} for {run['forwards']} forwards "
              f"({run['decode_steps']} decode steps)")
        check(all(n == 0 for k, n in got.items() if k not in mine),
              f"tp_quant {kind}: another K2 entry point ran: {got}")
        check(run["launch_heads"] == {"16q/4kv": got[mine[0]]
                                      + got[mine[1]]},
              f"tp_quant {kind}: K2 launched at {run['launch_heads']}")
        run["codes_bytes"] = {"whole": whole, "per_tp_tree": shard_bytes}
        ref = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                     n_pages=TP_PAGES, device="cuda")
        noise_b = PagedContinuousBatcher(
            params, dataclasses.replace(cfg, attn_kernel="gather"),
            n_slots=8, page_size=16, n_pages=TP_PAGES, device="cuda")
        run["logits"] = _tp_logits(torch, b, ref, noise_b, greedy,
                                   f"tp_quant {kind}")
        check(max(run["logits"]["max_abs_err"]) <= run["logits"]["limit"],
              f"tp_quant {kind}: logits {run['logits']} past the limit")
        del noise_b
        mark(f"{kind}_load_and_logits")
        run["step"] = {"tp2": _step_profile(b, step_prompts, steps=4),
                       "tp1": _step_profile(ref, step_prompts, steps=4)}
        del b
        mark(f"{kind}_step")
        if bits == 4:
            gc.collect()
            torch.cuda.empty_cache()
            dq = _dequantized4(params, cfg.dtype)
            dq_b = PagedContinuousBatcher(dq, cfg, n_slots=8, page_size=16,
                                          n_pages=TP_PAGES, device="cuda")
            dq_gather = PagedContinuousBatcher(
                dq, dataclasses.replace(cfg, attn_kernel="gather"),
                n_slots=8, page_size=16, n_pages=TP_PAGES, device="cuda")
            run["vs_dequantized"] = _tp_logits(
                torch, ref, dq_b, dq_gather, greedy, "tp_quant int4 tp 1")
            check(max(run["vs_dequantized"]["max_abs_err"])
                  <= run["vs_dequantized"]["limit"],
                  f"tp_quant int4: tp = 1 logits "
                  f"{run['vs_dequantized']} from the dequantized model")
            del dq, dq_b, dq_gather
            mark("int4_vs_dequantized")
        res[kind] = run
        del ref, params
        gc.collect()
        torch.cuda.empty_cache()
    res["qlora"] = _tp_quant_qlora(torch)
    mark("qlora")
    res["part_s"] = parts
    return res


#: the pp phase: Llama-3-8B's 32 layers on two stages of one card, the
#: server load through three meshes, a migration across depths (a prompt
#: of MIGRATE_LENS[2] tokens, PP_MIGRATE_STEPS staged steps), the
#: pipelined forward on PP_FORWARD_ROWS prompts of TP_FORWARD_LEN tokens,
#: its gradient at PP_GRAD_LAYERS layers and PP_GRAD_SEQ tokens, and a
#: decode step of PP_STEP_ROWS rows at PP_STEP_LEN tokens at pp = 1, 2, 4
#: and pp = 2 x tp = 2
PP_MIGRATE_STEPS = 9
PP_FORWARD_ROWS = 2
PP_GRAD_LAYERS = 2
PP_GRAD_SEQ = 2048
PP_STEP_ROWS = 8
PP_STEP_LEN = 2000
PP_STEP_PAGES = 1040


def _pp_fields(cfg, pp: int, n_micro: int, pool_bytes: int) -> dict:
    """``storage_info``'s pp fields as the reference's formula gives them
    (``tpushare/serving/continuous.py`` ``_pp_storage_info``), written out
    here: equal layer slabs, the pool split by stage, the bubble
    (pp - 1) / (n_micro + pp - 1)."""
    per = cfg.n_layers // pp
    return {"pp_stages": pp, "pool_bytes_per_stage": pool_bytes // pp,
            "stage_layer_ranges": [[s * per, (s + 1) * per]
                                   for s in range(pp)],
            "pp_fallback_reason": None, "pp_microbatches": n_micro,
            "pp_bubble_fraction": (pp - 1) / (n_micro + pp - 1)}


def _pp_migration(torch, params, cfg, mesh, prompt) -> dict:
    """One greedy session of ``prompt`` on a pp = 2 pool and a pp = 1
    pool: its blobs at activation and after PP_MIGRATE_STEPS staged steps
    byte-equal across the depths, and the pp = 2 blob resumed in a fresh
    pp = 1 pool token-equal to the pp = 1 pool's uninterrupted stream."""
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    def pool(**kw):
        return PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                      n_pages=TP_PAGES, **kw)

    blobs, streams = {}, {}
    for name, kw in (("pp1", dict(device="cuda")),
                     ("pp2", dict(mesh=mesh, pp=2))):
        b = pool(**kw)
        rid = b.admit(prompt, MIGRATE_NEW)
        check(rid is not None, f"pp migrate: {name} admission")
        blobs[name, "activation"] = b.export_session(rid)
        for _ in range(PP_MIGRATE_STEPS):
            b.tick()
        blobs[name, "steps"] = b.export_session(rid)
        b.run_until_drained()
        streams[name] = b.completed[rid]
        del b
    dst = pool(device="cuda")
    rid = dst.import_session(blobs["pp2", "steps"])
    check(rid is not None, "pp migrate: the pp = 1 pool refused the blob")
    dst.run_until_drained()
    resumed = dst.completed[rid]
    del dst
    same = {at: blobs["pp1", at] == blobs["pp2", at]
            for at in ("activation", "steps")}
    check(all(same.values()), f"pp migrate: blobs across depths {same}")
    check(resumed == streams["pp1"],
          "pp migrate: the resumed pp = 2 session left the pp = 1 stream")
    return {"prompt": len(prompt), "steps": PP_MIGRATE_STEPS,
            "blob_bytes": len(blobs["pp2", "steps"]),
            "byte_equal": same, "resumed_equal": True,
            "pp2_stream_equal_pp1": streams["pp2"] == streams["pp1"]}


def _pp_forward(torch, params, cfg, mesh, prompts) -> dict:
    """``forward_pipelined`` on two prompts (n_micro 2) against the flat
    ``forward``: K1 once a (stage, microbatch, layer), the logits at every
    position within LOGIT_TOL or 1.25x the flat forward's distance from
    itself on the reference attention."""
    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn

    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        _zero_launch_counts()
        with _launch_heads() as heads:
            got = transformer.forward_pipelined(params, tokens, cfg, mesh,
                                                n_micro=len(prompts))
            torch.cuda.synchronize()
        k1 = attn.flash_attention_lse.launches
        want = transformer.forward(params, tokens, cfg)
        err = (got - want).abs().max().item()
        del got
        use_flash = attn.use_flash
        attn.use_flash = lambda q, k: False
        try:
            gap = (transformer.forward(params, tokens, cfg)
                   - want).abs().max().item()
        finally:
            attn.use_flash = use_flash
        del want
    limit = max(LOGIT_TOL, 1.25 * gap)
    n = cfg.n_layers * len(prompts)
    check(k1 == n and dict(heads["k1"]) == {(32, 8): n},
          f"pp forward: K1 {k1} launches at {dict(heads['k1'])}, not {n}")
    check(err <= limit, f"pp forward: logits {err} from the flat forward, "
                        f"past {limit}")
    return {"B": len(prompts), "S": len(prompts[0]), "n_micro": len(prompts),
            "k1_launches": k1, "max_abs_err": err,
            "k1_vs_reference_max_abs_err": gap, "limit": limit}


def _pp_grads(torch, cfg, mesh) -> dict:
    """The LM loss and every leaf's gradient through ``forward_pipelined``
    at PP_GRAD_LAYERS layers of ``cfg``'s widths (one a stage) and two
    rows of PP_GRAD_SEQ tokens (n_micro 2) against the flat forward's:
    the loss within LSE_TOL relative, each leaf's gradient within
    BWD_TOL of its largest magnitude; K1, K3, K4 once a (stage,
    microbatch, layer).  Beside them, for scale, the flat model's own on
    the reference attention."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.ops import attention as attn

    c2 = dataclasses.replace(cfg, n_layers=PP_GRAD_LAYERS)
    params = transformer.init_params(c2, seed=SEED, device="cuda")
    names, leaves = [], []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                names.append(prefix + key)
                leaves.append(val.requires_grad_(True))

    walk(params, "")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 41).integers(
        0, cfg.vocab, (2, PP_GRAD_SEQ + 1)), device="cuda")

    def loss_and_grads(forward):
        logits = forward(params, tokens[:, :-1], c2)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, tokens[:, 1:, None])[..., 0].mean()
        del logits, logp
        return loss.detach(), torch.autograd.grad(loss, leaves)

    want_loss, want = loss_and_grads(transformer.forward)
    use_flash = attn.use_flash
    attn.use_flash = lambda q, k: False
    try:
        ref_loss, ref = loss_and_grads(transformer.forward)
    finally:
        attn.use_flash = use_flash
    noise = max(_rel_err(r, w) for r, w in zip(ref, want))
    del ref
    tally = [0, 0, 0]
    with _k134_counted(tally) as got:
        loss, grads = loss_and_grads(
            lambda p, t, c: transformer.forward_pipelined(p, t, c, mesh,
                                                          n_micro=2))
        torch.cuda.synchronize()
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    rel = {name: _rel_err(gr, wg)
           for name, gr, wg in zip(names, grads, want)}
    n = PP_GRAD_LAYERS * 2
    check(np.isfinite(loss.item()) and loss_err <= LSE_TOL,
          f"pp grads: loss {loss.item()} against {want_loss.item()}")
    check(all(_all_finite(torch, gr) for gr in grads)
          and max(rel.values()) <= BWD_TOL,
          f"pp grads: relative errors {rel} past {BWD_TOL}")
    check(got == [n, n, n], f"pp grads: K1/K3/K4 {got}, not {n} each")
    worst = max(rel, key=rel.get)
    del params, leaves, grads, want
    return {"S": PP_GRAD_SEQ, "B": 2, "layers": PP_GRAD_LAYERS,
            "loss": loss.item(), "flat_loss": want_loss.item(),
            "loss_rel_err": loss_err, "grad_rel_err": rel,
            "worst_leaf": worst, "max_grad_rel_err": rel[worst],
            "k1_vs_reference_loss_rel_err": abs(
                ref_loss.item() - want_loss.item()) / abs(want_loss.item()),
            "k1_vs_reference_max_grad_rel_err": noise,
            "launches": {"flash_fwd": got[0], "flash_bwd_dkv": got[1],
                         "flash_bwd_dq": got[2]}}


def phase_pp(torch, card: str):
    """Pipeline-parallel serving of Llama-3-8B at full width and depth on
    one card, its stages' shards repeated on it (``make_mesh({"pp": 2},
    devices=["cuda:0"] * 2)``).  The server phase's four requests through
    a ``ContinuousService`` over a bf16 pool on ``{"pp": 2}``, ``{"tp": 2,
    "pp": 2}`` and ``{"sp": 2, "pp": 2}``, the launch counters zeroed just
    before each load and read just after: K2 n_layers x shards a prefill
    forward and n_layers x n_micro x shards a staged decode step (no
    bubble launch), every decode launch at 8 / n_micro rows and the
    shard's heads; the greedy prompts' first-step and first decode-step
    logits held to a pp = 1 pool within LOGIT_TOL or 1.25x its
    K2-against-gather distance; ``storage_info``'s pp fields as the
    reference's formula gives them.  Then dense rows at pp = 2 against
    pp = 1, a session's blob across depths, ``forward_pipelined`` and its
    gradient against the flat forward, and a decode step of 8 rows at
    2000 tokens at pp = 1, 2, 4 and 2 x tp = 2 (wall, busy, ops)."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer
    from tpushare_torch.parallel.mesh import Staged, make_mesh
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    t0 = time.perf_counter()
    parts = {}

    def mark(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)

    def mesh_of(**axes):
        return make_mesh(axes, devices=["cuda:0"] * int(np.prod(
            list(axes.values()))))

    meshes = {"pp": mesh_of(pp=2), "tp_pp": mesh_of(tp=2, pp=2),
              "sp_pp": mesh_of(sp=2, pp=2)}
    prompts, _ = _load_prompts(cfg)
    greedy = prompts[:3]
    sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
    res = {"model": "llama3-8b", "card": card, "pp": 2, "pages": TP_PAGES}
    ref = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                 n_pages=TP_PAGES, device="cuda")
    noise_b = PagedContinuousBatcher(
        params, dataclasses.replace(cfg, attn_kernel="gather"), n_slots=8,
        page_size=16, n_pages=TP_PAGES, device="cuda")
    mark("setup")
    for name, mesh in meshes.items():
        b, run = _tp_serve(torch, params, cfg, mesh, prompts, sampled, pp=2)
        check(b._pp_staged and isinstance(b.pools, Staged),
              f"pp {name}: the batcher is not staged")
        shards = len(mesh.devices) // 2
        n_micro = b.pp_microbatches
        kind = "_striped" if name == "sp_pp" else ""
        got = run["launches"]
        dec, pre = got[f"launches_decode{kind}"], got[f"launches{kind}"]
        want_dec = cfg.n_layers * shards * n_micro * run["decode_steps"]
        check(dec + pre == cfg.n_layers * shards * (
            run["prefills"] + n_micro * run["decode_steps"])
              and dec >= want_dec and run["decode_steps"] > 0 and pre > 0,
              f"pp {name}: K2 {got} for {run['prefills']} prefills and "
              f"{run['decode_steps']} staged steps of {n_micro} "
              f"microbatches on {shards} shard(s)")
        check(all(n == 0 for k, n in got.items()
                  if k not in (f"launches{kind}", f"launches_decode{kind}")),
              f"pp {name}: another K2 entry point ran: {got}")
        heads = "16q/4kv" if name == "tp_pp" else "32q/8kv"
        check(run["launch_heads"] == {heads: dec + pre},
              f"pp {name}: K2 launched at {run['launch_heads']}")
        rows = {k: n for k, n in run["launch_rows"].items()
                if k.endswith("x1")}
        check(rows == {f"{8 // n_micro}x1": dec},
              f"pp {name}: decode launches at rows {run['launch_rows']}")
        info = {k: v for k, v in b.storage_info().items()
                if k.startswith("pp_") or k in ("stage_layer_ranges",
                                                "pool_bytes_per_stage")}
        want_info = _pp_fields(cfg, 2, n_micro, run["pool_bytes"])
        check(info == want_info, f"pp {name}: storage_info {info} is not "
                                 f"{want_info}")
        run["storage_info"] = info
        run["logits"] = _tp_logits(torch, b, ref, noise_b, greedy,
                                   what=f"pp {name}")
        check(max(run["logits"]["max_abs_err"]) <= run["logits"]["limit"],
              f"pp {name}: logits {run['logits']} past the limit")
        res[name] = run
        del b
        gc.collect()
        torch.cuda.empty_cache()
        mark(name)
    bound = res["pp"]["logits"]["limit"]
    del ref, noise_b
    gc.collect()
    torch.cuda.empty_cache()

    dense = ContinuousBatcher(params, cfg, n_slots=2, mesh=meshes["pp"],
                              pp=2)
    check(dense._pp_staged and isinstance(dense.caches, Staged)
          and [transformer._kv_leaf(k).shape[0] for k, _ in dense.caches]
          == [cfg.n_layers // 2] * 2, "pp: dense rows not staged")
    got = _first_logits(dense, greedy[:2])
    tokens = [int(g.argmax()) for g in got]
    got += _step_logits(dense, greedy[:2], tokens)
    del dense
    dref = ContinuousBatcher(params, cfg, n_slots=2, device="cuda")
    want = _first_logits(dref, greedy[:2])
    want += _step_logits(dref, greedy[:2], tokens)
    del dref
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    check(max(errs) <= bound, f"pp dense: logits {errs} past {bound}")
    res["dense"] = {"max_abs_err": errs, "limit": bound}
    gc.collect()
    torch.cuda.empty_cache()
    mark("dense")

    res["migrate"] = _pp_migration(torch, params, cfg, meshes["pp"],
                                   prompts[2])
    gc.collect()
    torch.cuda.empty_cache()
    mark("migrate")

    rng = np.random.default_rng(SEED + 42)
    res["forward"] = _pp_forward(torch, params, cfg, meshes["pp"], [
        rng.integers(0, cfg.vocab, TP_FORWARD_LEN).tolist()
        for _ in range(PP_FORWARD_ROWS)])
    gc.collect()
    torch.cuda.empty_cache()
    mark("forward")

    step_prompts = [rng.integers(0, cfg.vocab, PP_STEP_LEN).tolist()
                    for _ in range(PP_STEP_ROWS)]
    res["step"] = {}
    for name, kw in (("pp1", dict(device="cuda")),
                     ("pp2", dict(mesh=meshes["pp"], pp=2)),
                     ("pp4", dict(mesh=mesh_of(pp=4), pp=4)),
                     ("pp2_tp2", dict(mesh=meshes["tp_pp"], pp=2))):
        b = PagedContinuousBatcher(params, cfg, n_slots=PP_STEP_ROWS,
                                   page_size=16, n_pages=PP_STEP_PAGES, **kw)
        res["step"][name] = dict(_step_profile(b, step_prompts, steps=4),
                                 n_micro=b.pp_microbatches or 1)
        del b
        gc.collect()
        torch.cuda.empty_cache()
    mark("step")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["grads"] = _pp_grads(torch, cfg, meshes["pp"])
    gc.collect()
    torch.cuda.empty_cache()
    mark("grads")
    res["part_s"] = parts
    return res


#: the prefix phase's chat load: four conversations, each a 1,024-token
#: system prompt and a first user turn of its own length; the second turn
#: sends the first turn's prompt, its 32-token reply and a new 64-token
#: user turn, as a chat client resends the conversation
PREFIX_SYSTEM = 1024
PREFIX_TURNS = (64, 128, 192, 256)
PREFIX_FOLLOW_UP = 64
PREFIX_NEW = 32


def _chat_prompts(cfg):
    """The conversations' first-turn prompts and their second user
    turns."""
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    system = rng.integers(0, cfg.vocab, PREFIX_SYSTEM).tolist()
    firsts = [system + rng.integers(0, cfg.vocab, n).tolist()
              for n in PREFIX_TURNS]
    return firsts, [rng.integers(0, cfg.vocab, PREFIX_FOLLOW_UP).tolist()
                    for _ in PREFIX_TURNS]


def _post_all(port, prompts, n_new: int, vocab: int):
    """``prompts`` as concurrent ``/generate`` requests; returns each one's
    new tokens, checked for form, and the wall."""
    outs = [None] * len(prompts)

    def send(i):
        try:
            outs[i] = _post(port, "/generate",
                            {"tokens": [prompts[i]], "max_new_tokens": n_new})
        except Exception as e:      # reported below
            outs[i] = (None, repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    news = []
    for i, (code, body) in enumerate(outs):
        check(code == 200, f"chat request {i} failed: {body}")
        row = body["tokens"][0]
        check(row[:len(prompts[i])] == prompts[i]
              and len(row) == len(prompts[i]) + n_new
              and all(0 <= t < vocab for t in row),
              f"chat request {i}: malformed tokens (len {len(row)})")
        news.append(row[len(prompts[i]):])
    return news, wall


def _serve_chat(torch, cfg, params, prefix_cache: bool) -> dict:
    """The chat load through an ``LLMServer(n_slots=8, page_size=16)``
    over HTTP: the four conversations' first turns concurrently, then
    their second turns concurrently, 32 new tokens each.  The counters
    are zeroed just before the first turns and read just after the
    second."""
    from tpushare_torch.serving.llm import LLMServer, kernel_launches

    firsts, follow = _chat_prompts(cfg)
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    device="cuda", prefix_cache=prefix_cache).start()
    svc = srv._service
    try:
        _zero_launch_counts()
        replies, wall1 = _post_all(srv.port, firsts, PREFIX_NEW,
                                   cfg.vocab)
        mid = svc.snapshot()
        registry = svc.storage_info()
        seconds = [p + r + f for p, r, f in zip(firsts, replies, follow)]
        _, wall2 = _post_all(srv.port, seconds, PREFIX_NEW, cfg.vocab)
        launches = kernel_launches()
        snap = svc.snapshot()
        timings = list(svc.timings)
    finally:
        srv.stop()
    n = len(firsts)
    return {"prefix_cache": prefix_cache, "second_turns": seconds,
            "first_turns_wall_s": wall1, "second_turns_wall_s": wall2,
            "second_turns_tokens_per_s": PREFIX_NEW * n / wall2,
            "first_ttft_s": [t["ttft_s"] for t in timings[:n]],
            "second_ttft_s": [t["ttft_s"] for t in timings[n:]],
            "first_prefill_tokens": mid["prefill_tokens"],
            "second_prefill_tokens": snap["prefill_tokens"]
            - mid["prefill_tokens"],
            "rounds": snap["rounds"], "prefills": snap["prefills"],
            "admitted_whole": snap["admitted_whole"],
            "admitted_chunked": snap["admitted_chunked"],
            "decode_steps": snap["decode_steps"],
            "forwards": snap["prefills"] + snap["decode_steps"],
            "launches": launches, "registry_after_first_turns": {
                k: registry[k] for k in ("cached_prefixes", "cached_pages",
                                         "free_pages", "pool_bytes",
                                         "n_pages", "bytes_per_page")}}


def _chat_first_logits(b, firsts, seconds):
    """Each second turn's first-step logits through batcher ``b`` by
    ``admit_chunked`` and mixed rounds, after the first turns (one new
    token each; a prefix cache registers their prompts); returns (logits,
    the prompt tokens the second turns prefilled)."""
    _served_steps(b, firsts, 1, chunk=MIXED_CHUNK)
    before = b.prefill_tokens
    got = _served_steps(b, seconds, 1, chunk=MIXED_CHUNK)[1]
    return got, b.prefill_tokens - before


def phase_prefix(torch, card: str):
    """Llama-2-7B at full width and depth (bf16 random seeded weights;
    32 heads over 32 kv heads, so K2 at n_rep = 1) served with the prefix
    cache: ``LLMServer(n_slots=8, page_size=16, prefix_cache=True)``, the
    default pool of 8 x 256 pages + 1, serves the chat load
    (:func:`_serve_chat`) and again without the cache.  Checks: after the
    first turns the registry holds one prefix a conversation, its first
    prompt's pages; the second turns prefill only the reply and the new
    user turn (``/stats``' prefill tokens); K2 in every layer of every
    paged forward.  Then, through batchers, the second turns' first-step
    logits with the cache against without it, within LOGIT_TOL or 1.25x
    the pool's own K2-against-gather distance, and on the weights widened
    to f32 through the gather read within F32_LOGIT_TOL."""
    import dataclasses

    from tpushare_torch.models.transformer import param_count
    from tpushare_torch.ops.quant import kv_cache_bytes
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg, params = build_model("llama2-7b", seed=SEED, device="cuda")
    check(cfg.vocab == 32000 and cfg.d_model == 4096 and cfg.n_layers == 32
          and cfg.n_heads == cfg.n_kv_heads == 32 and cfg.d_ff == 11008
          and cfg.max_seq == 4096,
          "llama2-7b config is not full width and depth")
    firsts, _ = _chat_prompts(cfg)
    first_pages = sum(len(p) for p in firsts) // 16
    own = len(firsts) * (PREFIX_NEW + PREFIX_FOLLOW_UP)
    served = {}
    for cache in (True, False):
        served[cache] = _serve_chat(torch, cfg, params, cache)
        gc.collect()
        torch.cuda.empty_cache()
    res, plain = served[True], served[False]
    seconds = res.pop("second_turns")
    reg = res["registry_after_first_turns"]
    check(reg["cached_prefixes"] == len(firsts)
          and reg["cached_pages"] == first_pages,
          f"the registry after the first turns: {reg}")
    check(reg["n_pages"] == 8 * cfg.max_seq // 16 + 1
          and reg["bytes_per_page"] == kv_cache_bytes(cfg, 16),
          f"the pool: {reg}")
    check(res["first_prefill_tokens"] == plain["first_prefill_tokens"]
          == sum(len(p) for p in firsts),
          f"the first turns prefilled {res['first_prefill_tokens']} and "
          f"{plain['first_prefill_tokens']} tokens")
    check(res["second_prefill_tokens"] == own,
          f"the second turns prefilled {res['second_prefill_tokens']} "
          f"tokens, not their own {own}")
    check(plain["second_prefill_tokens"] == sum(len(p) for p in seconds),
          f"without the cache the second turns prefilled "
          f"{plain['second_prefill_tokens']} tokens")
    _check_k2_arms(res, "", cfg.n_layers)

    def pool(p, c, cache):
        return PagedContinuousBatcher(p, c, n_slots=8, page_size=16,
                                      n_pages=400, device="cuda",
                                      prefix_cache=cache)

    got, n_cached = _chat_first_logits(pool(params, cfg, True), firsts,
                                       seconds)
    want, n_plain = _chat_first_logits(pool(params, cfg, False), firsts,
                                       seconds)
    check(n_cached == own and n_plain == sum(len(p) for p in seconds),
          f"batcher prefill tokens {n_cached} (cache), {n_plain}")
    gather, _ = _chat_first_logits(
        pool(params, dataclasses.replace(cfg, attn_kernel="gather"), False),
        firsts, seconds)
    noise = [(g - w).abs().max().item() for g, w in zip(gather, want)]
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    tol = max(LOGIT_TOL, 1.25 * max(noise))
    check(all(torch.isfinite(g).all().item() for g in got),
          "prefix-cache logits not finite")
    check(max(errs) <= tol,
          f"first-step logits with the cache {errs} from without it, past "
          f"LOGIT_TOL and 1.25x the K2-against-gather distance {noise}")
    gc.collect()
    torch.cuda.empty_cache()
    p32 = _widened(params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attn_kernel="gather")
    got32, _ = _chat_first_logits(pool(p32, c32, True), firsts, seconds)
    want32, _ = _chat_first_logits(pool(p32, c32, False), firsts, seconds)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    err32 = [(g - w).abs().max().item() for g, w in zip(got32, want32)]
    check(max(err32) <= F32_LOGIT_TOL,
          f"f32 first-step logits with the cache {err32} from without it, "
          f"past {F32_LOGIT_TOL}")
    res.update({"model": "llama2-7b", "card": card,
                "params_b": param_count(params) / 1e9, "n_rep": 1,
                "system_tokens": PREFIX_SYSTEM, "turn_tokens": PREFIX_TURNS,
                "follow_up_tokens": PREFIX_FOLLOW_UP,
                "second_turn_tokens": [len(p) for p in seconds],
                "without_cache": {k: plain[k] for k in (
                    "first_turns_wall_s", "second_turns_wall_s",
                    "second_turns_tokens_per_s", "first_ttft_s",
                    "second_ttft_s", "second_prefill_tokens", "rounds",
                    "admitted_whole", "admitted_chunked")},
                "first_logit_max_abs_err": errs,
                "kernel_vs_gather_max_abs_err": noise, "logit_tol": tol,
                "f32_first_logit_max_abs_err": err32,
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the migrate phase: four greedy sessions and a sampled one on a batcher,
#: moved after MIGRATE_SPLIT decode steps; the spill tier's six requests
#: over a pool that holds two of them; the drain's four clients
MIGRATE_LENS = (100, 500, 1000, 2000)
MIGRATE_SAMPLED = 300
MIGRATE_NEW = 32
MIGRATE_SPLIT = 9
SPILL_PROMPT = 480
SPILL_REQUESTS = 6
DRAIN_LENS = (100, 300, 500, 800)
DRAIN_NEW = 128
#: the f32 drain's new tokens (an f32 step is slower: fewer still leave
#: the drain its sessions decoding)
DRAIN_F32_NEW = 48
#: the context bound of the f32 checks
F32_MAX_SEQ = 1024


def _migrate_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in MIGRATE_LENS + (MIGRATE_SAMPLED,)]
    spill = [rng.integers(0, cfg.vocab, SPILL_PROMPT).tolist()
             for _ in range(SPILL_REQUESTS)]
    drain = [rng.integers(0, cfg.vocab, n).tolist() for n in DRAIN_LENS]
    return prompts, spill, drain


def _admit_all(b, prompts):
    """The migrate phase's sessions admitted whole in slot order, the last
    one sampled (temperature 0.8, top-k 50, seed 7)."""
    rids = []
    for i, p in enumerate(prompts):
        kw = ({"temperature": 0.8, "top_k": 50, "seed": 7}
              if i == len(prompts) - 1 else {})
        rid = b.admit(p, MIGRATE_NEW, **kw)
        check(rid is not None, "migrate: admission refused")
        rids.append(rid)
    return rids


def _streams(b, rids):
    with _sampler_logits() as seen:
        while b.slots:
            b.tick()
    return [b.completed.pop(r) for r in rids], seen


def _moved_run(torch, make, prompts):
    """The sessions decoded MIGRATE_SPLIT steps on one batcher, exported
    together, popped, and imported in slot order into a second batcher on
    the same weights, which finishes them; returns the streams, each
    step's logits on the receiver, its K2 launches, the blobs and the
    export and import walls."""
    from tpushare_torch.serving.llm import kernel_launches

    a = make()
    rids = _admit_all(a, prompts)
    for _ in range(MIGRATE_SPLIT):
        a.tick()
    blobs, export_ms = [], []
    for rid in rids:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs.append(a.export_session(rid))
        export_ms.append((time.perf_counter() - t0) * 1e3)
        a.pop_session(rid)
    del a
    b = make()
    got, import_ms = [], []
    for blob in blobs:
        t0 = time.perf_counter()
        got.append(b.import_session(blob))
        torch.cuda.synchronize()
        import_ms.append((time.perf_counter() - t0) * 1e3)
    check(None not in got, "migrate: the receiver refused a session")
    _zero_launch_counts()
    streams, seen = _streams(b, got)
    return {"streams": streams, "logits": seen,
            "launches": kernel_launches(), "decode_steps": len(seen),
            "blobs": blobs, "export_ms": export_ms, "import_ms": import_ms}


def _migrate_exactness(torch, params, cfg, prompts) -> dict:
    """(a) and (b): on a bf16 and an int8 pool, the sessions' streams and
    first decode step after the move against the uninterrupted run; the
    blobs' bytes a token and the export and import rates."""
    import dataclasses

    from tpushare_torch.serving.paged import PagedContinuousBatcher

    out = {}
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_dtype=kv)

        def make(c=c):
            return PagedContinuousBatcher(params, c, n_slots=len(prompts),
                                          page_size=16, n_pages=300,
                                          device="cuda")

        ref = make()
        rids = _admit_all(ref, prompts)
        want, want_logits = _streams(ref, rids)
        del ref
        moved = _moved_run(torch, make, prompts)
        n = len(prompts)
        step_err = (moved["logits"][0][:n]
                    - want_logits[MIGRATE_SPLIT][:n]).abs().max().item()
        check(step_err <= LOGIT_TOL,
              f"migrate {kv}: the first step after the move {step_err} "
              f"from the uninterrupted run's, past LOGIT_TOL")
        check(moved["streams"] == want,
              f"migrate {kv}: the moved streams differ from the "
              f"uninterrupted run's")
        kind = "_int8" if kv == "int8" else ""
        dec = moved["launches"][f"paged_decode{kind}"]
        check(dec >= cfg.n_layers * moved["decode_steps"]
              and moved["decode_steps"] > 0,
              f"migrate {kv}: K2's decode arm launched {dec} times for "
              f"{moved['decode_steps']} decode steps on the imported "
              f"sessions")
        # the 2000-token session, its committed length at the move
        longest = MIGRATE_LENS.index(max(MIGRATE_LENS))
        blob = moved["blobs"][longest]
        tokens = max(MIGRATE_LENS) + MIGRATE_SPLIT
        nbytes = len(blob)
        out[kv] = {
            "first_step_max_abs_err": step_err,
            "streams_equal": True, "sampled_equal": True,
            "decode_steps": moved["decode_steps"],
            "launches": moved["launches"],
            "blob_bytes": [len(b) for b in moved["blobs"]],
            "longest_blob_bytes": nbytes,
            "bytes_per_token": nbytes / tokens,
            "export_ms": moved["export_ms"][longest],
            "import_ms": moved["import_ms"][longest],
            "export_gb_s": nbytes / moved["export_ms"][longest] / 1e6,
            "import_gb_s": nbytes / moved["import_ms"][longest] / 1e6}
        del moved
        gc.collect()
        torch.cuda.empty_cache()
    ratio = out["int8"]["longest_blob_bytes"] / out["bf16"][
        "longest_blob_bytes"]
    check(ratio <= 0.55, f"migrate: the int8 blob is {ratio:.3f} of the "
                         f"bf16 blob's bytes, past 0.55")
    # the reckoning: 2 (K, V) x layers x kv heads x head_dim x 2 bytes a
    # token in bf16, the int8 store's values and f32 scales
    out["bf16_reckoned_bytes_per_token"] = (2 * cfg.n_layers
                                            * cfg.n_kv_heads
                                            * cfg.head_dim * 2)
    out["int8_reckoned_bytes_per_token"] = (2 * cfg.n_layers
                                            * cfg.n_kv_heads
                                            * (cfg.head_dim + 4))
    out["int8_over_bf16"] = ratio
    return out


def _migrate_striped(torch, params, cfg, prompt) -> dict:
    """One bf16 session from an unstriped pool into a pool of 2 stripes:
    its first step's logits there against an unstriped receiver's, within
    LOGIT_TOL or 1.25x the unstriped pool's own K2-against-gather
    distance."""
    import dataclasses

    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    a = PagedContinuousBatcher(params, cfg, n_slots=1, page_size=16,
                               n_pages=300, device="cuda")
    rid = a.admit(prompt, MIGRATE_NEW)
    for _ in range(MIGRATE_SPLIT):
        a.tick()
    blob = a.export_session(rid)
    del a
    mesh = make_mesh({"sp": 2}, devices=["cuda:0", "cuda:0"])
    logits = {}
    for name, c, kw in (
            ("striped", cfg, {"mesh": mesh}),
            ("unstriped", cfg, {"device": "cuda"}),
            ("gather", dataclasses.replace(cfg, attn_kernel="gather"),
             {"device": "cuda"})):
        b = PagedContinuousBatcher(params, c, n_slots=1, page_size=16,
                                   n_pages=300, **kw)
        check(b.import_session(blob) is not None,
              f"migrate: the {name} pool refused the session")
        with _sampler_logits() as seen:
            b.tick()
        logits[name] = seen[0][0]
        del b
    err = (logits["striped"] - logits["unstriped"]).abs().max().item()
    noise = (logits["gather"] - logits["unstriped"]).abs().max().item()
    check(err <= max(LOGIT_TOL, 1.25 * noise),
          f"migrate: the striped receiver's first step {err} from the "
          f"unstriped one's, past LOGIT_TOL and 1.25x {noise}")
    return {"first_step_max_abs_err": err,
            "unstriped_kernel_vs_gather_max_abs_err": noise}


def _restore_stats():
    from tpushare_torch import telemetry

    parsed = telemetry.parse_text(telemetry.REGISTRY.render())
    s = parsed["samples"]
    get = (lambda k: sum(v for _, v in s.get(k, ())))
    return (get("tpushare_spill_restore_seconds_sum"),
            get("tpushare_spill_restore_seconds_count"))


def _spill_run(torch, params, cfg, prompts, spill_bytes) -> dict:
    """The six requests at once through a ``ContinuousService`` whose pool
    holds two of them, with the spill tier of ``spill_bytes`` (or
    without); the peak admitted (decoding, prefilling and spilled) by a
    watcher thread."""
    from tpushare_torch.serving.continuous import ContinuousService
    from tpushare_torch.serving.llm import kernel_launches

    pages = -(-(SPILL_PROMPT + MIGRATE_NEW) // 16)
    svc = ContinuousService(params, cfg, 8, page_size=16,
                            n_pages=2 * pages + 1,
                            spill_bytes=spill_bytes).start()
    peak, halt = [0], threading.Event()

    def watch():
        while not halt.is_set():
            s = svc.snapshot()
            peak[0] = max(peak[0], s["active"] + s["prefilling"]
                          + s.get("spilled", 0))
            time.sleep(0.001)

    sum0, cnt0 = _restore_stats()
    w = threading.Thread(target=watch)
    w.start()
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        sinks = [svc.submit(p, MIGRATE_NEW) for p in prompts]
        outs = [s.get(timeout=600) for s in sinks]
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        snap = svc.snapshot()
    finally:
        halt.set()
        w.join()
        svc.stop()
    sum1, cnt1 = _restore_stats()
    for i, o in enumerate(outs):
        check(isinstance(o, list) and o[:SPILL_PROMPT] == prompts[i]
              and len(o) == SPILL_PROMPT + MIGRATE_NEW,
              f"spill: request {i} came back {str(o)[:200]}")
    restores = int(cnt1 - cnt0)
    return {"streams": outs, "peak_admitted": peak[0], "wall_s": wall,
            "restores": restores,
            "restore_ms": (1e3 * (sum1 - sum0) / restores if restores
                           else None),
            "launches": launches, "decode_steps": snap["decode_steps"],
            "forwards": snap["prefills"] + snap["decode_steps"]}


def _alone_streams(params, cfg, prompts):
    """Each request run alone on a batcher of the service's 8 slots."""
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    b = PagedContinuousBatcher(params, cfg, 8, page_size=16, n_pages=80,
                               device="cuda")
    out = []
    for p in prompts:
        rid = b.admit(p, MIGRATE_NEW)
        while b.slots:
            b.tick_fused(8)
        out.append(b.completed.pop(rid))
    return out


def _migrate_spill(torch, params, cfg, prompts) -> dict:
    """(c): the spill tier of four sessions' bytes over a pool of two, in
    bf16 on K2, against the same load without it."""
    from tpushare_torch.ops.quant import kv_cache_bytes

    pages = -(-(SPILL_PROMPT + MIGRATE_NEW) // 16)
    budget = 4 * pages * kv_cache_bytes(cfg, 16)
    res = {"budget_bytes": budget, "pool_pages": 2 * pages + 1}
    plain = _spill_run(torch, params, cfg, prompts, None)
    spill = _spill_run(torch, params, cfg, prompts, budget)
    check(spill["peak_admitted"] >= 2 * plain["peak_admitted"]
          and spill["restores"] > 0,
          f"spill: peak admitted {spill['peak_admitted']} against "
          f"{plain['peak_admitted']} without, {spill['restores']} "
          f"restores")
    _check_k2_arms(spill, "", cfg.n_layers)
    res.update({k: spill[k] for k in ("peak_admitted", "restores",
                                      "restore_ms", "wall_s", "launches",
                                      "decode_steps")})
    res["without_spill"] = {k: plain[k] for k in ("peak_admitted",
                                                  "wall_s")}
    return res


def _spill_f32(torch, p32, c32, prompts) -> dict:
    """(c) on the weights widened to f32 through the gather read: every
    stream through the spill tier equals the request's run alone."""
    from tpushare_torch.ops.quant import kv_cache_bytes

    pages = -(-(SPILL_PROMPT + MIGRATE_NEW) // 16)
    run = _spill_run(torch, p32, c32, prompts,
                     4 * pages * kv_cache_bytes(c32, 16))
    want = _alone_streams(p32, c32, prompts)
    check(run["streams"] == want and run["restores"] > 0,
          "spill: f32 streams through the spill tier differ from the "
          "requests' runs alone")
    return {"f32_streams_equal": True, "f32_restores": run["restores"]}


def _drain_load(torch, a, b, prompts, n_new: int) -> dict:
    """(d)'s load: the prompts as concurrent ``/generate`` of ``n_new``
    tokens on server A, ``/drain {"migrate_to": B}`` once A's ``/stats``
    shows them all decoding, every client's row back, A drained; A
    undrained after."""
    outs = [None] * len(prompts)

    def send(i):
        try:
            outs[i] = _post(a.port, "/generate",
                            {"tokens": [prompts[i]],
                             "max_new_tokens": n_new})
        except Exception as e:      # reported below
            outs[i] = (None, repr(e))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        stats = json.loads(_get(a.port, "/stats")[1])["batcher"]
        if stats["active"] == len(prompts):
            break
        time.sleep(0.005)
    code, drain = _post(a.port, "/drain",
                        {"migrate_to": f"127.0.0.1:{b.port}"})
    check(code == 200 and drain.get("migrating_to"),
          f"/drain migrate_to: {code} {drain}")
    for t in threads:
        t.join(timeout=900)
    rows = []
    for i, (code, body) in enumerate(outs):
        check(code == 200, f"drain: client {i} failed: {body}")
        row = body["tokens"][0]
        check(row[:len(prompts[i])] == prompts[i]
              and len(row) == len(prompts[i]) + n_new,
              f"drain: client {i}'s row is {len(row)} tokens")
        rows.append(row)
    health = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        health = json.loads(_get(a.port, "/healthz")[1])
        if health.get("drained"):
            break
        time.sleep(0.05)
    check(health.get("drained") is True,
          f"A's /healthz after the drain: {health}")
    _post(a.port, "/drain", {"undrain": True})
    return {"rows": rows, "healthz": health}


def _migrate_server(params, cfg):
    from tpushare_torch.serving.llm import LLMServer

    return LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                     n_pages=600, device="cuda").start()


def _migrate_servers(torch, params, cfg, prompts) -> dict:
    """(d): two ``LLMServer``s on one set of weights; the drain to B while
    A decodes; then a ``phase: "prefill"`` request on A whose blob B's
    ``/migrate_in`` finishes; B's ``/metrics`` shows the migration
    families moved."""
    from tpushare_torch import telemetry

    def fam(text, name, **labels):
        samples = telemetry.parse_text(text)["samples"].get(name, ())
        return sum(v for lab, v in samples
                   if all(lab.get(k) == x for k, x in labels.items()))

    a, b = [_migrate_server(params, cfg) for _ in range(2)]
    try:
        m0 = _get(b.port, "/metrics")[1]
        t0 = time.perf_counter()
        load = _drain_load(torch, a, b, prompts, DRAIN_NEW)
        drain_s = time.perf_counter() - t0
        handoff = {"untraced": _handoff(a, b, prompts[1], None)}
        fin = handoff["untraced"].pop("fin")
        handoff["traced"] = _handoff(a, b, prompts[1], True)
        handoff["traced"].pop("fin")
        m1 = _get(b.port, "/metrics")[1]
    finally:
        a.stop()
        b.stop()
    moved = (fam(m1, "tpushare_migrations_in_total", kind="import")
             - fam(m0, "tpushare_migrations_in_total", kind="import"))
    nbytes = (fam(m1, "tpushare_migration_bytes_total", direction="in")
              - fam(m0, "tpushare_migration_bytes_total", direction="in"))
    check(moved >= 2 and nbytes > 0,
          f"B's /metrics: {moved} imports, {nbytes} bytes in")
    return {"drain_s": drain_s, "imports_on_b": moved,
            "bytes_in_on_b": nbytes, "a_healthz": load["healthz"],
            "prefill_handoff_served_s": fin["served_s"],
            "handoff_trace": handoff}


def _handoff(a, b, prompt, traced) -> dict:
    """A ``phase: "prefill"`` request on A finished by B's
    ``/migrate_in``.  ``traced``: the request carries a fresh
    ``traceparent``, the blob's header ``trace`` is its id and every
    round span of B's import carries it (K2's decode arm ran in them);
    untraced: the header holds no trace and B's spans carry none."""
    from tpushare_torch.serving import migrate
    from tpushare_torch.serving.llm import kernel_launches
    from tpushare_torch.telemetry import propagation

    body = {"tokens": [prompt], "max_new_tokens": MIGRATE_NEW,
            "phase": "prefill"}
    ctx = propagation.new_context() if traced else None
    if ctx is not None:
        body = propagation.inject(body, ctx)
    code, pre = _post(a.port, "/generate", body)
    check(code == 200 and "migration" in pre,
          f"phase prefill: {code} {str(pre)[:200]}")
    meta = migrate.blob_meta(migrate.decode_blob(pre["migration"]))
    want = ctx.trace_id if ctx is not None else None
    check(migrate.session_trace(meta) == want,
          f"hand-off header trace {meta.get('trace')!r}, not {want!r}")
    seq = _trace_seq(b.port)
    _zero_launch_counts()
    code, fin = _post(b.port, "/migrate_in", {"blob": pre["migration"]})
    launches = kernel_launches()
    check(code == 200 and len(fin["tokens"][0])
          == len(prompt) + MIGRATE_NEW,
          f"/migrate_in: {code} {str(fin)[:200]}")
    spans = _batcher_spans(b.port, seq)
    check(spans and all(e["args"].get("traces") == ([want] if want else [])
                        for e in spans),
          f"B's spans after /migrate_in: {[e['args'] for e in spans][:4]}")
    check(launches["paged_decode"] > 0, f"B's import: K2 {launches}")
    return {"header_trace": meta.get("trace") is not None,
            "b_spans": len(spans), "paged_decode": launches["paged_decode"],
            "fin": fin}


def _drain_f32(torch, p32, c32, prompts) -> dict:
    """(d) on the weights widened to f32 through the gather read: the
    drain's streams, moved to B, equal the load's undrained run on A."""
    a, b = [_migrate_server(p32, c32) for _ in range(2)]
    try:
        drained = _drain_load(torch, a, b, prompts, DRAIN_F32_NEW)["rows"]
        undrained, _ = _post_all(a.port, prompts, DRAIN_F32_NEW, c32.vocab)
    finally:
        a.stop()
        b.stop()
    check([r[len(p):] for r, p in zip(drained, prompts)] == undrained,
          "drain: f32 streams moved to B differ from the undrained run")
    return {"f32_streams_equal": True}


def phase_migrate(torch, card: str):
    """The session lifecycle on Llama-3-8B at full width and depth (bf16
    random seeded weights): (a) four greedy sessions of 100-2000 tokens
    and a sampled one moved between two batchers after 9 decode steps on
    a bf16 and an int8 pool, the receiver's first step against the
    uninterrupted run's within LOGIT_TOL and the streams token-equal, K2's
    decode arm in every layer of the receiver's steps; one session into a
    pool of 2 stripes; (b) the blobs' bytes a token and the export and
    import rates, the int8 blob at most 0.55 of the bf16; (c) the spill
    tier over a pool of two sessions, six requests, peak admission at
    least twice the run without it, restores timed, in f32 through the
    gather read every stream equal to its run alone; (d) ``/drain
    {"migrate_to": B}`` between two servers while A decodes, a
    ``phase: "prefill"`` hand-off to B's ``/migrate_in``, and the drain
    in f32 equal to the undrained run.  The f32 checks bound the context
    at F32_MAX_SEQ tokens, past every prompt they serve: the gather read
    walks the whole page table, whose width max_seq sets."""
    import dataclasses

    from tpushare_torch.serving.llm import build_model

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    prompts, spill_prompts, drain_prompts = _migrate_prompts(cfg)
    res = {"model": "llama3-8b", "card": card, "lens": MIGRATE_LENS,
           "sampled_len": MIGRATE_SAMPLED, "split": MIGRATE_SPLIT}
    t0 = time.perf_counter()
    res["moved"] = _migrate_exactness(torch, params, cfg, prompts)
    res["striped"] = _migrate_striped(torch, params, cfg, prompts[2])
    t1 = time.perf_counter()
    res["spill"] = _migrate_spill(torch, params, cfg, spill_prompts)
    t2 = time.perf_counter()
    res["servers"] = _migrate_servers(torch, params, cfg, drain_prompts)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    p32 = _widened(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attn_kernel="gather",
                              max_seq=F32_MAX_SEQ)
    res["spill"].update(_spill_f32(torch, p32, c32, spill_prompts))
    gc.collect()
    torch.cuda.empty_cache()
    res["servers"].update(_drain_f32(torch, p32, c32, drain_prompts))
    res["part_s"] = {"moved": t1 - t0, "spill": t2 - t1,
                     "servers": t3 - t2, "f32": time.perf_counter() - t3}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the adapters phase: 8 rows of contexts 256-2000, 32 new tokens each,
#: over three synthetic rank-8 adapters and the base model
ADAPTER_LENS = (256, 500, 750, 1000, 1250, 1500, 1750, 2000)
ADAPTER_NEW = 32
ADAPTER_RANK = 8
ADAPTER_SLOTS = 4
ADAPTER_MIX = ("tenant-a", "tenant-b", "tenant-c", None) * 2
#: the server's residency check: four pinned adapters, then a fifth
ADAPTER_SERVER_NAMES = ("tenant-a", "tenant-b", "tenant-c", "tenant-d")
ADAPTER_FIFTH = "tenant-e"
ADAPTER_SERVER_NEW = 192
ADAPTER_TEXT = "The quick brown fox jumps over the lazy dog."
#: the adapters phase's pools: every row's pages at once
ADAPTER_PAGES = 640
#: the merged-weight check: the first adapter's rows (prompts 0 and 4)
#: against a plain f32 forward on W + s A B, within this multiple of the
#: base rows' distance on the same prompts from the f32 forward on W (an
#: adapter row rounds each target projection's output twice, y and then
#: y + delta, where a base row rounds it once)
ADAPTER_MERGED_ROWS = (0, 4)
ADAPTER_MERGED_SLACK = 2.0
#: the f32 forwards' context bound, past the longest of those prompts
ADAPTER_F32_MAX_SEQ = 2048
#: the decode steps timed, then profiled, of each arm of the step
#: profile (the profiler's own processing of 8 was ~20 s an arm)
ADAPTER_PROFILE_STEPS = 4


def _adapter_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(SEED + 41)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in ADAPTER_LENS]


def _adapter_run(b, prompts, adapters):
    """The prompts admitted whole in slot order, each with its adapter,
    greedy, then ticked to the end: (streams, each step's logits [B, V]
    as f32, each admission's first-step logits)."""
    firsts = []
    activate = b._activate

    def capture(slot, rid, prompt, logits_v, *rest):
        firsts.append(logits_v.float().clone())
        activate(slot, rid, prompt, logits_v, *rest)

    b._activate = capture
    try:
        rids = []
        for p, a in zip(prompts, adapters):
            rid = b.admit(p, ADAPTER_NEW, adapter=a)
            check(rid is not None, "adapters: an admission was refused")
            rids.append(rid)
        with _sampler_logits() as seen:
            while b.slots:
                b.tick()
    finally:
        b._activate = activate
    return [b.completed.pop(r) for r in rids], seen, firsts


def _adapter_batchers(params, cfg):
    from tpushare_torch.serving.continuous import ContinuousBatcher
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    def paged(**kw):
        return PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                      n_pages=ADAPTER_PAGES, device="cuda",
                                      **kw)

    def dense(**kw):
        return ContinuousBatcher(params, cfg, 8, device="cuda", **kw)

    return {"paged": paged, "dense": dense}


def _adapter_identity(torch, make, prompts) -> dict:
    """Base rows through a pool-carrying batcher against a pool-less one,
    on the paged pool and on dense rows: streams equal, every step's
    logits bit-equal."""
    out, base = {}, None
    for storage, mk in make.items():
        runs = []
        for kw in ({}, {"adapter_slots": ADAPTER_SLOTS,
                        "adapter_rank": ADAPTER_RANK}):
            b = mk(**kw)
            runs.append(_adapter_run(b, prompts, [None] * len(prompts)))
            del b
            gc.collect()
            torch.cuda.empty_cache()
        (s0, l0, f0), (s1, l1, f1) = runs
        err = max((a - c).abs().max().item()
                  for a, c in zip(l0 + f0, l1 + f1))
        check(s0 == s1, f"adapters: identity rows' streams on {storage} "
                        f"differ from the pool-less batcher's")
        check(err == 0.0, f"adapters: identity rows' logits on {storage} "
                          f"{err} from the pool-less batcher's")
        out[storage] = {"streams_equal": True, "max_abs_logit_diff": err,
                        "steps": len(l0)}
        if storage == "paged":
            base = (s0, f0)
    return out, base


def _adapter_rows(torch, make, prompts, base, n_layers: int) -> dict:
    """The mixed batch (three adapters and the base over 8 rows) against
    each row served alone in a batcher of the same slots and pool: greedy
    streams, and the first-step (admission) and first decode step's
    logit distances; K2's two arms counted over the mixed batch's
    rounds."""
    from tpushare_torch.serving.llm import kernel_launches

    kw = {"adapter_slots": ADAPTER_SLOTS, "adapter_rank": ADAPTER_RANK}
    b = make(**kw)
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams, logits, firsts = _adapter_run(b, prompts, ADAPTER_MIX)
    torch.cuda.synchronize()
    mixed_s = time.perf_counter() - t0
    launches = kernel_launches()
    steps, prefills = b.decode_steps, b.prefills
    info = b.storage_info()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    solo_b = make(**kw)
    first_err, step_err, equal = [], [], []
    for i, (p, a) in enumerate(zip(prompts, ADAPTER_MIX)):
        s, lg, f = _adapter_run(solo_b, [p], [a])
        equal.append(s[0] == streams[i])
        first_err.append((f[0] - firsts[i]).abs().max().item())
        # the solo row sits in slot 0, the mixed row in slot i
        step_err.append((lg[0][0] - logits[0][i]).abs().max().item())
    del solo_b
    gc.collect()
    torch.cuda.empty_cache()
    ad = [i for i, a in enumerate(ADAPTER_MIX) if a is not None]
    bs = [i for i, a in enumerate(ADAPTER_MIX) if a is None]
    drift = {k: max(max(first_err[i], step_err[i]) for i in rows)
             for k, rows in (("adapter", ad), ("base", bs))}
    check(drift["adapter"] <= drift["base"],
          f"adapters: adapter rows drift {drift['adapter']} between the "
          f"mixed batch and their runs alone, past the base rows' "
          f"{drift['base']}")
    # rows that do not drift at all keep their streams
    check(drift["base"] > 0 or all(equal),
          "adapters: a row's stream in the mixed batch differs from its "
          "run alone, with no drift in any row's logits")
    changed = [streams[i] != base[0][i] for i in ad]
    check(all(changed), "adapters: an adapter left its stream as the base "
                        "model's for the same prompt")
    pre, dec = launches["paged_attn"], launches["paged_decode"]
    check(pre == n_layers * prefills and dec == n_layers * steps,
          f"adapters: K2 launched {pre} (S > 1) for {prefills} prefills "
          f"and {dec} (decode) for {steps} decode steps, not {n_layers} "
          f"each")
    return {"streams_equal_solo": equal, "changed_from_base": changed,
            "first_step_max_abs_err": first_err,
            "decode_step_max_abs_err": step_err, "drift": drift,
            "mixed_s": mixed_s, "decode_steps": steps, "prefills": prefills,
            "k2": {"paged_attn": pre, "paged_decode": dec,
                   "per_prefill": pre / max(1, prefills),
                   "per_step": dec / max(1, steps)},
            "launches": launches, "storage": info}, firsts


def _adapter_merged(torch, params, cfg, prompts, base_firsts,
                    mixed_firsts) -> dict:
    """One adapter's rows against a plain forward on weights merged as
    W + s A B: the pool path's bf16 first-step logits (the mixed batch's
    admissions) against a pool-less f32 batcher's on the merged weights,
    within ADAPTER_MERGED_SLACK x the base rows' distance (the same
    prompts, the same bf16 path) from the f32 batcher on W.  The merge
    must move the f32 logits past that bound, or the check could not see
    a wrong delta (a wrong leaf, A and B swapped, a wrong scale)."""
    import dataclasses

    from tpushare_torch.ops import lora
    from tpushare_torch.serving.adapters import _name_seed
    from tpushare_torch.serving.continuous import ContinuousBatcher

    name = ADAPTER_MIX[ADAPTER_MERGED_ROWS[0]]
    check(all(ADAPTER_MIX[i] == name for i in ADAPTER_MERGED_ROWS),
          "adapters: the merged-weight rows ride different adapters")
    rows = [prompts[i] for i in ADAPTER_MERGED_ROWS]
    c32 = dataclasses.replace(cfg, dtype=torch.float32,
                              max_seq=ADAPTER_F32_MAX_SEQ)
    p32 = _widened(params)

    def f32_firsts():
        b = ContinuousBatcher(p32, c32, 1, device="cuda")
        out = _first_logits(b, rows)
        del b
        torch.cuda.empty_cache()
        return out

    base32 = f32_firsts()
    # the pool's synthetic loader draws the same entry from the name
    entry = lora.make_adapter(cfg, ADAPTER_RANK, seed=_name_seed(name),
                              device="cuda")
    for leaf in lora.serving_adapter_dims(cfg):
        a, b = entry[leaf]["a"], entry[leaf]["b"]
        w = p32["layers"][leaf]
        for l in range(cfg.n_layers):
            w[l].addmm_(a[l].float(), b[l].float(), alpha=entry["scale"])
    del entry
    merged32 = f32_firsts()
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    d_base = max((base_firsts[i] - w).abs().max().item()
                 for i, w in zip(ADAPTER_MERGED_ROWS, base32))
    d_adapter = max((mixed_firsts[i] - w).abs().max().item()
                    for i, w in zip(ADAPTER_MERGED_ROWS, merged32))
    d_merge = min((m - w).abs().max().item()
                  for m, w in zip(merged32, base32))
    bound = ADAPTER_MERGED_SLACK * d_base
    check(d_adapter <= bound,
          f"adapters: {name}'s rows {d_adapter} from the f32 forward on "
          f"the merged weights, past {ADAPTER_MERGED_SLACK}x the base "
          f"rows' {d_base}")
    check(d_merge > bound,
          f"adapters: the merge moves the f32 logits only {d_merge}, "
          f"inside the bound {bound}")
    return {"adapter": name, "rows": list(ADAPTER_MERGED_ROWS),
            "base_max_abs_err": d_base, "adapter_max_abs_err": d_adapter,
            "bound": bound, "merge_moves_f32_by": d_merge}


def _adapter_step(torch, make, prompts) -> dict:
    """One decode step's wall, busy time and ops with the mixed rows,
    against the same rows on a pool-less batcher (``profile_decode``'s
    profiler, as ``_step_profile``)."""
    from tpushare_torch.profile_decode import _profiled

    out = {}
    for arm, kw, names in (
            ("base", {}, [None] * len(prompts)),
            ("adapters", {"adapter_slots": ADAPTER_SLOTS,
                          "adapter_rank": ADAPTER_RANK}, ADAPTER_MIX)):
        b = make(**kw)
        for p, a in zip(prompts, names):
            check(b.admit(p, 2 * ADAPTER_PROFILE_STEPS + 4,
                          adapter=a) is not None,
                  "adapters: step-profile admission")
        prof = _profiled(b.tick, ADAPTER_PROFILE_STEPS)
        b.run_until_drained()
        out[arm] = {k: prof[k] for k in STEP_KEYS}
        out[arm]["top_kernels"] = prof["top_kernels"][:5]
        del b
        gc.collect()
        torch.cuda.empty_cache()
    for k in STEP_KEYS:
        out[f"{k}_ratio"] = (out["adapters"][k] / out["base"][k]
                             if out["base"][k] else None)
    return out


def _adapter_move(torch, params, cfg, prompt) -> dict:
    """An adapter session moved between two paged batchers after 9 decode
    steps: the receiver re-acquires its adapter by name, its first step
    0.0 from the unmoved run's, the stream equal; a pool-less receiver
    refuses the blob as a config mismatch."""
    from tpushare_torch.serving import migrate
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    def make(**kw):
        return PagedContinuousBatcher(params, cfg, n_slots=2, page_size=16,
                                      n_pages=200, device="cuda", **kw)

    kw = {"adapter_slots": ADAPTER_SLOTS, "adapter_rank": ADAPTER_RANK}
    ref = make(**kw)
    rid = ref.admit(prompt, ADAPTER_NEW, adapter="tenant-b")
    with _sampler_logits() as want_logits:
        while ref.slots:
            ref.tick()
    want = ref.completed.pop(rid)
    del ref
    a = make(**kw)
    rid = a.admit(prompt, ADAPTER_NEW, adapter="tenant-b")
    for _ in range(MIGRATE_SPLIT):
        a.tick()
    blob = a.export_session(rid)
    a.pop_session(rid)
    check(a.adapter_pool._rows[1]["refs"] == 0,
          "adapters: pop_session left the adapter pinned")
    named = migrate.blob_meta(blob)["slot"]["adapter"]
    del a
    b = make(**kw)
    got = b.import_session(blob)
    check(got is not None, "adapters: the receiver refused the session")
    check(b.adapter_pool.name_of(1) == "tenant-b",
          "adapters: the receiver did not re-acquire the adapter by name")
    with _sampler_logits() as seen:
        while b.slots:
            b.tick()
    stream = b.completed.pop(got)
    err = (seen[0][0] - want_logits[MIGRATE_SPLIT][0]).abs().max().item()
    check(err == 0.0, f"adapters: the moved session's first step {err} "
                      f"from the unmoved run's")
    check(stream == want, "adapters: the moved stream differs")
    del b
    bare = make()
    refused = None
    try:
        bare.import_session(blob)
    except migrate.ConfigMismatch:
        refused = "config_mismatch"
    check(refused == "config_mismatch",
          "adapters: a pool-less receiver took an adapter session")
    del bare
    gc.collect()
    torch.cuda.empty_cache()
    return {"blob_adapter": named, "first_step_max_abs_err": err,
            "streams_equal": True, "blob_bytes": len(blob),
            "pool_less_receiver": refused}


def _adapter_server(torch, params, cfg, prompts) -> dict:
    """``LLMServer(n_slots=8, adapter_slots=4)``: four requests pin four
    adapters, a fifth adapter then gets 503 + ``Retry-After``; once they
    finish it loads by evicting one (``capacity``); the pool's bytes by
    ``/metrics``, its economics by ``/stats``; and a text prompt."""
    from tpushare_torch.ops import lora
    from tpushare_torch.serving.llm import LLMServer
    from tpushare_torch.serving.tokenizer import BOS_ID

    ev0 = _count_metric(None, "tpushare_adapter_evictions_total",
                        reason="capacity")
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    n_pages=ADAPTER_PAGES, adapter_slots=ADAPTER_SLOTS,
                    adapter_rank=ADAPTER_RANK, device="cuda").start()
    try:
        results = [None] * len(ADAPTER_SERVER_NAMES)

        def send(i):
            results[i] = _post_code(srv.port, "/generate", {
                "tokens": [prompts[i]], "max_new_tokens": ADAPTER_SERVER_NEW,
                "adapter": ADAPTER_SERVER_NAMES[i]}, timeout=600)

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(ADAPTER_SERVER_NAMES))]
        for t in threads:
            t.start()
        pinned = False
        t_end = time.perf_counter() + 120
        while time.perf_counter() < t_end:
            st = json.loads(_get(srv.port, "/stats")[1])
            ads = st["batcher"].get("adapters", {})
            if (ads.get("resident") == len(ADAPTER_SERVER_NAMES)
                    and st["batcher"]["active"] == len(ADAPTER_SERVER_NAMES)):
                pinned = True
                break
            time.sleep(0.005)
        check(pinned, "adapters: four adapters never all pinned")
        code, headers, body = _post_code(srv.port, "/generate", {
            "tokens": [prompts[0]], "max_new_tokens": 4,
            "adapter": ADAPTER_FIFTH})
        for t in threads:
            t.join(timeout=600)
        check(code == 503 and headers.get("Retry-After"),
              f"adapters: a fifth adapter against four pinned got {code}")
        for i, r in enumerate(results):
            check(r is not None and r[0] == 200,
                  f"adapters: pinned request {i} failed: {r}")
        code5, _, body5 = _post_code(srv.port, "/generate", {
            "tokens": [prompts[0]], "max_new_tokens": 4,
            "adapter": ADAPTER_FIFTH})
        check(code5 == 200, f"adapters: the fifth adapter after the pins "
                            f"released got {code5}: {body5}")
        parsed = _metrics(srv.port)
        evictions = _count_metric(parsed, "tpushare_adapter_evictions_total",
                                  reason="capacity") - ev0
        pool_bytes = _count_metric(parsed, "tpushare_adapter_pool_bytes")
        resident = _count_metric(parsed, "tpushare_adapter_resident")
        st = json.loads(_get(srv.port, "/stats")[1])
        kv = st["kv_storage"]
        entry = lora.adapter_entry_bytes(cfg, ADAPTER_RANK)
        check(evictions == 1, f"adapters: {evictions} capacity evictions, "
                              f"not 1")
        check(pool_bytes == (ADAPTER_SLOTS + 1) * entry
              == lora.adapter_pool_bytes(cfg, ADAPTER_RANK,
                                         ADAPTER_SLOTS + 1)
              == kv["adapter_pool_bytes"],
              f"adapters: pool bytes {pool_bytes}, entry {entry}, "
              f"/stats {kv.get('adapter_pool_bytes')}")
        check(kv["merged_bytes_per_adapter"]
              == lora.merged_adapter_bytes(cfg),
              f"adapters: /stats merged bytes {kv}")
        # text prompts, through the same server
        tcode, _, tbody = _post_code(srv.port, "/generate", {
            "text": ADAPTER_TEXT, "max_new_tokens": 8})
        check(tcode == 200, f"adapters: the text prompt got {tcode}")
        row = tbody["tokens"][0]
        want = [BOS_ID] + [b + 2 for b in ADAPTER_TEXT.encode("utf-8")]
        check(row[:len(want)] == want and len(row) == len(want) + 8,
              "adapters: the text prompt's tokens are not BOS, bytes + 2, "
              "then 8 generated")
        check(isinstance(tbody["text"][0], str)
              and tbody["text"][0].startswith(ADAPTER_TEXT),
              "adapters: the text answer does not start with the prompt")
    finally:
        srv.stop()
    return {"fifth_code": code, "retry_after": headers.get("Retry-After"),
            "fifth_after_code": code5, "capacity_evictions": evictions,
            "resident": resident, "adapter_pool_bytes": pool_bytes,
            "bytes_per_adapter": entry,
            "merged_bytes_per_adapter": kv["merged_bytes_per_adapter"],
            "merged_over_adapter": kv["merged_bytes_per_adapter"] / entry,
            "text_tokens": len(row), "text": tbody["text"][0][:80]}


def _count_metric(parsed, name, **labels) -> float:
    """The sum of a family's samples with these labels: from a parsed
    ``/metrics``, or, with ``parsed`` None, from the process registry."""
    if parsed is None:
        from tpushare_torch.telemetry import REGISTRY, parse_text

        parsed = parse_text(REGISTRY.render())
    return sum(v for lab, v in parsed["samples"].get(name, ())
               if all(lab.get(k) == x for k, x in labels.items()))


def phase_adapters(torch, card: str):
    """Multi-adapter LoRA serving on Llama-3-8B at full width and depth
    (bf16 random seeded weights, synthetic rank-8 adapters drawn from
    their names): identity rows bit-equal to a pool-less batcher on the
    paged pool and dense rows; a mixed batch of 8 rows over three
    adapters and the base against each row alone, adapter rows drifting
    no further than base rows, every adapter changing its stream, one
    adapter's rows against a plain f32 forward on merged weights, K2's
    prefill arm once a layer of every admission and its decode arm once a
    layer of every step; residency through the server (503 under
    pressure, one capacity eviction, the pool's bytes); a text prompt; an
    adapter session moved between two batchers; and a decode step's
    wall, busy time and ops with adapters against without."""
    from tpushare_torch.serving.llm import build_model

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    prompts = _adapter_prompts(cfg)
    make = _adapter_batchers(params, cfg)
    res = {"model": "llama3-8b", "card": card, "lens": ADAPTER_LENS,
           "rank": ADAPTER_RANK, "adapter_slots": ADAPTER_SLOTS,
           "mix": ADAPTER_MIX}
    part = {}
    t = time.perf_counter()
    res["identity"], base = _adapter_identity(torch, make, prompts)
    part["identity"] = time.perf_counter() - t
    t = time.perf_counter()
    res["rows"], firsts = _adapter_rows(torch, make["paged"], prompts,
                                        base, cfg.n_layers)
    part["rows"] = time.perf_counter() - t
    t = time.perf_counter()
    res["merged"] = _adapter_merged(torch, params, cfg, prompts, base[1],
                                    firsts)
    del firsts, base
    part["merged"] = time.perf_counter() - t
    t = time.perf_counter()
    res["server"] = _adapter_server(torch, params, cfg, prompts)
    part["server"] = time.perf_counter() - t
    t = time.perf_counter()
    res["moved"] = _adapter_move(torch, params, cfg, prompts[3])
    part["moved"] = time.perf_counter() - t
    t = time.perf_counter()
    res["decode_step"] = _adapter_step(torch, make["paged"], prompts)
    part["decode_step"] = time.perf_counter() - t
    res["part_s"] = part
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, make
    gc.collect()
    torch.cuda.empty_cache()
    return res


#: the moe phase's model: Mistral-7B's widths with Mixtral-8x7B's expert
#: layout (8 experts, top-2, every layer routed), at 16 of its 32 layers:
#: 45.1 GB of bf16 experts, where 32 layers (90.2 GB) exceed the card
MOE_LAYERS = 16
MOE_EXPERTS = 8
MOE_TOP_K = 2
#: the rows check: the adapters phase's 8 prompts of 256–2000 tokens
MOE_NEW = 32
MOE_PAGES = 640
#: new tokens a server request asks for: past DERIVED_OBSERVE_EVERY (16)
#: service rounds of 8 decode steps, so the load histogram is observed
MOE_SERVER_NEW = 136
#: the mixture against the literal formula: moe_ffn's distance from the
#: f32 formula within this multiple of the bf16 formula's
MOE_MIXTURE_SLACK = 1.25
#: the decode steps timed, then profiled
MOE_PROFILE_STEPS = 4


def _moe_cfg(n_experts: int = MOE_EXPERTS, top_k: int = MOE_TOP_K):
    import dataclasses

    from tpushare_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.mistral_7b(), n_layers=MOE_LAYERS)
    check((cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.vocab)
          == (4096, 14336, 32, 8, 32000), f"moe: not Mixtral's widths: {cfg}")
    if n_experts:
        cfg = dataclasses.replace(cfg, n_experts=n_experts,
                                  moe_top_k=top_k, moe_every=1)
    return cfg


def _moe_identity(torch, prompts) -> dict:
    """The 16-layer Mistral-7B wrapped as ``n_experts=1`` (its FFN as
    expert 0, a zero router): first-step and first decode-step logits
    0.0 from the dense model's on the paged pool, the streams equal."""
    import dataclasses

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg = _moe_cfg(0)
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    layers = dict(params["layers"])
    for src, dst in (("w_gate", "moe_gate"), ("w_up", "moe_up"),
                     ("w_down", "moe_down")):
        layers[dst] = layers.pop(src)[:, None]          # views, no copy
    layers["router"] = torch.zeros((cfg.n_layers, cfg.d_model, 1),
                                   dtype=cfg.dtype, device="cuda")
    layers["moe_route"] = torch.ones((cfg.n_layers,), device="cuda")
    mparams = {**params, "layers": layers}
    mcfg = dataclasses.replace(cfg, n_experts=1, moe_top_k=1)
    runs = []
    for p, c in ((params, cfg), (mparams, mcfg)):
        b = PagedContinuousBatcher(p, c, n_slots=8, page_size=16,
                                   n_pages=MOE_PAGES, device="cuda")
        streams, logits, firsts = _adapter_run(b, prompts[:4],
                                               [None] * 4)
        runs.append((streams, logits[0], firsts))
        del b
    (s0, l0, f0), (s1, l1, f1) = runs
    err = max((a - c).abs().max().item()
              for a, c in zip(f0 + [l0], f1 + [l1]))
    check(err == 0.0, f"moe: the single-expert tree's logits {err} from "
                      f"the dense model's")
    check(s0 == s1, "moe: the single-expert tree's streams differ")
    del params, mparams, layers, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_logit_diff": err, "streams_equal": True,
            "rows": 4}


def _moe_mixture(torch, params, cfg) -> dict:
    """One layer at the decode shape (8 tokens): ``moe_ffn`` and the
    reference's literal per-token formula (``moe_ffn_gathered``) in bf16,
    each against the formula in f32 on this layer's weights widened."""
    import dataclasses

    from tpushare_torch.ops import experts

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32)
    layer = {k: v[0] for k, v in params["layers"].items()}
    with torch.inference_mode():
        y, load = experts.moe_ffn(x.to(cfg.dtype), layer, cfg)
        lit, lit_load = experts.moe_ffn_gathered(x.to(cfg.dtype), layer, cfg)
        l32 = {k: v.float() for k, v in layer.items()}
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref, ref_load = experts.moe_ffn_gathered(x, l32, c32)
        del l32
        d_moe = (y.float() - ref).abs().max().item()
        d_lit = (lit.float() - ref).abs().max().item()
        d_pair = (y.float() - lit.float()).abs().max().item()
    check(torch.equal(load, lit_load), "moe: the mixture's load differs "
                                       "from the literal formula's")
    check(float(load.sum()) == 8 * cfg.moe_top_k,
          f"moe: {float(load.sum())} assignments for 8 tokens")
    check(d_moe <= MOE_MIXTURE_SLACK * d_lit,
          f"moe: moe_ffn {d_moe} from the f32 formula, past "
          f"{MOE_MIXTURE_SLACK}x the bf16 formula's {d_lit}")
    torch.cuda.empty_cache()
    return {"moe_from_f32": d_moe, "literal_from_f32": d_lit,
            "moe_from_literal": d_pair,
            "bound": MOE_MIXTURE_SLACK * d_lit,
            "load": load.tolist(), "f32_load": ref_load.tolist()}


def _moe_rows(torch, make, prompts, n_layers: int) -> dict:
    """The 8 rows as one batch against each row alone in a batcher of the
    same 8 slots: first-step and first decode-step logits 0.0, every
    greedy stream equal; K2's two arms once a layer of every forward of
    the batch's rounds."""
    from tpushare_torch.serving.llm import kernel_launches

    b = make()
    _zero_launch_counts()
    streams, logits, firsts = _adapter_run(b, prompts, [None] * len(prompts))
    launches = kernel_launches()
    steps, prefills = b.decode_steps, b.prefills
    del b
    gc.collect()
    first_err, step_err, equal = [], [], []
    solo = make()
    for i, p in enumerate(prompts):
        s, lg, f = _adapter_run(solo, [p], [None])
        equal.append(s[0] == streams[i])
        first_err.append((f[0] - firsts[i]).abs().max().item())
        step_err.append((lg[0][0] - logits[0][i]).abs().max().item())
    del solo
    gc.collect()
    torch.cuda.empty_cache()
    check(max(first_err + step_err) == 0.0,
          f"moe: rows in the batch {max(first_err + step_err)} from their "
          f"runs alone")
    check(all(equal), "moe: a row's stream in the batch differs from its "
                      "run alone")
    pre, dec = launches["paged_attn"], launches["paged_decode"]
    check(pre == n_layers * prefills and dec == n_layers * steps,
          f"moe: K2 launched {pre} (S > 1) for {prefills} prefills and "
          f"{dec} (decode) for {steps} decode steps, not {n_layers} each")
    return {"streams_equal_solo": equal,
            "first_step_max_abs_err": max(first_err),
            "decode_step_max_abs_err": max(step_err),
            "prefills": prefills, "decode_steps": steps,
            "k2": {"paged_attn": pre, "paged_decode": dec},
            # the batch's run, which the ep checks compare with (popped)
            "_batch": (streams, logits, firsts)}


def _moe_server(torch, params, cfg) -> dict:
    """``LLMServer`` (8 slots, pages of 16) under four concurrent
    ``/generate`` and a 2048-token ``/score``: K2 16 a forward, both
    arms; K1 16 for the ``/score``; the expert keys of ``/stats`` and the
    expert families of ``/metrics``."""
    from tpushare_torch.ops import experts
    from tpushare_torch.serving.llm import LLMServer

    load0 = _count_metric(None, "tpushare_expert_load_count")
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    n_pages=MOE_PAGES, device="cuda").start()
    try:
        res = _drive_server(srv.port, cfg, max_new=MOE_SERVER_NEW)
        parsed = _metrics(srv.port)
    finally:
        srv.stop()
    del srv
    n = cfg.n_layers
    got = res["launches"]
    check(got["flash_fwd"] == n,
          f"moe: K1 launched {got['flash_fwd']} times for one /score")
    check(got["paged_attn"] == n * res["prefills"]
          and got["paged_decode"] == n * res["decode_steps"],
          f"moe: K2 launched {got['paged_attn']} (S > 1) for "
          f"{res['prefills']} prefills and {got['paged_decode']} (decode) "
          f"for {res['decode_steps']} decode steps")
    _check_k2_arms(res, "", n)
    kv = res.pop("kv_storage")
    want = {"n_experts": cfg.n_experts, "moe_top_k": cfg.moe_top_k,
            "expert_pool_bytes": experts.expert_pool_bytes(cfg),
            "ep_shards": 1}
    check(want["expert_pool_bytes"] == 45_098_205_248,
          f"moe: expert pool {want['expert_pool_bytes']} bytes")
    check(all(kv.get(k) == v for k, v in want.items()),
          f"moe: /stats storage_info {kv}, not {want}")
    experts_gauge = _count_metric(parsed, "tpushare_moe_experts")
    pool_gauge = _count_metric(parsed, "tpushare_expert_pool_bytes")
    observed = _count_metric(parsed, "tpushare_expert_load_count") - load0
    check(experts_gauge == cfg.n_experts,
          f"moe: tpushare_moe_experts {experts_gauge}")
    check(pool_gauge == want["expert_pool_bytes"],
          f"moe: tpushare_expert_pool_bytes {pool_gauge}")
    check(observed > 0 and observed % cfg.n_experts == 0,
          f"moe: tpushare_expert_load observed {observed} samples")
    res.update({"storage": {k: kv[k] for k in want},
                "expert_pool_bytes_per_shard":
                    kv["expert_pool_bytes_per_shard"],
                "load_samples": observed,
                "load_rounds": observed / cfg.n_experts})
    return res


def _moe_times(torch, make, prompts, params, cfg) -> dict:
    """A decode step's wall, busy and ops (8 rows, contexts 256–2000)
    and a 2000-token admission's, by ``profile_decode``'s profiler,
    beside their bounds: the step reads every weight once (bytes), the
    admission computes 2 x 3 x d x f a token, expert and layer, for the
    k routed experts or for all E."""
    from tpushare_torch.ops import quant
    from tpushare_torch.profile_decode import _profiled
    from tpushare_torch.utils.cuda_timing import (PEAK_BF16_FLOPS,
                                                  PEAK_HBM_BYTES)

    b = make()
    step = _step_profile(b, prompts, steps=MOE_PROFILE_STEPS)
    del b
    gc.collect()
    weight_bytes = quant.hbm_bytes(params)
    step["weight_bytes"] = weight_bytes
    step["bound_ms"] = weight_bytes / PEAK_HBM_BYTES * 1e3
    pb = make()
    prompt = prompts[-1]

    def admission():
        check(pb._reserve(0, len(prompt), 1), "moe: no pages for the "
                                               "admission")
        pb._prefill_into(0, prompt)
        torch.cuda.synchronize()
        pb._release(0)

    prof = _profiled(admission, 1)
    del pb
    gc.collect()
    torch.cuda.empty_cache()
    per_expert = 2 * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers * len(prompt)
    routed = per_expert * cfg.moe_top_k
    evaluated = per_expert * cfg.n_experts
    adm = {k: prof[k] for k in STEP_KEYS}
    adm.update({"prompt": len(prompt), "top_kernels": prof["top_kernels"][:5],
                "routed_tflop": routed / 1e12,
                "evaluated_tflop": evaluated / 1e12,
                "routed_bound_ms": routed / PEAK_BF16_FLOPS * 1e3,
                "evaluated_bound_ms": evaluated / PEAK_BF16_FLOPS * 1e3})
    return {"decode_step": step, "admission": adm}


#: the ep phase's pool: an E = 8 pool on ep = 3 (demoted) serves one
#: short request from this many pages
MOE_EP_DEMOTED_PAGES = 64


def _ep_mesh(**axes):
    """A mesh of ``axes`` whose every shard is the one card."""
    from tpushare_torch.parallel.mesh import make_mesh

    n = 1
    for v in axes.values():
        n *= v
    return make_mesh(axes, devices=["cuda:0"] * n)


def _moe_ep_mixture(torch, params, cfg, bound: float) -> dict:
    """(a) One layer's ``moe_ffn`` at ep = 2 (the card listed twice)
    against ep = 1, at a 2000-token admission and an 8-row decode step:
    0.0 expected (each shard's partial is the unsharded sum's addends
    and exact zeros), within ``bound`` (the mixture check's slack), the
    loads equal."""
    from tpushare_torch.ops import experts

    mesh = _ep_mesh(ep=2)
    layer = {k: v[0] for k, v in params["layers"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    out = {}
    for name, shape in (("admission", (1, 2000, cfg.d_model)),
                        ("decode", (8, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32).to(cfg.dtype)
        with torch.inference_mode():
            y1, load1 = experts.moe_ffn(x, layer, cfg)
            y2, load2 = experts.moe_ffn(x, layer, cfg, mesh=mesh)
            d = (y2.float() - y1.float()).abs().max().item()
        check(torch.equal(load1, load2), f"ep: the {name} loads differ")
        check(d <= bound, f"ep: moe_ffn at ep = 2 {d} from ep = 1 at the "
                          f"{name}, past {bound}")
        out[name] = {"tokens": shape[0] * shape[1], "max_abs_diff": d}
    out["bound"] = bound
    torch.cuda.empty_cache()
    return out


def _moe_ep_compare(what: str, base, run) -> dict:
    """The first-step and first decode-step logits and streams of ``run``
    against ``base`` (each ``_adapter_run``'s (streams, step logits,
    first-step logits)): within LOGIT_TOL, 0.0 expected; the streams
    equal wherever the logits are (a bf16 rounding apart, greedy streams
    may part)."""
    (s0, l0, f0), (s1, l1, f1) = base, run
    first = max((a - b).abs().max().item() for a, b in zip(f0, f1))
    step = (l0[0] - l1[0]).abs().max().item()
    check(max(first, step) <= LOGIT_TOL,
          f"{what}: logits {max(first, step)} from ep = 1's")
    equal = [a == b for a, b in zip(s0, s1)]
    if first == step == 0.0:
        check(all(equal), f"{what}: streams differ at equal logits")
    return {"first_step_max_abs_err": first,
            "decode_step_max_abs_err": step, "streams_equal": equal}


def _moe_ep_rows(torch, params, cfg, prompts, base, step1) -> dict:
    """(b) The 8 prompts through a ``PagedContinuousBatcher`` on
    ``{"ep": 2}``: logits and streams against ep = 1's batch (``base``),
    K2's two arms once a layer of every forward, ``storage_info`` (2
    shards, half the pool's bytes each), and an 8-row decode step's
    wall, busy and ops beside ep = 1's (``step1``)."""
    from tpushare_torch.ops import experts
    from tpushare_torch.serving.llm import kernel_launches
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    b = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                               n_pages=MOE_PAGES, mesh=_ep_mesh(ep=2))
    info = b.storage_info()
    pool = experts.expert_pool_bytes(cfg)
    check(info["ep_shards"] == 2
          and info["expert_pool_bytes_per_shard"] == pool // 2
          and "expert_fallback_reason" not in info,
          f"ep: storage_info {info}")
    check(isinstance(b.params["layers"][0]["moe_gate"], experts.ExpertBlocks),
          "ep: the expert stacks are not laid in ep blocks")
    _zero_launch_counts()
    run = _adapter_run(b, prompts, [None] * len(prompts))
    launches = kernel_launches()
    steps, prefills = b.decode_steps, b.prefills
    pre, dec = launches["paged_attn"], launches["paged_decode"]
    check(pre == cfg.n_layers * prefills and dec == cfg.n_layers * steps,
          f"ep: K2 launched {pre} (S > 1) for {prefills} prefills and "
          f"{dec} (decode) for {steps} decode steps")
    res = _moe_ep_compare("ep rows", base, run)
    step = _step_profile(b, prompts, steps=MOE_PROFILE_STEPS)
    del b, run
    gc.collect()
    torch.cuda.empty_cache()
    res.update({"prefills": prefills, "decode_steps": steps,
                "k2": {"paged_attn": pre, "paged_decode": dec},
                "k2_decode_per_step": dec / steps,
                "storage": {k: info[k] for k in (
                    "ep_shards", "expert_pool_bytes",
                    "expert_pool_bytes_per_shard")},
                "decode_step": step, "decode_step_ep1": step1})
    return res


def _moe_ep_staged(torch, params, cfg, prompts) -> dict:
    """(c) The staged step on ``{"pp": 2, "ep": 2}``: logits and streams
    against a flat ep = 1 batch, K2's decode arm n_layers x n_micro a
    staged step (its S > 1 arm n_layers a prefill, the flat forward over
    the stage-placed layers).  Both full-causal: Mistral-7B's window
    makes the paged pool a page ring, which the staged step refuses
    (``pp_storage``); the 256-2000-token rows lie inside the window, so
    the model's values are the windowed ones."""
    import dataclasses

    from tpushare_torch.serving.llm import kernel_launches
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    full = dataclasses.replace(cfg, window=None)
    flat = PagedContinuousBatcher(params, full, n_slots=8, page_size=16,
                                  n_pages=MOE_PAGES, device="cuda")
    base = _adapter_run(flat, prompts, [None] * len(prompts))
    del flat
    gc.collect()
    b = PagedContinuousBatcher(params, full, n_slots=8, page_size=16,
                               n_pages=MOE_PAGES, mesh=_ep_mesh(pp=2, ep=2),
                               pp=2)
    info = b.storage_info()
    check(b._pp_staged and info["ep_shards"] == 2
          and info["pp_stages"] == 2, f"ep x pp: {info}")
    n_micro = b.pp_microbatches
    _zero_launch_counts()
    run = _adapter_run(b, prompts, [None] * len(prompts))
    launches = kernel_launches()
    steps, prefills = b.decode_steps, b.prefills
    pre, dec = launches["paged_attn"], launches["paged_decode"]
    check(pre == cfg.n_layers * prefills
          and dec == cfg.n_layers * n_micro * steps,
          f"ep x pp: K2 launched {pre} (S > 1) for {prefills} prefills and "
          f"{dec} (decode) for {steps} staged steps of {n_micro} "
          f"microbatches")
    res = _moe_ep_compare("ep x pp", base, run)
    del b, run, base
    gc.collect()
    torch.cuda.empty_cache()
    res.update({"n_micro": n_micro, "prefills": prefills,
                "decode_steps": steps,
                "k2": {"paged_attn": pre, "paged_decode": dec},
                "k2_decode_per_step": dec / steps})
    return res


def _moe_ep_server(torch, params, cfg) -> dict:
    """(d) An ``LLMServer`` on ``{"ep": 2}`` (the card listed twice)
    under the server phase's load (32 new tokens a request): the
    ``/generate`` rows, the ``/score`` through the sharded mixture (K1 16
    times), K2 16 a forward, ``/stats``' mesh and expert keys,
    ``tpushare_expert_fallback_total`` unmoved; then an E = 8 pool on
    ``{"ep": 3}``: demoted (``ep_experts``), counted once, named in
    ``storage_info``, and still serving."""
    from tpushare_torch.serving.llm import LLMServer
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    fell0 = _count_metric(None, "tpushare_expert_fallback_total")
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    n_pages=MOE_PAGES, mesh=_ep_mesh(ep=2)).start()
    try:
        res = _drive_server(srv.port, cfg)
        _, stats = _get(srv.port, "/stats")
        stats = json.loads(stats)
    finally:
        srv.stop()
    del srv
    n = cfg.n_layers
    got = res["launches"]
    check(got["flash_fwd"] == n,
          f"ep server: K1 launched {got['flash_fwd']} times for one /score")
    check(got["paged_attn"] == n * res["prefills"]
          and got["paged_decode"] == n * res["decode_steps"],
          f"ep server: K2 launched {got['paged_attn']} (S > 1) for "
          f"{res['prefills']} prefills and {got['paged_decode']} (decode) "
          f"for {res['decode_steps']} decode steps")
    check(stats["mesh"] == {"ep": 2}, f"ep server: /stats mesh {stats['mesh']}")
    kv = res.pop("kv_storage")
    check(kv["ep_shards"] == 2, f"ep server: storage_info {kv}")
    fell1 = _count_metric(None, "tpushare_expert_fallback_total")
    check(fell1 == fell0, f"ep server: expert fallbacks {fell0} -> {fell1}")
    # E = 8 on ep = 3: demoted, counted once, still serving
    b = PagedContinuousBatcher(params, cfg, n_slots=2, page_size=16,
                               n_pages=MOE_EP_DEMOTED_PAGES,
                               mesh=_ep_mesh(ep=3))
    fell2 = _count_metric(None, "tpushare_expert_fallback_total")
    info = b.storage_info()
    check(fell2 == fell1 + 1
          and _count_metric(None, "tpushare_expert_fallback_total",
                            reason="ep_experts") >= 1
          and info.get("expert_fallback_reason") == "ep_experts"
          and info["ep_shards"] == 1,
          f"ep = 3: fallbacks {fell1} -> {fell2}, storage_info {info}")
    rid = b.admit(list(range(1, 17)), 4)
    b.run_until_drained()
    check(len(b.completed[rid]) == 20, "ep = 3: the demoted pool did not "
                                       "serve")
    del b
    gc.collect()
    torch.cuda.empty_cache()
    res.update({"mesh": stats["mesh"],
                "storage": {k: kv[k] for k in (
                    "ep_shards", "expert_pool_bytes",
                    "expert_pool_bytes_per_shard")},
                "fallbacks_during_server": fell1 - fell0,
                "ep3_fallbacks": fell2 - fell1,
                "ep3_reason": info["expert_fallback_reason"]})
    return res


def phase_moe_ep(torch, params, cfg, prompts, res) -> dict:
    """Expert parallelism on the moe phase's params, its shards the one
    card listed again: (a) the mixture, (b) the serving rows, (c) the
    staged step, (d) the server (see the module docstring)."""
    out, part = {}, {}
    t = time.perf_counter()
    out["mixture"] = _moe_ep_mixture(torch, params, cfg,
                                     res["mixture"]["bound"])
    part["mixture"] = time.perf_counter() - t
    base = res["rows"].pop("_batch")
    t = time.perf_counter()
    out["rows"] = _moe_ep_rows(torch, params, cfg, prompts, base,
                               res["decode_step"])
    part["rows"] = time.perf_counter() - t
    del base
    t = time.perf_counter()
    out["staged"] = _moe_ep_staged(torch, params, cfg, prompts)
    part["staged"] = time.perf_counter() - t
    t = time.perf_counter()
    out["server"] = _moe_ep_server(torch, params, cfg)
    part["server"] = time.perf_counter() - t
    out["part_s"] = part
    return out


def phase_moe(torch, card: str):
    """Mixture-of-experts serving at Mixtral-8x7B's widths (Mistral-7B's
    attention, 8 experts of d_ff 14336, top-2, every layer routed) and
    16 of its 32 layers, bf16 random seeded weights: the single-expert
    identity, the mixture against the literal formula, 8 rows in one
    batch against each alone, the server (K1, K2, ``/stats``,
    ``/metrics``) and a decode step's and an admission's times."""
    from tpushare_torch.models import transformer as tf
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg = _moe_cfg()
    prompts = _adapter_prompts(cfg)
    res = {"model": "mistral-7b", "card": card, "layers": cfg.n_layers,
           "n_experts": cfg.n_experts, "moe_top_k": cfg.moe_top_k,
           "lens": ADAPTER_LENS}
    part = {}
    t = time.perf_counter()
    res["identity"] = _moe_identity(torch, prompts)
    part["identity"] = time.perf_counter() - t
    t = time.perf_counter()
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    part["init"] = time.perf_counter() - t
    res["params_gb"] = tf.param_count(params) * 2 / 1e9

    def make():
        return PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                      n_pages=MOE_PAGES, device="cuda")

    t = time.perf_counter()
    res["mixture"] = _moe_mixture(torch, params, cfg)
    part["mixture"] = time.perf_counter() - t
    t = time.perf_counter()
    res["rows"] = _moe_rows(torch, make, prompts, cfg.n_layers)
    part["rows"] = time.perf_counter() - t
    t = time.perf_counter()
    res["server"] = _moe_server(torch, params, cfg)
    part["server"] = time.perf_counter() - t
    t = time.perf_counter()
    res.update(_moe_times(torch, make, prompts, params, cfg))
    part["times"] = time.perf_counter() - t
    t = time.perf_counter()
    res["ep"] = phase_moe_ep(torch, params, cfg, prompts, res)
    part["ep"] = time.perf_counter() - t
    res["part_s"] = part
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, make
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _all_finite(torch, t) -> bool:
    flat = t.detach().reshape(-1)     # a copy of a strided block alone
    step = 1 << 26
    return all(torch.isfinite(flat[i:i + step]).all().item()
               for i in range(0, flat.numel(), step))


#: the QLoRA fine-tune of the train phase: rank-8 adapters on the seven
#: projections of an int8 Llama-3-8B, 4 steps
QLORA_RANK = 8
QLORA_STEPS = 4
#: merge_lora's bf16 weights against the loraized int8 model: within this
#: multiple of the distance that rounding the int8 base itself to bf16
#: weights (the merge's rounding without the delta) moves the logits
QLORA_MERGE_SLACK = 2.0
#: the merge check's prompt
QLORA_MERGE_TOKENS = 512


def _train_qlora(torch, cfg, tokens) -> dict:
    """A QLoRA fine-tune: the int8 base drawn from the seed, loraized at
    rank 8 on wq..w_down, ``make_lora_train_step(remat="layer")`` for 4
    steps on ``tokens``.  The first loss bit-equal to the int8 base
    model's (``b`` starts at 0), every base leaf bit-unchanged after the
    steps and the adapters moved, the optimizer state over the adapter
    dict alone, K1/K3/K4 once a layer and step; the step's wall, busy,
    ops and peak memory; then ``merge_lora``'s bf16 weights against the
    loraized model's logits."""
    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.ops import lora, quant
    from tpushare_torch.parallel.train import (ATTN_SAVING_POLICY, lm_loss,
                                               make_optimizer)
    from tpushare_torch.profile_decode import _profiled

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, device="cuda", quantize_bits=8)
    with torch.no_grad():
        base_loss = lm_loss(params, tokens, cfg,
                            remat_policy=ATTN_SAVING_POLICY).item()
    lp = lora.loraize_params(params, rank=QLORA_RANK, seed=SEED)
    del params
    adapters, frozen = lora.partition(lp)
    base = [t.clone() for t in quant.tensor_leaves(frozen) if t is not None]
    optimizer = make_optimizer(lr=1e-3)
    state = optimizer.init(adapters)
    step = lora.make_lora_train_step(cfg, optimizer, remat="layer")
    kernels = (attn.flash_attention_lse, attn.flash_bwd_dkv,
               attn.flash_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    losses = []

    def one():
        nonlocal lp, state
        lp, state, loss = step(lp, state, tokens)
        losses.append(loss.item())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    first_wall = time.perf_counter() - t0
    prof = _profiled(one, 1)
    n_steps = len(losses)
    launches = [fn.launches for fn in kernels]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_layers
    check(n_steps == QLORA_STEPS, f"qlora: {n_steps} steps")
    check(losses[0] == base_loss,
          f"qlora: the first loss {losses[0]!r} is not the int8 base "
          f"model's {base_loss!r}")
    check(all(np.isfinite(losses)), f"qlora: losses {losses}")
    check(launches == [n * n_steps] * 3,
          f"qlora: K1/K3/K4 launched {launches} times in {n_steps} steps")
    adapters, frozen = lora.partition(lp)
    after = [t for t in quant.tensor_leaves(frozen) if t is not None]
    check(len(after) == len(base)
          and all(torch.equal(x, y) for x, y in zip(after, base)),
          "qlora: a base leaf changed")
    del base
    check(set(state["mu"]) == set(adapters) == set(state["nu"]),
          "qlora: the optimizer state is not the adapter dict's")
    moved = all(t.any().item() for k, t in adapters.items()
                if k.endswith("['b']"))
    check(moved, "qlora: an adapter's b is still zero")
    adapter_bytes = quant.hbm_bytes(adapters)
    state_bytes = quant.hbm_bytes({"mu": state["mu"], "nu": state["nu"]})
    merge = _qlora_merge(torch, lp, cfg)
    del lp, adapters, frozen, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"rank": QLORA_RANK, "steps": n_steps, "losses": losses,
            "base_loss": base_loss, "first_wall_s": first_wall,
            **{k: prof[k] for k in STEP_KEYS},
            "top_kernels": prof["top_kernels"][:5],
            "peak_memory_gb": peak_gb, "adapter_bytes": adapter_bytes,
            "opt_state_bytes": state_bytes,
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dkv": launches[1],
                         "flash_bwd_dq": launches[2]},
            "launches_per_step": launches[0] / n_steps, "merge": merge}


def _qlora_merge(torch, lp, cfg) -> dict:
    """``merge_lora``'s bf16 weights against the loraized int8 model on a
    512-token prompt, within ``QLORA_MERGE_SLACK`` x the distance of the
    int8 base from the base dequantized to bf16 weights."""
    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import lora, quant

    toks = torch.as_tensor(np.random.default_rng(SEED + 71).integers(
        0, cfg.vocab, (1, QLORA_MERGE_TOKENS)), device="cuda")

    def strip(leaf):
        return {k: v for k, v in leaf.items() if k not in ("a", "b",
                                                           "scale")}

    def logits(p):
        with torch.inference_mode():
            return tf.forward(p, toks, cfg)[0].float()

    base = {**lp, "layers": {k: strip(v) if isinstance(v, dict) else v
                             for k, v in lp["layers"].items()}}
    want = logits(lp)
    merged = lora.merge_lora(lp)
    d_merge = (logits(merged) - want).abs().max().item()
    del merged
    torch.cuda.empty_cache()
    b_int8 = logits(base)
    deq = {**base, "layers": {
        k: quant.dequantize(v["q"], v["s"], cfg.dtype)
        if isinstance(v, dict) else v for k, v in base["layers"].items()}}
    d_deq = (logits(deq) - b_int8).abs().max().item()
    del deq
    torch.cuda.empty_cache()
    bound = QLORA_MERGE_SLACK * d_deq
    check(d_merge <= bound, f"qlora: merged logits {d_merge} from the "
                            f"loraized model's, past {QLORA_MERGE_SLACK}x "
                            f"the base's bf16 rounding {d_deq}")
    return {"merged_max_abs_err": d_merge, "base_bf16_rounding": d_deq,
            "bound": bound, "tokens": QLORA_MERGE_TOKENS}


def phase_train(torch, card: str):
    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.train import tree_leaves
    from tpushare_torch.parallel.trainer import Trainer
    from tpushare_torch.utils.cuda_timing import PEAK_BF16_FLOPS

    cfg = tf.llama3_8b()
    b, s, n_steps = 1, 2048, 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    trainer = Trainer(cfg, lr=3e-4, seed=SEED, remat="layer",
                      head_chunk=512, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    static_gb = torch.cuda.memory_allocated() / 1e9
    tokens = torch.as_tensor(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (b, s + 1)), device="cuda")
    kernels = (attn.flash_attention_lse, attn.flash_bwd_dkv,
               attn.flash_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    losses, walls, per_step = [], [], []
    for _ in range(n_steps):
        before = [fn.launches for fn in kernels]
        t1 = time.perf_counter()
        losses.append(trainer.run(iter([tokens]), 1))   # reads the loss
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        per_step.append([fn.launches - n for fn, n in zip(kernels, before)])
    launches = [fn.launches for fn in kernels]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    n = cfg.n_layers
    check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not descend: {losses}")
    for i, (k1, k3, k4) in enumerate(per_step):
        check(k3 == n and k4 == n,
              f"step {i}: K3 launched {k3}, K4 {k4} times, not {n}")
        # remat="layer" saves K1's out and lse: no relaunch in the recompute
        check(k1 == n, f"step {i}: K1 launched {k1} times, not {n}")
    check(all(_all_finite(torch, p) for p in tree_leaves(trainer.params)),
          "a parameter is not finite after the steps")
    wall = float(np.median(walls[1:]))
    # model FLOPs as drives/drive_train_mfu.py counts them: 3x the
    # forward, causal attention, the LM head included
    d, ff = cfg.d_model, cfg.d_ff
    per_tok = n * (2 * (4 * d * d + 3 * d * ff) + 2 * 2 * (s // 2) * d) \
        + 2 * d * cfg.vocab
    model_flops = 3.0 * b * s * per_tok
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    qlora = _train_qlora(torch, cfg, tokens)
    qlora["phase_s"] = time.perf_counter() - t1
    return {"model": "llama3-8b", "card": card, "layers": n,
            "batch": [b, s + 1], "remat": "layer", "head_chunk": 512,
            "init_s": init_s, "losses": losses, "step_walls_s": walls,
            "step_wall_s": wall, "tokens_per_s": b * s / wall,
            "model_tflop_per_step": model_flops / 1e12,
            "mfu_bf16": model_flops / wall / PEAK_BF16_FLOPS,
            "allocated_before_gb": before_gb, "static_gb": static_gb,
            "peak_memory_gb": peak_gb,
            "peak_reserved_gb": reserved_gb,
            "launches_per_step": {"flash_fwd": per_step[0][0],
                                  "flash_bwd_dkv": per_step[0][1],
                                  "flash_bwd_dq": per_step[0][2]},
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dkv": launches[1],
                         "flash_bwd_dq": launches[2]},
            "qlora": qlora}


#: the train_sharded phase: Llama-3-8B's widths at 16 layers, 4 rows of
#: 2,048 tokens; the pipelined gradient at 4 microbatches against the
#: flat one summed microbatch by microbatch in f32
SHARDED_LAYERS = 16
SHARDED_ROWS = 4
SHARDED_SEQ = 2048
SHARDED_MICRO = 4
#: the pipelined loss against the flat mean, relative
SHARDED_LOSS_RTOL = 1e-5
#: each leaf's gradient after the bf16 cast, max abs over the flat
#: leaf's largest magnitude
SHARDED_GRAD_RTOL = 1e-2
#: a sharded trainer's first loss against the flat loss, relative
SHARDED_FIRST_RTOL = 1e-2
#: (e)'s tp x pp loss against the unsplit flat loss, relative: the tp
#: split's bf16 GEMMs round otherwise than the whole ones (1.09e-5 on
#: H100 80GB HBM3, 700 W), so a tenth of a per mille
SHARDED_UNSPLIT_RTOL = 1e-4
#: (e)'s tp x pp leaves against the unsplit model's f32 gradient: no
#: further than this times the unsplit bf16 step's own distance from it
#: (each is one path of bf16 roundings away from the f32 gradient; the
#: tp split and the unsplit bf16 gradients sit 1.1e-2 to 2.5e-2 of a
#: leaf's largest magnitude apart on H100 80GB HBM3, 700 W), or
#: SHARDED_GRAD_RTOL, whichever is larger
SHARDED_F32_FACTOR = 1.5


def _sharded_flat(torch, params, cfg, tokens, mesh=None):
    """The flat ``lm_loss`` and its gradient summed microbatch by
    microbatch (one row each) in f32, divided by their count: the loss a
    float, the gradients bf16 (the cast the step makes), by leaf name.
    ``mesh`` (a tp mesh): the flat loss of the tp split, on the params
    laid out by ``shard_params`` (views of the leaves) through the
    forward's tp shards, its gradients put back together whole
    (``gather_params``), so that only the pipeline schedule differs from
    the 1F1B step on that split beside pp."""
    from tpushare_torch.parallel.mesh import gather_params, shard_params
    from tpushare_torch.parallel.train import lm_loss, tree_leaves, tree_map

    tree = params if mesh is None else shard_params(params, mesh, cfg)
    leaves = list({id(p): p for p in tree_leaves(tree)}.values())
    for p in leaves:
        p.requires_grad_(True)
    acc = {id(p): torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for p in leaves}
    losses = []
    for m in range(SHARDED_MICRO):
        loss = lm_loss(tree, tokens[m:m + 1], cfg, mesh=mesh)
        for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
            acc[id(p)].add_(g)
        losses.append(loss.item())
    for p in leaves:
        p.requires_grad_(False)
    if mesh is not None:
        whole = gather_params(tree_map(lambda p: acc[id(p)], tree), cfg)
        acc = {i: g for i, g in enumerate(tree_leaves(whole))}
        del whole
    grads = []
    for key in list(acc):
        grads.append(acc.pop(key).div_(SHARDED_MICRO).to(torch.bfloat16))
    return sum(losses) / SHARDED_MICRO, grads


def _sharded_f32(torch, params, cfg, tokens):
    """The unsplit model's loss and gradient in f32 (the bf16 weights
    widened, TF32 off, the plain attention, each layer recomputed in
    the backward), summed microbatch by microbatch and divided by their
    count: the loss a float, the gradients on the host in leaf order."""
    import dataclasses

    from tpushare_torch.models import transformer
    from tpushare_torch.ops.attention import reference_attention
    from tpushare_torch.parallel.train import (ATTN_SAVING_POLICY,
                                               tree_leaves, tree_map)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda p: p.float().requires_grad_(True), params)
    losses = []
    for m in range(SHARDED_MICRO):
        row = tokens[m:m + 1]
        logits = transformer.forward(p32, row[:, :-1], cfg32,
                                     remat_policy=ATTN_SAVING_POLICY,
                                     attention_fn=reference_attention)
        loss = -torch.log_softmax(logits, -1).gather(
            -1, row[:, 1:, None].long())[..., 0].mean()
        del logits
        loss.backward()
        losses.append(loss.item())
    grads = [p.grad.div_(SHARDED_MICRO).cpu() for p in tree_leaves(p32)]
    return sum(losses) / SHARDED_MICRO, grads


def _sharded_pipeline(torch, params, cfg, tokens, axes=None,
                      exact=None, unsplit=None):
    """(a): ``pipeline_loss_and_grads`` on ``axes`` (``{"pp": 2}``; (e)
    ``{"tp": 2, "pp": 2}``, each stage's slab through the tp split) at
    SHARDED_MICRO microbatches against the flat gradient of the same
    split (the axes but ``pp``): the loss within SHARDED_LOSS_RTOL, each
    leaf within SHARDED_GRAD_RTOL after the bf16 cast; K1
    tp.M.L.(2S-1)/S, K3 and K4 tp.M.L times (each tp shard attends over
    its own heads).  ``exact``: the unsplit model's f32 loss and
    gradients (:func:`_sharded_f32`), each leaf's distance from them
    recorded for the flat and the pipelined gradient.  ``unsplit``: (a)'s
    record, against which (e)'s split, whose bf16 GEMMs round otherwise,
    is held: the loss within SHARDED_UNSPLIT_RTOL of (a)'s flat loss and
    each leaf no further from the f32 gradient than SHARDED_F32_FACTOR
    times (a)'s flat leaf is, or SHARDED_GRAD_RTOL."""
    from tpushare_torch.parallel import mesh as pmesh
    from tpushare_torch.parallel.train import (pipeline_loss_and_grads,
                                               tree_leaves)

    axes = axes or {"pp": 2}
    names = []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                names.append(prefix + key)

    walk(params, "")
    n_dev = 1
    for v in axes.values():
        n_dev *= v
    split = {a: v for a, v in axes.items() if a != "pp"}
    t0 = time.perf_counter()
    flat_loss, flat = _sharded_flat(
        torch, params, cfg, tokens,
        pmesh.make_mesh(split, devices=["cuda"] * (n_dev // axes["pp"]))
        if split else None)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    mesh = pmesh.make_mesh(axes, devices=["cuda"] * n_dev)
    placed = pmesh.shard_params(params, mesh, cfg)
    tally = [0, 0, 0]
    t0 = time.perf_counter()
    with _k134_counted(tally) as got:
        loss, grads = pipeline_loss_and_grads(placed, tokens, cfg, mesh,
                                              n_micro=SHARDED_MICRO)
        torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    grads = tree_leaves(pmesh.gather_params(grads, cfg))
    loss = loss.item()

    def rel_err(g, w):
        w = w.to(g.device).float()
        return ((g.to(torch.bfloat16).float() - w).abs().max()
                / w.abs().max()).item()

    rel = {name: rel_err(g, w) for name, g, w in zip(names, grads, flat)}
    extra = {}
    if exact is not None:
        f32_loss, f32 = exact
        flat_f32, pipe_f32 = {}, {}
        for name, g, w, e in zip(names, grads, flat, f32):
            e = e.to(g.device)
            flat_f32[name], pipe_f32[name] = rel_err(w, e), rel_err(g, e)
        extra = {"f32_loss": f32_loss, "flat_f32_rel_err": flat_f32,
                 "pipeline_f32_rel_err": pipe_f32}
    if unsplit is not None:
        u_loss = unsplit["flat_loss"]
        bound = {name: max(SHARDED_GRAD_RTOL,
                           SHARDED_F32_FACTOR * unsplit["flat_f32_rel_err"][
                               name]) for name in names}
        over = {name: (extra["pipeline_f32_rel_err"][name], bound[name])
                for name in names
                if extra["pipeline_f32_rel_err"][name] > bound[name]}
        ratio = {name: extra["pipeline_f32_rel_err"][name]
                 / unsplit["flat_f32_rel_err"][name] for name in names}
        extra.update({"unsplit_flat_loss": u_loss,
                      "unsplit_loss_rel_err": abs(loss - u_loss) / abs(u_loss),
                      "f32_bound": bound, "f32_over": over,
                      "max_f32_ratio": max(ratio.values()),
                      "f32_ratio": ratio})
    del grads, placed
    loss_err = abs(loss - flat_loss) / abs(flat_loss)
    n, S, tp = cfg.n_layers, axes["pp"], axes.get("tp", 1)
    want = [tp * SHARDED_MICRO * n * (2 * S - 1) // S,
            tp * SHARDED_MICRO * n, tp * SHARDED_MICRO * n]
    check(loss_err <= SHARDED_LOSS_RTOL,
          f"1F1B loss {loss!r} against the flat {flat_loss!r}")
    check(max(rel.values()) <= SHARDED_GRAD_RTOL,
          f"1F1B gradients past {SHARDED_GRAD_RTOL}: {rel}")
    check(got == want, f"1F1B K1/K3/K4 {got}, not {want}")
    if unsplit is not None:
        check(extra["unsplit_loss_rel_err"] <= SHARDED_UNSPLIT_RTOL,
              f"tp x pp loss {loss!r} against the unsplit flat "
              f"{extra['unsplit_flat_loss']!r}")
        check(not extra["f32_over"], f"tp x pp gradients further from the "
              f"f32 ones than their bound: {extra['f32_over']}")
    worst = max(rel, key=rel.get)
    return {"axes": axes, "n_micro": SHARDED_MICRO, "loss": loss,
            "flat_loss": flat_loss, **extra,
            "loss_rel_err": loss_err, "grad_rel_err": rel,
            "worst_leaf": worst, "max_grad_rel_err": rel[worst],
            "flat_s": flat_s, "pipeline_s": pipe_s,
            "launches": {"flash_fwd": got[0], "flash_bwd_dkv": got[1],
                         "flash_bwd_dq": got[2]}}


def _sharded_trainer(torch, cfg, axes: dict, tokens, n_steps: int,
                     flat_loss: float, want, **kw) -> dict:
    """A ``Trainer`` on ``axes`` over copies of the one card for
    ``n_steps`` steps on ``tokens``: the loss descending from within
    SHARDED_FIRST_RTOL of the flat loss, every parameter finite, K1 / K3
    / K4 ``want`` a step (None: recorded only); the first step's wall,
    then one profiled step's wall, busy time and ops, then the rest
    timed; the peak memory."""
    import numpy as np

    from tpushare_torch.parallel import mesh as pmesh
    from tpushare_torch.parallel.train import tree_leaves
    from tpushare_torch.parallel.trainer import Trainer
    from tpushare_torch.profile_decode import _summary
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = int(np.prod(list(axes.values())))
    mesh = pmesh.make_mesh(axes, devices=["cuda"] * n)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, mesh=mesh, lr=3e-4, seed=SEED, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, walls, per_step, prof = [], [], [], None
    for k in range(n_steps):
        tally = [0, 0, 0]
        with _k134_counted(tally) as got:
            if k == 1:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    t1 = time.perf_counter()
                    losses.append(trainer.run(iter([tokens]), 1))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                prof = _summary(p, wall, wall, 1)
            else:
                t1 = time.perf_counter()
                losses.append(trainer.run(iter([tokens]), 1))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
        walls.append(wall)
        per_step.append(list(got))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    what = "x".join(f"{a}{v}" for a, v in axes.items())
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{what}: losses {losses} do not descend")
    first_err = abs(losses[0] - flat_loss) / abs(flat_loss)
    check(first_err <= SHARDED_FIRST_RTOL,
          f"{what}: first loss {losses[0]} against the flat {flat_loss}")
    check(all(_all_finite(torch, p) for p in tree_leaves(trainer.params)),
          f"{what}: a parameter is not finite")
    if want is not None:
        check(all(c == want for c in per_step),
              f"{what}: K1/K3/K4 a step {per_step}, not {want}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"axes": axes, "steps": n_steps, "init_s": init_s,
            "losses": losses, "first_loss_rel_err": first_err,
            "step_walls_s": walls, **{k: prof[k] for k in STEP_KEYS},
            "top_kernels": prof["top_kernels"][:5],
            "peak_memory_gb": peak_gb,
            "launches_per_step": {"flash_fwd": per_step[0][0],
                                  "flash_bwd_dkv": per_step[0][1],
                                  "flash_bwd_dq": per_step[0][2]},
            "launches": [sum(c[i] for c in per_step) for i in range(3)]}


#: the LoRA trainer of the train_sharded phase: its mesh, rank, steps
#: and learning rate
SHARDED_LORA_AXES = {"fsdp": 2, "tp": 2}
SHARDED_LORA_RANK, SHARDED_LORA_STEPS, SHARDED_LORA_LR = 8, 3, 1e-3


def _sharded_lora(torch, cfg, tokens) -> dict:
    """(f): a rank-8 LoRA ``Trainer`` on ``{"fsdp": 2, "tp": 2}`` (remat
    "layer", head chunks of 512; the base laid out by its parent's rule,
    the adapters' rank split over tp joined where a shard's product
    needs it) for 3 steps: the first loss bit-equal to the base model's
    on the same mesh and loss (``b`` is zero at init), the losses
    falling, every base leaf bit-unchanged; the second step profiled
    (wall, busy time, ops), the peak memory, K1 / K3 / K4 a step."""
    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import lora
    from tpushare_torch.parallel import mesh as pmesh
    from tpushare_torch.parallel.train import (_compute_mesh, make_loss_fn,
                                               tree_leaves)
    from tpushare_torch.parallel.trainer import Trainer
    from tpushare_torch.profile_decode import _summary
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = pmesh.make_mesh(SHARDED_LORA_AXES, devices=["cuda"] * 4)
    loss_fn = make_loss_fn(cfg, "layer", 512)
    with torch.no_grad():
        base = pmesh.shard_params(tf.init_params(cfg, seed=SEED,
                                                 device="cuda"), mesh, cfg)
        base_loss = loss_fn(pmesh.gather_fsdp(base), tokens,
                            mesh=_compute_mesh(mesh)).item()
    del base
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, mesh=mesh, lora_rank=SHARDED_LORA_RANK,
                      lr=SHARDED_LORA_LR, seed=SEED, remat="layer",
                      head_chunk=512)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frozen = []
    lora._map_tensors(lambda path, t: frozen.append(t)
                      if not lora._is_adapter(path) else t, trainer.params)
    frozen = list({id(t): t for t in frozen}.values())
    before = [t.clone() for t in frozen]
    losses, walls, per_step, prof = [], [], [], None
    for k in range(SHARDED_LORA_STEPS):
        with _k134_counted([0, 0, 0]) as got:
            ctx = (profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
                   if k == 1 else contextlib.nullcontext())
            with ctx as p:
                t1 = time.perf_counter()
                losses.append(trainer.run(iter([tokens]), 1))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            if k == 1:
                prof = _summary(p, wall, wall, 1)
        walls.append(wall)
        per_step.append(list(got))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    unchanged = all(torch.equal(a, b) for a, b in zip(before, frozen))
    adapters = lora.placed_adapters(trainer.params)
    moved = any(bool(t.abs().max() > 0)
                for k, v in adapters.items() if k.endswith("['b']")
                for t in tree_leaves(v))
    del before, frozen, trainer, adapters
    gc.collect()
    torch.cuda.empty_cache()
    check(losses[0] == base_loss,
          f"lora fsdp x tp: the first loss {losses[0]!r} is not the base "
          f"model's {base_loss!r}")
    check(all(np.isfinite(losses)) and all(
        b < a for a, b in zip(losses, losses[1:])),
          f"lora fsdp x tp: losses {losses} do not fall")
    check(unchanged, "lora fsdp x tp: a base leaf moved")
    check(moved, "lora fsdp x tp: every adapter's b is still zero")
    tp, n = SHARDED_LORA_AXES["tp"], cfg.n_layers
    check(all(c == [tp * n] * 3 for c in per_step),
          f"lora fsdp x tp: K1/K3/K4 a step {per_step}, not {tp * n}")
    return {"axes": SHARDED_LORA_AXES, "rank": SHARDED_LORA_RANK,
            "lr": SHARDED_LORA_LR, "steps": SHARDED_LORA_STEPS,
            "init_s": init_s, "base_loss": base_loss, "losses": losses,
            "step_walls_s": walls, **{k: prof[k] for k in STEP_KEYS},
            "top_kernels": prof["top_kernels"][:5],
            "peak_memory_gb": peak_gb,
            "launches_per_step": {"flash_fwd": per_step[0][0],
                                  "flash_bwd_dkv": per_step[0][1],
                                  "flash_bwd_dq": per_step[0][2]},
            "launches": [sum(c[i] for c in per_step) for i in range(3)]}


def phase_train_sharded(torch, card: str):
    """Sharded training at Llama-3-8B's widths (16 layers), on meshes
    that repeat the one card: (a) the 1F1B gradient on ``{"pp": 2}``
    against the flat one; Trainers on (b) ``{"pp": 2}``, (c) ``{"dp": 2,
    "pp": 2}`` (the default microbatches: the pp size) for 3 steps and
    (d) ``{"fsdp": 2, "tp": 2}`` (remat "layer", head chunks of 512) for
    2; (e) the 1F1B gradient on ``{"tp": 2, "pp": 2}`` against the flat
    one of the same split and the unsplit f32 one; (f) a rank-8 LoRA
    Trainer on ``{"fsdp": 2, "tp": 2}`` for 3."""
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=SHARDED_LAYERS)
    tokens = torch.as_tensor(np.random.default_rng(SEED + 53).integers(
        0, cfg.vocab, (SHARDED_ROWS, SHARDED_SEQ + 1)), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    exact = _sharded_f32(torch, params, cfg, tokens)
    f32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = _sharded_pipeline(torch, params, cfg, tokens, exact=exact)
    pipe["phase_s"] = time.perf_counter() - t0
    pipe["f32_s"] = f32_s
    pipe["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    pipe_tp = _sharded_pipeline(torch, params, cfg, tokens,
                                {"tp": 2, "pp": 2}, exact, pipe)
    del exact
    pipe_tp["phase_s"] = time.perf_counter() - t0
    pipe_tp["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    n, S = cfg.n_layers, 2
    runs = {}
    for key, axes, steps, kw in (
            ("pp", {"pp": 2}, 3, {}),
            ("dp_pp", {"dp": 2, "pp": 2}, 3, {}),
            ("fsdp_tp", {"fsdp": 2, "tp": 2}, 2,
             {"remat": "layer", "head_chunk": 512})):
        dp = axes.get("dp", 1)
        m = axes.get("pp", 1)        # the Trainer's microbatches
        want = ([dp * m * n * (2 * S - 1) // S, dp * m * n, dp * m * n]
                if "pp" in axes else None)
        t0 = time.perf_counter()
        runs[key] = _sharded_trainer(torch, cfg, axes, tokens, steps,
                                     pipe["flat_loss"], want, **kw)
        runs[key]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["lora_fsdp_tp"] = _sharded_lora(torch, cfg, tokens)
    runs["lora_fsdp_tp"]["phase_s"] = time.perf_counter() - t0
    launches = [0, 0, 0]
    for p in (pipe, pipe_tp):
        launches = [a + p["launches"][k] for a, k in zip(
            launches, ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))]
    for r in runs.values():
        launches = [a + b for a, b in zip(launches, r["launches"])]
    return {"model": "llama3-8b", "card": card, "layers": n,
            "batch": [SHARDED_ROWS, SHARDED_SEQ + 1], "pipeline": pipe,
            "pipeline_tp_pp": pipe_tp, **runs,
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dkv": launches[1],
                         "flash_bwd_dq": launches[2]}}


#: how many ragged requests the pass_mask engine serves, from how many
#: client threads
BERT_RAGGED, BERT_CLIENTS = 40, 4


def _bert_model(torch, name: str) -> dict:
    """One encoder at full width and depth: K1 once a layer of every
    forward over a ``measure_qps`` run, the K1 route's hidden states
    against the f32 reference, and (BERT-base) ragged requests."""
    import dataclasses

    import numpy as np

    from tpushare_torch import bench
    from tpushare_torch.models import bert
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.serving.engine import InferenceEngine, measure_qps

    cfg = bench.MODELS[name]()
    params = bert.init_params(cfg, seed=SEED, device="cuda")
    engine = InferenceEngine(lambda t: bert.forward(params, t, cfg),
                             BERT_BATCH, BERT_SEQ, device="cuda")
    engine.warmup()
    before = attn.flash_attention_lse.launches
    stats = measure_qps(engine, n_batches=30, warmup_batches=1)
    per_forward = (attn.flash_attention_lse.launches - before) / 31
    check(per_forward == cfg.n_layers,
          f"{name}: K1 launched {per_forward} times a forward, not "
          f"{cfg.n_layers}")
    rng = np.random.default_rng(SEED + 11)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab,
                                        (BERT_BATCH, BERT_SEQ)),
                           device="cuda")
    ones = torch.ones_like(toks, dtype=torch.int32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = _widened(params)
    with torch.inference_mode():
        k1_out = bert.forward(params, toks, cfg).float()
        dense = bert.forward(params, toks, cfg, attention_mask=ones).float()
        ref = bert.forward(p32, toks, cfg32, attention_mask=ones)
    for what, t in (("K1 route", k1_out), ("dense path", dense),
                    ("f32 reference", ref)):
        check(t.shape == (BERT_BATCH, BERT_SEQ, cfg.d_model)
              and torch.isfinite(t).all().item(), f"{name}: {what} not "
              f"finite or misshapen")
    d_k1 = (k1_out - ref).abs().max().item()
    d_dense = (dense - ref).abs().max().item()
    bound = 1.25 * d_dense
    check(d_k1 <= bound, f"{name}: K1 route {d_k1} from the f32 "
          f"reference, over 1.25x the bf16 dense path's {d_dense}")
    out = {"model": name, "layers": cfg.n_layers,
           "k1_launches_per_forward": per_forward, "qps": stats["qps"],
           "k1_from_f32": d_k1, "dense_bf16_from_f32": d_dense,
           "bf16_bound": bound}
    del ref, dense, k1_out
    if name == "bert_base":
        out["ragged"] = _bert_ragged(torch, (params, cfg), (p32, cfg32),
                                     rng, bound)
    return out


def _bert_ragged(torch, model, model32, rng, bound: float) -> dict:
    """Ragged requests from several client threads through a
    ``pass_mask`` engine: each row's real positions against the request
    served alone (a [1, n] forward with every key kept) on the weights
    widened to f32, within the bf16 bound of the K1 check: two bf16
    results may each sit that far from the f32 one; padding that bled
    into a row would not.  The bf16 request served alone is read
    beside it."""
    from tpushare_torch.models import bert

    from tpushare_torch.serving import metrics
    from tpushare_torch.serving.engine import InferenceEngine

    params, cfg = model
    batches0 = metrics.BATCHES.value()
    lens = rng.integers(1, BERT_SEQ + 1, BERT_RAGGED)
    reqs = [rng.integers(1, cfg.vocab, n).astype("int32") for n in lens]
    engine = InferenceEngine(
        lambda t, m: bert.forward(params, t, cfg, attention_mask=m),
        BERT_BATCH, BERT_SEQ, max_wait_ms=5.0, pass_mask=True,
        device="cuda").start()
    sinks = [None] * len(reqs)

    def client(idx):
        for i in idx:
            sinks[i] = engine.submit(reqs[i])

    try:
        threads = [threading.Thread(target=client,
                                    args=(range(c, len(reqs),
                                                BERT_CLIENTS),))
                   for c in range(BERT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows = [s.get(timeout=300) for s in sinks]
    finally:
        engine.stop()
    worst = worst_bf16 = 0.0
    with torch.inference_mode():
        for r, row in zip(reqs, rows):
            check(row is not None, "a ragged request got no result")
            t = torch.as_tensor(r, device="cuda")[None]
            ones = torch.ones_like(t)
            row = row[:len(r)].float()
            alone = bert.forward(model32[0], t, model32[1],
                                 attention_mask=ones)[0].cpu()
            alone_bf16 = bert.forward(params, t, cfg,
                                      attention_mask=ones)[0].float().cpu()
            worst = max(worst, (row - alone).abs().max().item())
            worst_bf16 = max(worst_bf16,
                             (row - alone_bf16).abs().max().item())
    check(worst <= bound, f"ragged rows {worst} from the requests served "
          f"alone in f32, over {bound}")
    return {"requests": len(reqs), "clients": BERT_CLIENTS,
            "lengths": [int(n) for n in lens], "max_from_alone_f32": worst,
            "max_from_alone_bf16": worst_bf16,
            "batches": metrics.BATCHES.value() - batches0,
            "batch_fill_last": metrics.BATCH_FILL.value()}


def phase_bert(torch, card: str, batch_profile: dict):
    from tpushare_torch import bench
    from tpushare_torch.ops import attention as attn

    free, total = torch.cuda.mem_get_info()
    memory = {"allocated_bytes": torch.cuda.memory_allocated(),
              "reserved_bytes": torch.cuda.memory_reserved(),
              "free_bytes": free, "total_bytes": total}
    k1 = _flash_case(torch, attn, BERT_BATCH, 12, 12, BERT_SEQ, 64, False,
                     0, SEED + 300)[1]
    long = _flash_case(torch, attn, BERT_BATCH, 12, 12, 512, 64, False, 0,
                       SEED + 301)[1]
    torch.cuda.empty_cache()
    models = [_bert_model(torch, name)
              for name in ("bert_base", "distilbert_base")]
    torch.cuda.empty_cache()
    # the headline through the bench's own entry point: the main path
    attn.flash_attention_lse.launches = 0
    rec = bench.measure("bert_base", "cuda", profile=False)
    rec["batch_profile"] = batch_profile
    launches = attn.flash_attention_lse.launches
    check(rec["k1_launches_per_batch"] == 12,
          f"bench: K1 {rec['k1_launches_per_batch']} times a batch, not 12")
    check(launches > 0 and launches % 12 == 0,
          f"bench: K1 launched {launches} times, not a multiple of 12")
    for key in ("value", "mfu", "vs_baseline", "ttft_ms", "tpot_ms",
                "qps_offline", "qps_streamed", "naive_qps_batch1"):
        check(isinstance(rec[key], float) and rec[key] > 0,
              f"bench: {key} = {rec[key]}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "memory_at_start": memory, "k1_encoder": k1,
            "k1_max_seq": long, "models": models, "bench": rec,
            "bench_k1_launches": launches}


def phase_cotenancy(torch, card: str):
    from tpushare_torch import probe_cotenancy as pc

    gc.collect()
    torch.cuda.empty_cache()
    res = pc.run()
    check(pc.all_ok(res), "a tenant failed: " + json.dumps(res)[-3000:])
    tenants = list(res["solo"].values())
    for name in pc.SHARED:
        sec = res[name]
        check(sec["mode"] == "shared", f"{name}: {sec['mode']}")
        check(sec["all_within_grant"], f"{name}: a tenant reserved past "
              f"its grant: {[w['peak_reserved_bytes'] for w in sec['workers']]}")
        tenants += sec["workers"]
    for w in tenants:
        check(w["peak_reserved_bytes"] <= w["grant_bytes"]
              and w["enforced"], f"a tenant past its grant: {w}")
    hbm = res["hbm_alloc"]
    check(hbm["all_refused_within_a_chunk"] and hbm["windows_overlap"],
          f"hbm_alloc: ceilings {hbm.get('ceilings_bytes')} against "
          f"{hbm['grant_bytes']}, overlap {hbm.get('windows_overlap')}")
    return {"card": card,
            "duo_vs_solo": res["duo"]["aggregate_vs_solo"],
            "duo_offline_vs_solo": res["duo"]["aggregate_offline_vs_solo"],
            "quad_vs_solo": res["quad"]["aggregate_vs_solo"],
            "quad_offline_vs_solo": res["quad"]["aggregate_offline_vs_solo"],
            "probe": res}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpushare_torch")):
        print("chip_smoke.py: the tpushare_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # the train phase holds ~65 GB of params, grads and moments beside
    # transient GBs of differing sizes: growable segments keep the cache
    # from fragmenting (read when CUDA first initialises)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
        except Exception as e:
            emit({"phase": name, "ok": False, "error": repr(e),
                  "traceback": traceback.format_exc()[-3000:]})
            raise PhaseFailed(name) from e
        res = dict(res)
        res.update({"phase": name, "ok": True,
                    "phase_s": time.perf_counter() - t0})
        emit(res)
        out[name] = res
        return res

    try:
        dev = run("device", phase_device, torch)
        run("build", phase_build)
        from tpushare_torch.utils.cuda_timing import l2_flush_buffer
        flush = l2_flush_buffer()
        k1 = run("k1_flash_fwd", phase_k1, torch, flush)
        k2 = run("k2_paged_attn", phase_k2, torch, flush)
        k34 = run("k3k4_flash_bwd", phase_k3k4, torch, flush)
        sp = run("sp_attention", phase_sp_attention, torch,
                 dev["nvidia_smi"], flush)
        del flush
        torch.cuda.empty_cache()
        srv = run("server", phase_server, torch, dev["nvidia_smi"])
        torch.cuda.empty_cache()
        run("agreement", phase_agreement, torch)
        # the serving phases' model and pool sit in reference cycles until
        # the collector runs (without this, 24.6 GB stay allocated)
        gc.collect()
        torch.cuda.empty_cache()
        shared = {}
        run("dense", phase_dense, torch, dev["nvidia_smi"], shared)
        run("generate", phase_generate, torch, dev["nvidia_smi"], shared)
        spec = run("spec", phase_spec, torch, dev["nvidia_smi"], shared)
        shared.clear()
        gc.collect()
        torch.cuda.empty_cache()
        run("rolling", phase_rolling, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        sps = run("sp_stripe", phase_sp_stripe, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        tp = run("tp", phase_tp, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        tpq = run("tp_quant", phase_tp_quant, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        pp = run("pp", phase_pp, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        run("prefix", phase_prefix, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        mig = run("migrate", phase_migrate, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        ada = run("adapters", phase_adapters, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        moe = run("moe", phase_moe, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        grant = run("grant", phase_grant, torch, dev["nvidia_smi"])
        train = run("train", phase_train, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        shard = run("train_sharded", phase_train_sharded, torch,
                    dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        enc = run("bert", phase_bert, torch, dev["nvidia_smi"],
                  k1["bert_batch"])
        run("cotenancy", phase_cotenancy, torch, dev["nvidia_smi"])
    except PhaseFailed as e:
        print(f"chip_smoke.py: phase {e} failed", file=sys.stderr)
        return 1

    k1m, bwd = k1["main"], k34["main"]
    # K2's two arms, each an entry point a store and a striped one: S > 1
    # (paged_attn.cu) timed at the 2000-token prefill window, S = 1
    # (paged_decode.cu) at decode; launches from the phase that serves
    # that store (server, grant, sp_stripe); no one PyTorch call reads a
    # paged store
    k2_rows = []
    for arm, source, shape, stage in (
            ("attn", "paged_attn.cu", "prefill", PREFILL_STAGE),
            ("decode", "paged_decode.cu", "decode", DECODE_STAGE)):
        for kind, key, line, phase in (
                ("", "", 613, srv), ("_int8", "int8_", 664, grant),
                ("_striped", "striped_", 699, sps["bf16"]),
                ("_int8_striped", "int8_striped_", 722, sps["int8"])):
            case = k2[key + shape]
            counter = f"paged_{arm}{kind}"
            if "striped" in kind:
                counter = (f"launches{'_decode' if arm == 'decode' else ''}"
                           f"{kind}")
            row = {"name": f"paged_{arm}{kind}", "route": "cuda",
                   "source": f"tpushare_torch/ops/csrc/{source}",
                   "replaces": f"tpushare/ops/attention.py:{line}",
                   "launches": phase["launches"][counter],
                   "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                   "kernel_ms": case["ms"], "plain_ms": case["plain_ms"],
                   "bound_ms": case["bound_ms"],
                   "bound_by": case["bound_by"], "library_ms": None,
                   "device_ms": case["device_ms"], "shape": shape,
                   "device_kernels": case["kernels"], "stage": stage}
            if arm == "decode":
                row["n_splits"] = case["n_splits"]
            if kind in ("", "_striped"):
                # the pp phase's staged loads: {"pp": 2}, {"sp": 2, "pp": 2}
                pp_run = pp["sp_pp" if kind else "pp"]
                row["pp_launches"] = pp_run["launches"][
                    f"launches{'_decode' if arm == 'decode' else ''}{kind}"]
            if not kind:
                # the adapters phase's mixed-adapter rounds, the moe
                # phase's mixture-of-experts server
                row["adapter_launches"] = ada["rows"]["k2"][f"paged_{arm}"]
                row["moe_launches"] = moe["server"]["launches"][counter]
                # the moe phase's expert-parallel runs: the ep = 2 rows,
                # the {"pp": 2, "ep": 2} staged batch, the ep = 2 server
                ep = moe["ep"]
                row["ep_launches"] = {
                    "rows": ep["rows"]["k2"][f"paged_{arm}"],
                    "staged": ep["staged"]["k2"][f"paged_{arm}"],
                    "server": ep["server"]["launches"][counter]}
            if arm == "decode" and kind in ("", "_int8"):
                # the migrate phase's decode steps on imported and
                # restored sessions (the spill tier's on bf16 only)
                row["migrate_launches"] = (
                    mig["moved"][kind[1:] or "bf16"]["launches"][counter]
                    + (mig["spill"]["launches"][counter] if not kind
                       else 0))
            k2_rows.append(row)
    # the S > 1 arm at the verify shape, launched by the spec phase's
    # server once a layer of each verify forward; its other S > 1
    # launches there are the prefills'
    ver = k2["verify"]
    k2_rows.append({
        "name": "paged_attn_verify", "route": "cuda",
        "source": "tpushare_torch/ops/csrc/paged_attn.cu",
        "replaces": "tpushare/ops/attention.py:613",
        "launches": spec["verify_launches"],
        "s_gt_1_launches": spec["launches"]["paged_attn"],
        "prefill_launches": (spec["launches"]["paged_attn"]
                             - spec["verify_launches"]),
        "verify_forwards": spec["verify_forwards"],
        "max_abs_err": ver["max_abs_err"], "ms": ver["ms"],
        "kernel_ms": ver["ms"], "plain_ms": ver["plain_ms"],
        "bound_ms": ver["bound_ms"], "bound_by": ver["bound_by"],
        "library_ms": None, "device_ms": ver["device_ms"],
        "shape": "verify", "contexts": ver["contexts"], "S": ver["S"],
        "device_kernels": ver["kernels"], "stage": PREFILL_STAGE})
    # K2's decode arm at the tp phase's per-shard shape (8 rows of 2000
    # tokens, 16 q and 4 kv heads); launches from the tp phase's bf16
    # load, every one at that head count
    ks = k2["tp_shard"]
    k2_rows.append({
        "name": "paged_decode_tp_shard", "route": "cuda",
        "source": "tpushare_torch/ops/csrc/paged_decode.cu",
        "replaces": "tpushare/ops/attention.py:613",
        "launches": tp["bf16"]["launches"]["launches_decode"],
        "s_gt_1_launches": tp["bf16"]["launches"]["launches"],
        "int8_launches": tp["int8"]["launches"]["launches_decode_int8"],
        "tp_sp_launches": tp["tp_sp"]["launches"]["launches_decode_striped"],
        # the pp phase's {"tp": 2, "pp": 2} load, at the same heads
        "pp_launches": pp["tp_pp"]["launches"]["launches_decode"],
        # the tp_quant phase's loads on int8 and int4 weights split over
        # tp, at the same heads
        "tp_quant_launches": {
            k: tpq[k]["launches"]["launches_decode"] for k in ("int8",
                                                               "int4")},
        "max_abs_err": ks["max_abs_err"], "ms": ks["ms"],
        "kernel_ms": ks["ms"], "plain_ms": ks["plain_ms"],
        "bound_ms": ks["bound_ms"], "bound_by": ks["bound_by"],
        "library_ms": None, "device_ms": ks["device_ms"],
        "shape": "decode, tp shard", "contexts": ks["contexts"],
        "H": ks["H"], "Hkv": ks["Hkv"], "n_splits": ks["n_splits"],
        "device_kernels": ks["kernels"], "stage": DECODE_STAGE})
    bwd_kernels = []
    for name, kern, line, outs in (("flash_bwd_dkv", "dkv", 180, "dk dv"),
                                   ("flash_bwd_dq", "dq", 248, "dq")):
        bwd_kernels.append({
            "name": name, "route": "cuda",
            "source": "tpushare_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"tpushare/ops/attention.py:{line}",
            "launches": train["launches"][name],
            "qlora_launches": train["qlora"]["launches"][name],
            # the tp_quant phase's QLoRA steps on {"tp": 2}
            "tp_qlora_launches": tpq["qlora"]["launches"][name],
            # the train_sharded phase: the 1F1B gradient and the three
            # sharded trainers
            "train_sharded_launches": shard["launches"][name],
            "train_sharded_launches_per_step": {
                "pipeline": shard["pipeline"]["launches"][name],
                **{k: shard[k]["launches_per_step"][name]
                   for k in ("pp", "dp_pp", "fsdp_tp")}},
            "max_abs_err": max(bwd["max_abs_err"][o] for o in outs.split()),
            "ms": bwd[f"{kern}_ms"], "kernel_ms": bwd[f"{kern}_ms"],
            # one plain function and one library backward compute K3 and
            # K4 together: their times cover both kernels
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{kern}_bound_ms"],
            "bound_by": bwd[f"{kern}_bound_by"],
            "library_ms": bwd["library_ms"],
            "device_ms": bwd[f"{kern}_device_ms"],
            "library_device_ms": bwd["library_device_ms"],
            "library_kernel": bwd["library_kernel"],
            "sp_attention_launches": sp["launches"][name],
            # forward_pipelined's gradient in the pp phase
            "pp_launches": pp["grads"]["launches"][name],
            "tflops": bwd[f"{kern}_tflops"],
            "bound_share": bwd[f"{kern}_bound_share"],
            "long_device_ms": bwd["long"][f"{kern}_device_ms"],
            "long_bound_ms": bwd["long"][f"{kern}_bound_ms"],
            "long_library_device_ms": bwd["long"]["library_device_ms"],
            # the port's whole backward through autograd (dvec, K3, K4)
            # against the library backward, like for like
            "backward_device_ms": bwd["backward_device_ms"],
            "long_backward_device_ms": bwd["long"]["backward_device_ms"],
            "plain_and_library_cover": "flash_bwd_dkv+flash_bwd_dq"})
    emit({"kernels": [
        # ms and library_ms by events around the call (host time in the
        # launch path included); device_ms and library_device_ms the
        # kernels' own time by the profiler; long_* at S = 8192
        {"name": "flash_fwd", "route": "cuda",
         "source": "tpushare_torch/ops/csrc/flash_fwd.cu",
         "replaces": "tpushare/ops/attention.py:109",
         "launches": srv["launches"]["flash_fwd"],
         "max_abs_err": k1m["max_abs_err"], "ms": k1m["ms"],
         "kernel_ms": k1m["ms"],
         "plain_ms": k1m["plain_ms"], "bound_ms": k1m["bound_ms"],
         "bound_by": k1m["bound_by"], "library_ms": k1m["library_ms"],
         "device_ms": k1m["device_ms"],
         "library_device_ms": k1m["library_device_ms"],
         "library_kernel": k1m["library_kernel"],
         "tflops": k1m["tflops"], "bound_share": k1m["bound_share"],
         "long_device_ms": k1m["long"]["device_ms"],
         "long_library_device_ms": k1m["long"]["library_device_ms"],
         "long_bound_ms": k1m["long"]["bound_ms"],
         "long_tflops": k1m["long"]["tflops"],
         # the encoder's shape (B = 32, 12 heads, S = 128, D = 64,
         # non-causal); launches from the bench's run in the bert phase
         "bert_launches": enc["bench_k1_launches"],
         "bert_max_abs_err": enc["k1_encoder"]["max_abs_err"],
         "bert_ms": k1["encoder"]["ms"],
         "bert_plain_ms": k1["encoder"]["plain_ms"],
         "bert_device_ms": k1["encoder"]["device_ms"],
         "bert_bound_ms": k1["encoder"]["bound_ms"],
         "bert_bound_by": k1["encoder"]["bound_by"],
         "bert_library_ms": k1["encoder"]["library_ms"],
         "bert_library_device_ms": k1["encoder"]["library_device_ms"],
         # the moe phase's /score, the train phase's QLoRA steps
         "moe_launches": moe["server"]["launches"]["flash_fwd"],
         # the ep = 2 server's /score, through the sharded mixture
         "ep_launches": moe["ep"]["server"]["launches"]["flash_fwd"],
         "qlora_launches": train["qlora"]["launches"]["flash_fwd"],
         "tp_qlora_launches": tpq["qlora"]["launches"]["flash_fwd"],
         # the train_sharded phase: the 1F1B gradient at 4 microbatches,
         # then the sharded trainers' steps
         "train_sharded_launches": shard["launches"]["flash_fwd"],
         "train_sharded_launches_per_step": {
             "pipeline": shard["pipeline"]["launches"]["flash_fwd"],
             **{k: shard[k]["launches_per_step"]["flash_fwd"]
                for k in ("pp", "dp_pp", "fsdp_tp")}},
         # the sp_attention phase's ring and Ulysses runs, alone and
         # through forward(attention_fn=)
         "sp_attention_launches": sp["launches"]["flash_fwd"],
         # the pp phase's forward_pipelined and its gradient
         "pp_launches": pp["forward"]["k1_launches"],
         "pp_grad_launches": pp["grads"]["launches"]["flash_fwd"]},
        *k2_rows,
        *bwd_kernels,
    ]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
