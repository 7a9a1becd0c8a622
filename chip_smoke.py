#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``starflashattention_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: prints the card's name and power limit, then builds
   every kernel in ``starflashattention_tpu_torch/csrc`` with ``nvcc`` for
   sm_90a, one process per source, all at once.
2. Kernel vs plain: each kernel against its plain PyTorch twin on the card
   (the paged decode and the paged append on a shuffled page table; the
   decode paths' row append folded into the decode launch and the verify
   path's block append into the verify launch, ``[fold]`` lines: bit for
   bit the standalone append then the decode or the verify, output and
   whole tables, at the decode and verify shapes and in 129 forms of the
   kernel (D 64, 128, 256 and 640; fp32 / bf16 q; fp32, bf16, int8 and fp8
   KV; 1 and 4 splits, paged, verify spans of T 5; plain and with the
   window, sinks and softcap; inactive, clamped, chunk-edge and
   tile-straddling rows), timed beside the attention alone and beside the
   append followed by the attention; an empty kernel's launch, the floor
   of the launch-bound appends),
   in bf16 at the shapes the 7B-GQA path gives it, with the error printed
   beside its tolerance; kernel, plain and library-call times (CUDA events,
   L2 flushed before each launch, the device kept busy while the host
   enqueues it) beside the byte / operation bound. The quantized kernels
   too: int4 weight-only matmul (small-M at 16 rows, tiled at 2048) on the
   five 7B shapes with g128 scales, W8A8 and W4A8 at 2048 rows on the four
   layer shapes (bound at the int8 tensor-core rate; W8A8 byte for byte
   its twin, there and at a TP-4 rank's four shapes), decode attention
   (fused and split) and paged decode on int8 and on fp8 KV (scales 5/127
   and 5/448), and the appends on 1-byte rows. The decode-row matmuls (K4
   int8 and fp8, K6; their split-K form) run each call twice for the same
   bits, and ``[grid]`` lines time ``wo``, ``w_down`` and DeepSeek-V2-Lite's
   expert ``down`` at their default splits beside half and twice as many.
   Speculative decoding's
   kernels at its verify step's shapes (B=8, T=5): the verify mode of the
   decode attention on bf16 and int8 KV, each query token also held bit for
   bit to the fused decode at lengths + j, and the block append, standalone
   and folded into the verify launch. The
   training kernels: the prefill attention with the base-2 LSE (checked
   causal and not, on ragged lengths with a zero-length sequence and q
   offsets, then timed at phase 9a's shapes against SDPA's forward) and the
   two FA2 backward kernels (dq; dk/dv), checked on the same inputs and at
   B=2, S=2048, run twice for equal bytes, timed against SDPA's backward
   (its forward + backward less its forward); dq also at head_dim 64 and
   256 on the ragged inputs (G 1, 2, 4, 8). The attention variants at
   S = 8192 with lengths 5,000-8,000 (past the 4096 window): K1 with the
   window and 4 sinks at Mistral-7B's shapes, K1 at head_dim 256 with
   softcap 50 on a sliding and a full Gemma-2-9B layer, K1's verify mode
   with both (token j bit for bit the decode at lengths + j), K2 at head_dim
   256 with 4 splits (Gemma-7B), K7 on both families' rows in 128-row pages
   and K5 on 2048-row chunks (PagedEngine's) at offsets 4608 and 6144, each
   within 2 (decode) or 3 (K5) bf16 ulps of each element of its twin. The
   decode rows at head_dim 64, 128 and 256 run ``csrc/flash_decode_split.cu``
   (the KV walk split into chunks, one block each, merged by the last block;
   the quantized KV's scales folded in the kernel) and print their GB/s,
   share of the bound and chunk grid; each merging row at head_dim 128 is
   also timed on a coarser grid (chunks twice as long), and the plain
   decode once more in the kernel's VARIANTS form (a window as long as the
   table, which masks nothing: bit for bit the plain form's output), the
   cost of the variants as runtime arguments; the tiled int4 and int8 rows
   print TFLOP/s and share of the bound per shape, the W8A8 / W4A8 rows TOPS
   of the kernel alone, and a split of their entry time into the row
   quantization and the kernel; the tiled int8 matmul is also timed on fp8
   weights (no path serves those: logged, not in the kernels line).
   Gemma-2's q is scaled so that its scores reach several times the cap,
   and the kernel without the cap (K1, K7, K5), or without the sinks
   (Mistral's K1 and K5), must lie over 4x that tolerance from the twin,
   so the check sees each option. Each windowed one also passes a band
   check: every whole 256-row block below each row's band (sink blocks
   spared) is filled with NaN, or for K7 its pages are set to the null
   page filled with NaN, and the output must be finite and bit for bit the
   clean cache's. The bounds count only the in-band rows and pairs; the
   library call is SDPA with the band mask, or with a softcap one compiled
   ``flex_attention`` call (the cap as its score_mod, the band as its
   block mask), held to the twin like the kernel. The training forms of
   the variants at phase 11's shapes (B=1, causal rows from 0): K5 with
   the LSE and both K12 kernels with window 4096 and 4 sinks (Mistral-7B,
   S 8192; the sinks made heavy, see ``_sink_heavy``), with softcap 50 at
   head_dim 256 on a sliding (window 4096) and a full Gemma-2-9B layer (S
   6144, q scaled so that the cap bends the scores) and at head_dim 256
   without options (Gemma-7B, Hq = Hkv = 16, S 4608): each held to its
   twin (the output within 3 bf16 ulps of each element, the LSE within
   1e-4, each gradient within 2e-2 of its peak), K12 run twice for equal
   bytes, and each option shown to move the result (the same kernels
   without it lie over 4x each tolerance from the twins); timed beside a
   compiled ``flex_attention`` forward and forward + backward (SDPA's for
   Gemma-7B), the bounds counting the in-band pairs; the banded K12's
   time is printed beside the unbanded one's at Mistral's shape. MLA's
   latent geometry (DeepSeek-V2-Lite: 16 query heads on one 640-lane latent
   KV head, sm_scale 192 ** -0.5): K1 at B 4, S 4096, lengths 2,000-4,064
   (with ``[grid]`` and ``[merge]`` lines: chunks half and twice the grid's,
   and a partials-only launch at its grid), K2 with 4 splits on the same
   rows (its partials held to the twin's), K7 on the same rows in 128-row
   shuffled pages and K5 on 2048-row causal
   chunks at offsets 0 and 2048, each within 2 (decode) or 3 (K5) bf16
   ulps of each element of its twin, and each shown to see the shape (with
   q's rope lanes zeroed, or its heads rolled by 8, the kernel lies over 4x
   that tolerance from the twin); library SDPA with the mask; then K5 at
   D 640 with 2, 4 and 6 query heads a KV head on lengths and offsets off
   its 32-key tiles (``LATENT_GROUP_ROWS``), each within 3 ulps. The expert
   stacks at 4 decode rows through the (L * E, ...) view at index lidx * E
   + e: K6 on DeepSeek-V2-Lite's int4 g128 experts and K4 on Mixtral-8x7B's
   int8 experts, against their twins (``EXPERT_STACKS``). Ring context
   parallelism's ``kv_offset``: K5 with the LSE and both K12 kernels at one
   step of phase 13a's Mistral-7B ring (B=1, the q chunk of rows
   16384-24575 on the KV chunk of rows 8192-16383: ``q_offsets`` and
   ``kv_offset`` 8192, window 4096, 4 sinks), after the ring's empty
   chunks (a KV chunk in the rows' future, a sequence of length 0: 0, the
   LSE 3e38 and zero gradients, equal to the twins), held to their twins
   with the offset (the output within 4 bf16 ulps of each element, the LSE
   within 1e-4, each row of dq, dk and dv within 2e-2 of its own scale),
   and the kernels given the raw sinks (``kv_offset`` 0) shown to lie far
   from them (the first keys of every chunk made heavy); the library call
   is a compiled ``flex_attention`` with the offset sink mask. K13
   (``fused_mlp``) at 7B-GQA's MLP (H 4096, I 11008, an (L 32, ...) stack,
   layer 16) and a TP-4 shard's (I 2752): B 1, 16 and 64, int8 and fp8
   weights, fp32 and bf16 x, each within 2e-5 (fp32 x) or 4e-3 (bf16 x: the
   activation's bf16 rounding) of each row's peak of ``fused_mlp_plain``,
   timed beside two K4 calls with ``silu * up`` between them and bf16
   ``torch.matmul`` on dequantized weights, against the 3 H I weight bytes;
   then K13's own path (the 32 MLPs of a B=16 decode step), counted.
3. Slice: full-width ``ModelConfig.llama_7b_gqa`` (32 layers,
   max_seq_len 1024, random int8 weights and int8 lm_head from a seeded
   generator, bf16 KV cache): greedy ``generate`` on 8 ragged prompts for
   32 tokens, at ``num_splits=1`` and at the default split count. Launch
   counters are zeroed just before each run and must equal the expected
   counts just after; prefill and decode are then timed on their own.
4. Path vs path: 4 layers at full width, one prefill and 4 decode steps
   through the kernels and through the plain versions; logits compared.
   Twice: int8 weights with a bf16 cache, then int4 g128 weights + int4
   lm_head with an int8 cache and ``w8a8_prefill`` on (W4A8 prefill; the
   KV quantization, scale folds and dequantized prefill rows run on the
   card around the kernels or their twins).
5. Only with ``--phases ...,5``: bench.py's decode chains (B=16, every
   sequence at 512 cache rows: int8 weights with a bf16 cache at one and at
   four splits, then int4 g128 weights and lm_head with an int8 cache)
   timed, then traced with torch.profiler for device time by kernel and
   the device's idle share.
6. Serving: full-width ``ModelConfig.llama_7b_gqa`` (32 layers,
   max_seq_len 1024, seeded random int8 weights + int8 lm_head, bf16 KV):
   24 greedy requests (a shared 256-token system prefix plus a ragged
   16-384-token suffix, 32 new tokens each) through ``Engine`` (8 slots, 8
   steps a round), then through ``PagedEngine`` (page_size 128,
   prefill_chunk 256, prefix cache, a pool small enough to preempt). Launch
   counters are zeroed before and checked after each run (the paged run
   launches the paged decode, its row append folded in, once per layer and decode
   step, the contiguous run neither); every request must finish, the paged
   run must preempt and hit the prefix cache at least once. Prints both
   ``EngineStats`` summaries, the share of streams the two engines agree on
   and their largest chosen-token logprob difference over the agreeing
   prefixes; then a sampled ``PagedEngine`` run (temperature 0.8, top_p
   0.95) twice with the same seeds must give identical streams.
7. Quantized slice: full-width ``ModelConfig.llama_7b_gqa`` (32 layers,
   max_seq_len 1024, int8 KV cache) with seeded random int4 g128 weights
   and an int4 lm_head, greedy ``generate`` on phase 3's 8 prompts for 32
   tokens three times: ``w8a8_prefill`` off (one split: fused decode
   attention), on (the 2048-row prefill on W4A8), and with int8 weights,
   ``w8a8_prefill`` on and an fp8 KV cache (the prefill on W8A8). Launch
   counters are zeroed before and checked after each run (per decode step
   129 int4 or int8 weight-only launches and 32 quantized attentions; per
   prefill 128 W4A8 / W8A8 or tiled launches); prefill and decode are
   timed apart. Then ``PagedEngine`` with int8 pages and int4 weights on
   phase 6's 24 requests: every request finishes, the paged decode and
   append (folded into the decode's launch) run on the int8 pools.
8. Speculative decoding: full-width ``ModelConfig.llama_7b_gqa`` (32
   layers, max_seq_len 1024, seeded int8 weights + int8 lm_head, bf16 KV,
   one split), 16 structured requests (a 24-token motif, an 8-token body,
   the motif, half the body, the motif) for 64 new tokens each, through a
   plain ``Engine`` (8 slots, 4 steps a round), then ``Engine(spec_decode=4,
   spec_ngram=4)``, the same with a 2-layer draft model of the same width
   (int8, another seed), and ``spec_decode=4`` on an int8 KV cache. Launch
   counters are zeroed before and checked after each run (per verify step
   32 verify attentions, each with the block append folded in, and 129
   small-M projections; no standalone block append and no one-row append
   from the target); every request finishes and every spec run takes
   speculative steps; each run's greedy streams print a sha256 digest; 4
   prompt-lookup verify steps of 8 requests run under torch.profiler
   (launches, device busy and idle share a verify step). A
   teacher-forced tie check feeds each spec
   run's streams to the plain decode route on the kernels: every emitted
   token's logit lies within 2% of its row's logit range of the row's
   maximum. Prints the stats, the accept-per-step, the share of streams
   equal to the plain run's, the exact-argmax share and decode tokens/s.
9. Training: ``ModelConfig.llama_7b_gqa(max_seq_len=2048)`` in bf16 (32
   layers, seeded random init), one seeded (2, 2049) token batch. 9a: three
   ``train.train_step`` (SGD, momentum 0.9, lr 1.0, remat): finite losses
   that fall, and per step 64 attention forwards with the LSE (remat reruns
   each layer's forward), 32 dq and 32 dk/dv launches and nothing else;
   ms a step, tokens/s, peak memory, then one step under torch.profiler
   (device time: attention forward, attention backward, matmuls, other;
   the idle share). 9c: LoRA rank 16 on wqkv, wo, w_gate_up and w_down
   (fp32 adapters on the frozen bf16 base), three plain SGD steps (lr 1)
   on the factors: the loss falls and the base's bytes do not change; then
   ``lora.merge``, whose ``llama.prefill`` logits at each prompt's last
   position agree with the adapted ``forward_train`` within 5% of the
   largest logit, and greedy ``llama.generate`` on phase 3's 8 prompts for
   16 tokens through the kernels. 9b: a 2-layer model of the same width at
   B=1: every parameter's gradient through the kernels against plain
   attention's, within 5e-2 of its peak.
10. Attention variants at full width (seeded random init, int8 projection
   weights, bf16 KV, max_seq_len 8192). (a) ``ModelConfig.gemma2_9b`` (42
   layers, hidden 3584, 16 / 8 heads at head_dim 256, vocab 256000, tied
   head, softcaps 50 / 30, a 4096 window on every second layer): 4 prompts
   of 4,500-6,000 tokens, 16 greedy tokens each, through ``generate``,
   ``Engine`` (4 slots, 8 steps a round), ``PagedEngine`` (page 128,
   prefill chunk 2048) and ``Engine(spec_decode=4)`` with prompt lookup;
   launch counts checked per run (the sliding layers' launches apart), the
   two engines' streams compared as in phase 6, the spec streams
   teacher-forced as in phase 8, no page reclaimed. (b)
   ``ModelConfig.mistral_7b(attention_sinks=4, num_splits=1)`` (window
   4096): 4 prompts of 5,200-5,800 tokens through ``Engine`` and
   ``PagedEngine`` (``debug_validate`` on): each round's reclaimed pages and
   pinned sink pages are recorded; at least one walk block of pages must be
   reclaimed and each reclaiming slot must hold its sink pages at the head
   of its table row with null entries behind them; the paged streams are
   compared with the Engine's and teacher-forced on the contiguous route;
   then ``Engine`` once more with its decode attention fed the paged
   kernel's rounding of q * sm_scale to bf16: its streams must equal
   ``PagedEngine``'s.
   (c) ``ModelConfig.gemma_7b`` (head_dim 256, 16 / 16 heads, 4 splits):
   ``generate`` on 4 prompts of 1,000-1,500 tokens (K2). (d) 4 Gemma-2
   layers, phase 4's check on 2 prompts of 4,500 and 4,700 tokens (sliding
   and full layers past the window). Prints TTFT, decode tokens/s and each
   sub-phase's seconds.
11. Training on the attention variants at full width (bf16, seeded random
   init; each model freed before the next). (a) ``ModelConfig.mistral_7b()``
   as published (32 layers, window 4096): three ``train.train_step`` (SGD,
   momentum 0.9, lr 1.0, remat) on one seeded (1, 8193) batch, so that the
   rows past 4096 attend a band: finite losses that fall, and per step 64
   banded K5 forwards with the LSE, 32 banded dq and 32 banded dk/dv
   launches and nothing else; ms a step, tokens/s, peak memory, then one
   step under torch.profiler (device time by kind, the idle share). (b)
   ``ModelConfig.gemma2_9b()`` (42 layers, 21 sliding at window 4096, 21
   full; softcaps 50 / 30, head_dim 256, vocab 256000): LoRA rank 16 on the
   four targets, three SGD steps (lr 1) on a seeded (1, 6145) batch: the
   loss falls, the base's bytes do not change (checksums), and per step
   the sliding layers launch 42 banded K5 forwards and 21 banded dq and
   dk/dv, the full layers as many unbanded; then ``lora.merge``: the
   merged model, cut to its first 4 layers, gives ``llama.prefill`` logits at the
   last positions of 2 prompts of 4,500 and 4,700 tokens within 5% of the
   largest logit of the adapted ``forward_train``'s (see
   MERGE_CHECK_LAYERS); printed beside it, at all 42 layers, the serving
   prefill (fp32 projections) against ``forward_train`` (bf16 projections)
   on the base and on the merged model and the merge's rounding; then
   greedy ``llama.generate`` of 8 tokens on the prompts through the
   kernels. (c) 2 layers at full width, B=1, S=4608: every
   parameter's gradient through the kernels against plain attention's,
   within 5e-2 of its peak, for Mistral-7B with 4 sinks, Gemma-2-9B (layer
   0 sliding, layer 1 full) and Gemma-7B (head_dim 256, G 1). Prints each
   sub-phase's seconds.

12. DeepSeek-V2 and Mixtral (MoE, MLA). (a) ``ModelConfig.deepseek_v2_lite
   (max_seq_len=4096)`` as published (27 layers, hidden 2048, 16 heads on
   one 640-lane latent KV head, 64 routed experts top-6 with DeepSeek's
   router, 2 shared experts, a dense first layer of 10944, vocab 102400),
   seeded random init with its routed experts and ``wo`` quantized to int4
   g128 and the rest bf16 (the JAX package's bench), a bf16 latent cache:
   4 prompts of 1,000-3,000 tokens, 32 greedy tokens each, through
   ``generate``, ``Engine`` (4 slots, 8 steps a round) and ``PagedEngine``
   (128-row pages, 2048-row prefill chunks), launch counts checked per run
   (per step 27 K1 or K7 and K3 or K8 launches and 3,355 K6 launches: ``wo``
   and gate_up and down of each of the 64 experts of the 26 MoE layers);
   the engines' streams equal generate's, or pass phase 8's teacher-forced
   tie check; TTFT and launches a step, and K5's device ms a prefill (its
   launches a prefill times one K5 call at generate's prefill shape, CUDA
   events). (b) The JAX package's decode chain
   (benchmarks/bench_suite.py:1180-1212): B 4 at 4096 - 33 rows, 32 greedy
   steps on the host clock, then 8 traced (device busy and idle shares,
   K1's device ms a step), beside its byte accounting's bound; peak
   memory. Then 4 full-width
   layers against the plain route (phase 4's check). (c)
   ``ModelConfig.mixtral_8x7b`` at full width cut to 2 layers, int8
   weights, experts (K4 at lidx * E + e) and lm_head, bf16 KV: ``generate``
   and ``Engine`` on 4 prompts of 200-600 tokens, 16 tokens each, counts
   checked, streams equal or tie-checked. The lines with phase 12's
   numbers carry the card's name and power limit.
13. Sequence parallelism: a world of 4 processes on this one card over
   gloo (``torch.multiprocessing.spawn``; every library is built in phase 1,
   before the spawn, so the ranks only load them; gloo takes CPU tensors,
   so ``parallel/comm.py`` copies every rotated chunk and reduction through
   the host). Each check runs on every rank, and a rank that fails fails
   the phase. (a) ``parallel.ring`` at 7B-GQA's attention widths (Hq 32, Hkv
   8, D 128, bf16), B=2, S=32768 (8192 rows a rank), lengths [32768, 27000]:
   the contiguous forward and backward, the zigzag forward, and Mistral-7B's
   window 4096 with 4 sinks (the first keys of every chunk made heavy)
   forward and backward; each rank's output (valid rows) within 2e-2 and its
   dq, dk, dv within 5e-2 of the peak of one process's K5 (with the LSE) and
   K12 on the whole sequence; the ring given the raw sinks on every chunk
   (``kv_offset`` ignored) lies over 4x the tolerance away on ranks 1-3;
   the causal ring's forward and backward once more under torch.profiler
   (each rank traces its own device work; rank 0 logs it by kind, with the
   host copies apart). (b)
   ``parallel.ulysses`` at the same shapes, forward and gradients. (c)
   ``make_seq_sharded_decode`` at B=16, 7B-GQA heads, 32768 cache rows
   (8192 a rank), lengths 20,000-32,768, bf16 and int8 KV, head_chunks 1
   and 2, against K1 and against the plain twin on the whole cache (2 or 3
   bf16 ulps), and each rank's K2 partials (o, m, l) on its shard against
   their plain twin (1e-4, as in phase 2). (d)
   ``make_cp_train_step`` on ``ModelConfig.mistral_7b`` with 4 sinks at full
   width cut to 2 layers (four ranks share the card's memory), B=1, S=32768:
   the first step's loss and every gradient within 5e-2 (of each gradient's
   peak) of rank 0's single-process ``loss_and_grads`` through the kernels,
   then 2 more SGD steps (lr 1.0): the loss falls, and one more step
   traced as in (a); then CP x DP on the 2 x 2
   (data, seq) mesh at B=2, S=16384, held to the single process likewise.
   Every run checks each rank's launch counts (K5 with the LSE, K12, their
   banded and ``kv_offset`` launches; K2 in (c)); prints ms a step (host
   clock), tokens/s, peak memory and the bytes copied through the host a
   step. Its wall times include the host copies of gloo and are no guide to
   NCCL, which the same code uses across cards without them (not run here:
   the machine has one card).
14. Tensor, expert and pipeline parallelism: a world of 4 processes on
   this one card over gloo, as phase 13. (a) ``ModelConfig.llama_7b_gqa``
   at full width cut to 8 layers (int8 weights + int8 lm_head, bf16 KV, one
   split), TP 4 (``parallel.tp``): prefill and 31 decode steps of phase
   3's prompts, every rank's streams equal bit for bit and teacher-forced
   on one process (rank 0); 4 layers against one process (phase 4's 5%);
   W8A8 and W4A8 (int4 with 64-row groups) prefills at 4 layers: layer
   0's ``wo`` row scales bit for bit one process's, ``w_down``'s those of
   the full rows gathered from the shards. (d) PP 4 and PP 2 x TP 2
   decode steps against one process. (b) ``Engine``, ``Engine(spec_decode
   =4)`` and ``PagedEngine`` on the (data 2, model 2) mesh, 12 requests
   with chunked prefill: every request finishes, streams equal one
   process's engines or pass the tie check. (c) ``mixtral_8x7b`` cut to 2
   layers, int8 experts, 2 experts a rank: tie-checked. (e) TP x DP (B=2,
   S=2048) and TP x CP (S=8192) training of 7B-GQA widths cut to 2 layers:
   the first step's loss and every rank's gradients within 5e-2 of one
   process's, 3 steps lower the loss. (f) MoE training, expert-parallel:
   ``mixtral_8x7b`` at full width cut to 2 layers, bf16, TP 4 (2 whole
   experts a rank) through ``make_tp_dp_train_step`` (B=2, S=2048): the
   first step's loss and every rank's gradients within 5e-2 of one
   process's (the ranks build the whole model for it one at a time), 3
   steps lower the loss. (g) Multi-LoRA serving under the mesh: (b)'s
   ``Engine`` and ``PagedEngine`` with phase 17's 4 adapters (seeded at (a)'s
   8 layers), the requests on adapters 0, 1, 2, 3 and None in turn; streams
   equal one process's multi-LoRA engines or pass the tie check on the
   adapted decode route. Launch counts checked on every rank; step times,
   peak memory and bytes through the host printed; each sub-phase's
   seconds.
15. Checkpoints (``models/checkpoint``). (a) ``ModelConfig.llama_7b_gqa``
   at full width and depth (32 layers, ``max_seq_len`` 1024): a seeded
   dense bf16 tree on the card (norms perturbed from 1), written out as
   the HF state dict a Llama checkpoint holds ((out, in) views of the
   tree, ``_hf_state``), converted back by ``load_hf_state_dict`` and held
   bit for bit, leaf by leaf; both trees quantized to int8 (lm_head too)
   and run through ``generate`` on phase 3's prompt lengths with phase 3's
   launch counts: equal sha256 digests; the converted int8 tree saved by
   ``save_checkpoint`` into a temporary directory and restored by
   ``load_checkpoint`` onto the card: an equal, hashable config, the same
   bits and digest; the GB written. (b) The other routes at published
   widths, 2 layers each: ``qwen2_7b`` (QKV bias), ``phi3_medium`` (fused
   ``qkv_proj`` / ``gate_up_proj``, longrope), ``gemma2_9b`` (norms stored
   as w - 1, four norms, tied head), ``mixtral_8x7b`` (experts) and
   ``deepseek_v2_lite`` (MLA's ``kv_b_proj`` split, shared experts, a
   dense first layer): each bit for bit its source, int8, and ``generate``
   with equal digests and launch counts. Seconds of each step and the peak
   device memory printed.
16. MoE training (``models/train._moe_mlp_train``: Mixtral's routing, the
   experts dense as batched products; bf16, seeded random init, SGD with
   momentum 0.9 at lr 1.0, remat). (a) ``ModelConfig.mixtral_8x7b`` at
   published widths cut to 2 layers, one seeded (2, 2049) batch: three
   ``train.train_step``, finite losses that fall, per step exactly 4 K5
   forwards with the LSE, 2 dq and 2 dk/dv launches and nothing else of the
   port's, every expert of every layer and every router a non-zero
   gradient; ms a step, tokens/s, peak memory; one step under
   torch.profiler: device ms of the expert products (the GEMMs over the
   expert axis, by the ops' input shapes), the other matmuls, the attention
   forward and backward and the rest (routing and glue), the idle share.
   (b) At B=1: every gradient through the kernels against plain attention's
   (``use_flash=False``) within 5e-2 of its peak (phase 9b's rule). (c)
   ``forward_train``'s logits at the last positions of prompts of 2,048
   and 1,536 tokens against the serving ``llama.prefill`` of the same bf16
   tree, within 5% of the largest logit (phase 9c's rule), and the share of
   tokens whose top-2 experts agree between the two routes. (d)
   Qwen3-30B-A3B's geometry (``checkpoint.config_from_hf`` of its published
   config.json's fields, written in the script: hidden 2048, 32 / 4 heads
   of 128, QK-norm, 128 experts top 8 of 768, vocab 151,936) cut to 2
   layers: one step with (a)'s checks, then (b). Each line with a time
   carries the card's name and power limit; each sub-phase's seconds.
17. Multi-LoRA serving (``lora_adapters``, ``Request.adapter``): phase 6's
   model (32 layers, int8 weights and lm_head, bf16 KV) with 4 fp32
   adapters of ranks 8, 16, 32 and 64 on all four projections (``a`` from
   ``lora.init_lora``, ``b`` drawn at ``LORA_B_STD``), stacked once by each
   engine (1.95 GB padded to rank 64). Phase 6's 24 requests on adapters
   0, 1, 2, 3 and None in turn, through a base ``Engine``, then ``Engine``
   and ``PagedEngine`` (phase 6's settings, prefix cache on, the preempting
   pool) with the adapters: (a) every request finishes with phase 6's
   launch counts (the deltas launch none of the port's kernels); (b) the
   base rows' streams equal the base engine's bit for bit (sha256 digests
   printed); (c) 4 layers at full width, one prefill and 4 decode steps of
   5 rows (each adapter and the base) through the kernels and
   ``delta_multi`` against the plain route on the dequantized weights with
   each row's ``a @ b`` merged in fp32, within 5% of the largest logit;
   (d) every adapter changes some of its streams (the shares printed); (e)
   prefix hits only within an adapter (every hit's pages audited against
   the adapter that published them), and the share of equal streams
   between the engines; both engines' streams pass phase 8's tie check on
   the adapted decode route. TTFT p50 and decode tok/s of the three runs beside
   phase 6's when it ran; one traced decode round of 8 steps at B 8 with
   and without the adapters: launches, device busy and idle share a step,
   and the deltas' device time.

Each phase is run alone with ``--phases 1,N`` (17: ``--phases 1,17``).
The line ``[done] seconds by phase`` gives each phase's seconds.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device,
or when the package is not beside the script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
L2_FLUSH_BYTES = 128 * 1024 * 1024  # > the 50 MB L2

SLICE_LAYERS = 32
SLICE_SEQ = 1024
SLICE_BATCH = 8
SLICE_NEW_TOKENS = 32
SEED = 0
PAGE_SIZE = 128

SERVE_REQUESTS = 24
SERVE_PREFIX = 256
SERVE_NEW_TOKENS = 32
SERVE_SLOTS = 8
SERVE_STEPS = 8
SERVE_CHUNK = 256
SERVE_PAGES = 33  # 32 usable pages of 128 rows: fewer than 8 slots' worth, so the pool preempts
# The two engines round bf16 activations at different places (the paged
# decode folds sm_scale into q and rounds it to bf16; chunked prefill attends
# a gathered prefix), and a sum rounded on either side of a bf16 tie carries
# through 32 layers. Phase 4 bounds such drift at 5% of the logit range
# (|logit| ~5 here): a chosen-token logprob may move by about that much.
SERVE_LOGPROB_TOL = 0.25
SPEC_REQUESTS = 16
SPEC_NEW_TOKENS = 64
SPEC_SLOTS = 8
SPEC_STEPS = 4
SPEC_DRAFTS = 4  # T = 5 query tokens a verify step
SPEC_TRACED_STEPS = 4  # phase 8's prompt-lookup verify steps under torch.profiler
SPEC_NGRAM = 4
SPEC_DRAFT_LAYERS = 2
# Random weights give near-tied logits, and the verify step's projections
# run B * T rows where decode runs B (another reduction order in K4's
# tiled path past 64 rows, and in rms_norm), so a spec stream may take the
# other side of a near-tie; the tie check bounds how near: 2% of the row's
# logit range below its maximum.
SPEC_TIE_TOL = 0.02
VAR_PROMPTS = 4
VAR_NEW_TOKENS = 16
VAR_SLOTS = 4
VAR_STEPS = 8
VAR_CHUNK = 2048  # PagedEngine's prefill chunk: a 6000-token prompt in three
TRAIN_SEQ = 2048
TRAIN_BATCH = 2
TRAIN_STEPS = 3
# bf16 SGD: an update far below a weight's bf16 ulp rounds away. The
# lm_head's target columns move by lr * xn / (B * S) a step, about 2.4e-4
# at lr 1 (2 to 4 ulps of weights near 1/64), and raise each target logit
# by about lr * hidden / (B * S) = lr: a visible fall in the loss.
TRAIN_LR = 1.0
LORA_RANK = 16
# fp32 adapters; plain SGD on the factors. At lr 20 the losses went
# 10.857, 9.868, 10.856 and at lr 5 10.857, 9.985, 10.771 (this script on
# an H100 80GB HBM3 at 700 W): the first step gains almost as much at 5 as
# at 20, far past the linear range, and the second overshoots; lr 1 keeps
# the steps nearer the linear range.
LORA_LR = 1.0
LORA_NEW_TOKENS = 16
# bf16 weights and activations on both routes; the kernels round P and dS
# to bf16 (the plain attention keeps fp32) and the differences run back
# through 2 layers of bf16 matmuls: a few bf16 ulps (2^-8) of each peak
TRAIN_GRAD_TOL = 5e-2
QMM_ENTRY = {16: "quant_matmul (small-M, decode rows)", 2048: "quant_matmul (tiled, prefill rows)"}
QMM_FP8_TILED = "quant_matmul fp8 (tiled, prefill rows)"
QMM_FP8_SMALL = "quant_matmul fp8 (small-M, decode rows)"
K5_TRAIN_NO_LSE = "flash_prefill without the LSE (training shape)"  # phase 2 only: the LSE's own cost
K12_SPLIT = "flash_bwd_dkdv (split walks + flash_bwd_dkdv_sum, TP x DP shard)"  # phase 14e's launches
INT4_ENTRY = {16: "quant_matmul_int4 (small-M, decode rows)",
              2048: "quant_matmul_int4 (tiled, prefill rows)"}
A8_ENTRY = {"w8a8": "quant_matmul_w8a8 (prefill rows)", "w4a8": "quant_matmul_w4a8 (prefill rows)"}
KV_SCALE = {"int8": 5.0 / 127.0, "fp8": 5.0 / 448.0}  # ModelConfig.kv_calibration_scale / qmax
# the decode paths' launches with the row append folded in (K3 into K1 / K2,
# K8 into K7) and the verify path's with the block append folded in (K9
# into K1's verify mode): the kernels line's rows of K3, K8 and K9. Each
# carries the append's part of the launch (the fused launch less the
# attention alone) and the attention's row the rest, so a launch counted on
# both rows is timed once.
FOLD_ENTRIES = {
    1: "flash_decode_append (K3 folded into K1, 1 split)",
    4: "flash_decode_append (K3 folded into K2, split-KV partials)",
    "paged": "paged_flash_decode_append (K8 folded into K7)",
    "verify": "flash_verify_append (K9 folded into K1 verify)",
}
FOLD_ROUNDS = 5  # interleaved timer rounds of the [fold] rows
FOLD_SEQ, FOLD_ROWS = 512, ((0, 1), (37, 0), (512 + 5, 512), (128, 129), (0, 0), (127, 128))  # _fold_forms
# _fold_forms' verify spans of T = SPEC_DRAFTS + 1 at FOLD_SEQ, (first write
# position, rows to write): across the 32-row tile edge, across the 128-row
# chunk edge, at the table's start, clamped to S - T from S - 2 and from S,
# a partial span, an inactive row; token 0 attends position + 1 rows
VERIFY_FOLD_ROWS = ((30, 5), (126, 5), (0, 5), (510, 5), (512, 5), (200, 3), (40, 0))
VARIANT_SEQ = 8192  # the families' max_seq_len
VARIANT_WINDOW = 4096  # Mistral-7B's window, Gemma-2's sliding layers'
VARIANT_SINKS = 4
VARIANT_BATCH = 8
GEMMA2_SOFTCAP = 50.0
LIBRARY_ULPS = 8.0  # flex_attention against the twins (its own bf16 roundings)
GEMMA2_Q_SCALE = 40.0  # phase 2's Gemma-2 q: scores of standard deviation 40 at sm_scale 1/16, so the cap bends them
POISON_BLOCK = 256  # the band check poisons whole blocks of this many rows
VARIANT_ENTRIES = {
    "mistral_decode": "flash_decode window 4096 + 4 sinks (Mistral-7B)",
    "gemma2_decode": "flash_decode D256 softcap, window 4096 (Gemma-2 sliding layers)",
    "gemma2_decode_full": "flash_decode D256 softcap, full (Gemma-2 full layers)",
    "gemma2_verify": "flash_verify D256 softcap + window 4096 (Gemma-2)",
    "gemma_split": "flash_decode D256 (split-KV partials, Gemma-7B)",
    "mistral_paged": "paged_flash_decode window 4096 + 4 sinks (Mistral-7B)",
    "gemma2_paged": "paged_flash_decode D256 softcap + window 4096 (Gemma-2)",
    "gemma2_prefill": "flash_prefill D256 softcap + window 4096 (Gemma-2)",
    "mistral_prefill": "flash_prefill window 4096 + 4 sinks (Mistral-7B)",
}
LATENT_BATCH = 4  # phase 12's decode batch (JAX's DeepSeek bench)
DSV2_NEW_TOKENS = 32
DSV2_CHAIN_STEPS = 32  # phase 12b: greedy steps on the host clock, from 4096 - 33 rows
DSV2_TRACED_STEPS = 8
DSV2_CHECK_PROMPTS = (1500, 2500)  # phase 12a's 4-layer check against the plain route
LATENT_SEQ = 4096  # phase 12's max_seq_len
LATENT_CHUNK = 2048  # PagedEngine's prefill chunk in phase 12a
LATENT_GROUP = 16  # DeepSeek-V2-Lite's query heads on its one latent KV head
LATENT_ENTRIES = {
    "decode": "flash_decode D640 G16 (MLA latent row, DeepSeek-V2-Lite)",
    "paged": "paged_flash_decode D640 G16 (MLA latent row, DeepSeek-V2-Lite)",
    "split": "flash_decode D640 G16 (split-KV partials, 4 splits, MLA latent row)",
    "prefill": "flash_prefill D640 G16 causal (MLA latent row, DeepSeek-V2-Lite)",
    "int4_experts": "quant_matmul_int4 experts at lidx*E+e (DeepSeek-V2-Lite int4 g128, 4 rows)",
    "int8_experts": "quant_matmul experts at lidx*E+e (Mixtral-8x7B int8, 4 rows)",
}
# phase 2's expert stacks: (format, experts, layer, expert, ((projection, K, N), ...)), the
# stack holding layers 0..layer so the index lidx * E + e lies near its end
EXPERT_STACKS = {
    "int4_experts": ("int4", 64, 2, 37, (("gate_up", 2048, 2816), ("down", 1408, 2048))),
    "int8_experts": ("int8", 8, 1, 5, (("gate_up", 4096, 28672), ("down", 14336, 4096))),
}
TRAIN_VARIANT_SEQ = {"mistral": 8192, "gemma2": 6144, "gemma": 4608}  # phase 11's (a), (b), (c)
TRAIN_MERGE_PROMPTS = (4500, 4700)  # 11b's merged-model prompts: past the 4096 window
# 11b's merge check runs the first 4 layers (2 sliding, 2 full): through all
# 42 layers of the random-init bf16 Gemma-2-9B, one bf16 rounding moved its
# last-position logits by 1.7-1.9 of 30 whichever route (the serving prefill
# against forward_train on the base model alone: 1.887; this script on an
# H100 80GB HBM3 at 700 W), as much as the adapters' own effect (2.891)
MERGE_CHECK_LAYERS = 4
RING_WORLD = 4  # phase 13's ranks, all on this one card
RING_SEQ = 32768  # phase 13a / 13b: 8192 rows a rank
RING_BATCH = 2
RING_LENGTHS = (32768, 27000)
RING_TOL = 2e-2  # outputs, of the reference's peak: each chunk's output is rounded to bf16 before the fp32 merge
# gradients, of each reference's peak: each chunk's dq / dk / dv is rounded to bf16 before the fp32 sum, and
# with heavy sinks one chunk's partial can be several times the sum (1.8e-2 on dq with the plain twins on the CPU)
RING_GRAD_TOL = TRAIN_GRAD_TOL
RING_ENTRIES = {
    "fwd": "flash_prefill return_lse kv_offset 8192, window 4096 + 4 sinks (ring step, Mistral-7B)",
    "dq": "flash_bwd_dq kv_offset 8192, window 4096 + 4 sinks (ring step, Mistral-7B)",
    "dkdv": "flash_bwd_dkdv kv_offset 8192, window 4096 + 4 sinks (ring step, Mistral-7B)",
}
SHARDED_DECODE = dict(batch=16, seq=32768, lengths=(20000, 32768), num_splits=4, block_k=256)
CP_SEQ = 32768  # phase 13d: B=1 over the 4-rank sequence axis
CP_DP = (2, 16384)  # then (B, S) on the 2 x 2 (data, seq) mesh
CP_LAYERS = 2
CP_STEPS = 3
TRAIN_VARIANT_ENTRIES = {
    "mistral_fwd": "flash_prefill return_lse window 4096 + 4 sinks (Mistral-7B training)",
    "mistral_dq": "flash_bwd_dq window 4096 + 4 sinks (Mistral-7B)",
    "mistral_dkdv": "flash_bwd_dkdv window 4096 + 4 sinks (Mistral-7B)",
    "gemma2_fwd": "flash_prefill return_lse D256 softcap + window 4096 (Gemma-2 training, sliding layers)",
    "gemma2_dq": "flash_bwd_dq D256 softcap + window 4096 (Gemma-2 sliding layers)",
    "gemma2_dkdv": "flash_bwd_dkdv D256 softcap + window 4096 (Gemma-2 sliding layers)",
    "gemma2_full_fwd": "flash_prefill return_lse D256 softcap (Gemma-2 training, full layers)",
    "gemma2_full_dq": "flash_bwd_dq D256 softcap (Gemma-2 full layers)",
    "gemma2_full_dkdv": "flash_bwd_dkdv D256 softcap (Gemma-2 full layers)",
    "gemma_fwd": "flash_prefill return_lse D256 (Gemma-7B training)",
    "gemma_dq": "flash_bwd_dq D256 (Gemma-7B)",
    "gemma_dkdv": "flash_bwd_dkdv D256 (Gemma-7B)",
}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- timing


class Timer:
    """Median time of a callable on the card: CUDA events around each
    launch, with the L2 cache flushed before it (a real caller streams the
    weights and the cache from device memory). A spin of about a
    millisecond keeps the device busy while the host enqueues the start
    event and the call, so the events time the device's work and not the
    wrapper's host time before its first launch."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device):
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound_ms(n_bytes, n_ops, ops_per_s=PEAK_BF16_OPS_PER_S):
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the tensor-core rate of their type (bf16 by default)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log_rate(entry, ms, n_bytes, n_ops, chunks=None, int8=False):
    """A phase 2 row's achieved rate and share of its bound: GB/s for a row
    the bytes bound, TFLOP/s (TOPS on the int8 tensor cores, ``int8``) for
    one the operations bound; ``chunks`` = (N, C) of a split-KV decode
    call's chunk grid."""
    bnd, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS_PER_S if int8 else PEAK_BF16_OPS_PER_S)
    unit = "TOPS" if int8 else "TFLOP/s"
    rate = f"{n_bytes / ms / 1e6:.1f} GB/s" if by == "bytes" else f"{n_ops / ms / 1e9:.1f} {unit}"
    grid = "" if chunks is None else f", {chunks[0]} chunks of {chunks[1]} rows a (sequence, KV head)"
    log(f"[rate] {entry}: {ms:.4f} ms, {rate}, {bnd / ms:.1%} of its bound ({by}){grid}")


# ---------------------------------------------------------------- phase 1


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from starflashattention_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    log(f"[build] {len(built)} sources in {secs:.1f} s (parallel nvcc, sm_90a): "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in built.items()))
    for name, r in built.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", r["ptxas"])]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", r["ptxas"]))
        log(f"[build] {name}: {len(regs)} kernels, registers per thread up to {max(regs, default=0)}, "
            f"spill stores {spills} bytes")
        if name in ("flash_prefill", "flash_bwd"):
            for kernel, regs, spill in _entry_resources(r["ptxas"], _kernel_label):
                smem = _attention_smem(kernel)
                if smem or kernel.split("<")[1].startswith("256") or spill:
                    log(f"[build]   {kernel}: {regs} registers, spill stores {spill} bytes"
                        + (f", {smem} bytes of dynamic shared memory" if smem else ""))
        for label in (_latent_label, _redesign_label):
            for kernel, regs, spill in _entry_resources(r["ptxas"], label):
                smem = (_latent_decode_smem(kernel) or _latent_prefill_smem(kernel) or _split_k_smem(kernel)
                        or _w8a8_smem(kernel))
                log(f"[build]   {kernel}: {regs} registers, spill stores {spill} bytes"
                    + (f", {smem[0]} bytes of dynamic shared memory at {smem[1]}" if smem else ""))
    return smi


def _attention_smem(kernel):
    """The dynamic shared memory (bytes) of a redesigned attention kernel
    (K5's flash_prefill_kernel, K12's flash_bwd_dq_kernel and
    flash_bwd_dkdv_kernel) as its library
    reports it for the head_dim in its label, else None."""
    from starflashattention_tpu_torch.ops import _build, flash_bwd

    name, args = kernel.split("<")
    d = int(args.split(",")[0])
    if name == "flash_prefill_kernel":
        lib = _build.load("flash_prefill", {"flash_prefill_smem_bytes": [_build.I]})
        return lib.flash_prefill_smem_bytes(d)
    if name == "flash_bwd_dkdv_kernel":
        return flash_bwd.dkdv_geometry(d)[2]
    if name == "flash_bwd_dq_kernel":
        return flash_bwd.dq_built_geometry(d, 1)[2]
    return None


def _latent_label(name):
    """The display name of an MLA latent-row form (head_dim 640), else None:
    K5's and the split-KV decode kernel's two D 640 instantiations."""
    if "latent" in name:
        return "flash_prefill_latent_kernel (D 640)"
    if "decode_split_kernel" in name and "Li640E" in name:
        return f"decode_split_kernel<bf16, bf16, 640, {'paged' if 'Li640ELb1E' in name else 'contiguous'}>"
    return None


def _latent_prefill_smem(kernel):
    """(dynamic shared memory bytes, what) of K5's D 640 block as its
    library reports it, for its label, else None."""
    if kernel != "flash_prefill_latent_kernel (D 640)":
        return None
    from starflashattention_tpu_torch.ops import flash_prefill as fp

    rows, keys, _, _, _, ctas, smem = fp.latent_built_geometry(LATENT_GROUP)
    return smem, f"a block of a {ctas}-block cluster, {rows} rows, {keys}-key tiles"


def _latent_decode_smem(kernel):
    """(dynamic shared memory bytes, what) of a D 640 decode block of
    LATENT_GROUP rows as its library reports it, for a split-KV decode
    kernel's D 640 label, else None."""
    if not kernel.startswith("decode_split_kernel<bf16, bf16, 640"):
        return None
    from starflashattention_tpu_torch.ops import _build

    lib = _build.load("flash_decode_split", {"flash_decode_split_smem_bytes": [_build.I] * 2})
    return lib.flash_decode_split_smem_bytes(640, LATENT_GROUP), f"{LATENT_GROUP} rows"


def _split_k_smem(kernel):
    """(dynamic shared memory bytes, what) of a split-K matmul form,
    qmm_split_k<weights, n8 tiles, out> or K13's fused_mlp_split_k<weights,
    n8 tiles> (the same ring), from its mangled name as its library reports
    it, else None."""
    m = re.search(r"(?:qmm|fused_mlp)_split_k(I.*?)Li(\d)E", kernel)
    if m:
        int4, nt = "Int4" in m.group(1), int(m.group(2))
    elif "qmm_split_k_int4_m8" in kernel:  # the int4 form at one n8 tile
        int4, nt = True, 1
    else:
        return None
    from starflashattention_tpu_torch.ops import _build

    lib = _build.load("quant_matmul", {"quant_matmul_split_k_smem": [_build.I] * 2})
    return (lib.quant_matmul_split_k_smem(int(int4), nt),
            f"up to {8 * nt} rows ({'int4' if int4 else 'int8 / fp8'})")


def _w8a8_smem(kernel):
    """(dynamic shared memory bytes, what) of K10's qmm_w8a8_tiled as its
    library reports it, else None."""
    if "qmm_w8a8_tiled" not in kernel:
        return None
    from starflashattention_tpu_torch.ops import quant_matmul as qmm

    rows, cols, stage, smem = qmm.w8a8_built_geometry()
    return smem, f"{rows} x {cols} tiles, stages of {stage} K columns"


def _redesign_label(name):
    """The redesigned kernels by mangled name: the split-KV decode (its D
    640 forms are _latent_label's), the split-K int8 / fp8 / int4 matmul of
    up to 64 rows, K13's bf16-x form on it (fused_mlp_split_k) and the
    tiled int4, int8 / fp8, W8A8 and W4A8 matmuls."""
    kernels = ("decode_split_kernel", "qmm_split_k", "qmm_int4_tiled", "qmm_8bit_tiled", "qmm_w8a8_tiled",
               "qmm_w4a8_tiled", "fused_mlp_split_k")
    return name if any(k in name for k in kernels) and "Li640E" not in name else None


def _entry_resources(ptxas, label):
    """[(label(entry), registers, spill store bytes)] of the entries that
    ``label`` names (not None), from ``nvcc -Xptxas -v`` output."""
    out, kernel, spill = [], None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = label(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def _kernel_label(name):
    """kernel<template args> of a flash_*_kernel entry (args: head_dim, then
    the flags as 0 / 1), else None."""
    m = re.search(r"\d(flash_[a-z_]*_kernel)I((?:L[ib]-?\d+E)+)", name)
    return m and f"{m.group(1)}<{','.join(re.findall(r'L[ib](-?[0-9]+)E', m.group(2)))}>"


# ---------------------------------------------------------------- phase 2


def _check(name, err, tol, what="max_abs_err"):
    ok = err <= tol
    log(f"[kernel] {name}: {what} {err:.3e} (tolerance {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")


def _ulps(out, ref):
    """Largest |out - ref| in bf16 ulps of each element's own value: over
    2^-7 |ref| (an upper bound of its ulp) plus a floor of 1e-3 of the peak
    of its (sequence, head) row, for elements near 0, where the two sides'
    fp32 sums in different orders dominate."""
    out, ref = out.float(), ref.float()
    floor = 1e-3 * ref.abs().amax(dim=-1, keepdim=True)
    return ((out - ref).abs() / (2.0**-7 * ref.abs() + floor).clamp(min=1e-30)).max().item()


def _partial_errors(got, want):
    """K2's split partials (o, m, l) against the plain twin's: fp32 partials
    of the same products summed in another order, so m within 1e-4, l and o
    within 1e-4 relative to l, over the splits that hold a valid position;
    a split that holds none must give l = 0 (0.0 tolerated)."""
    (o, m, l), (o_r, m_r, l_r) = got, want
    live = m_r > -1e30
    return {"m": (m - m_r)[live].abs().max().item(),
            "l (relative)": ((l - l_r) / l_r.clamp(min=1))[live].abs().max().item(),
            "o (relative to l)": ((o - o_r) / l_r.clamp(min=1)[..., None])[live].abs().max().item(),
            "dead splits": float(l[~live].abs().max().item() if (~live).any() else 0)}


def _check_ulps(name, out, ref, roundings):
    """Decode attention, elementwise: each bf16 rounding on either side of
    the other's may cost one ulp of the element's own value, so ``roundings``
    + 1 ulps at most (an error in part of a long row's tiles moves its
    elements by far more)."""
    _check(name, _ulps(out, ref), roundings + 1.0, what="largest error in bf16 ulps of each element")


def _same_bits(name, fn):
    """Two runs of ``fn`` give the same bits (the split-K matmuls sum their
    splits in split order, whichever block arrives last)."""
    a, b = fn(), fn()
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    same = torch.equal(a.view(bits), b.view(bits))
    _check(f"{name} twice", 0.0 if same else 1.0, 0.0, what="runs that differ in a bit")


def _split_k_grid(entry, fn, x, w, scale, layer, out_dtype, half, timer):
    """A ``[grid]`` line: the split-K matmul at its default splits beside
    about half and twice as many (``ops/quant_matmul._launch``'s
    ``splits``; int4 splits hold whole groups, so twice may be as many)."""
    from starflashattention_tpu_torch.ops import quant_matmul as qmm
    from starflashattention_tpu_torch.utils.device import sm_count

    (m, k), n, group = x.shape, w.shape[-1], 2 * half or None
    default = qmm.small_m_grid(m, k, n, group, sm_count(x.device))[1]
    parts = []
    for label, want in (("default", default), ("half", max(1, default // 2)), ("twice", 2 * default)):
        bands, splits, split = qmm.small_m_grid(m, k, n, group, splits=want)
        ms = timer(lambda: qmm._launch(fn, x, w, scale, layer, out_dtype, half, want))
        parts.append(f"{label} {splits} splits of {split} rows ({bands * splits} blocks) {ms:.4f} ms")
    log(f"[grid] {entry} K={k} N={n}: " + "; ".join(parts))


def _arrivals_at_zero():
    """Every split-K workspace's arrival counters are back at zero."""
    from starflashattention_tpu_torch.ops import quant_matmul as qmm

    left = sum(int(ws["arrivals"].abs().sum()) for ws in qmm._SMALL_M_WORKSPACE.values())
    _check("split-K arrival counters after phase 2's matmuls", float(left), 0.0, what="sum")


def _bit_equal(a, b):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(ints[a.element_size()]), b.contiguous().view(ints[b.element_size()])))


def _fold_check(name, tables, fused, sequence, quiet=False):
    """The fused launch on clones of ``tables`` against the standalone
    append followed by the decode or the verify on other clones: the output
    and every table bit for bit (``quiet``: no line unless they differ)."""
    a, b = [t.clone() for t in tables], [t.clone() for t in tables]
    same = _bit_equal(fused(*a), sequence(*b)) and all(_bit_equal(x, y) for x, y in zip(a, b))
    if not (quiet and same):
        _check(f"{name}: fused launch vs the append then the attention, output and whole tables",
               0.0 if same else 1.0, 0.0, what="results that differ in a bit")


def _fold_forms(dev):
    """The fold in every form of the decode kernel, held bit for bit (output
    and whole tables or pools) to the standalone append (K3 / K8) followed
    by the decode (K1, K2 or K7): D 64, 128 and 256 with fp32 and bf16 q on
    a cache in q's dtype, int8 and fp8; MLA's D 640 (bf16, 16 query heads
    on one KV head); the merging mode, the partials mode (4 splits) and
    the paged form on a shuffled table, each plain and, but at 4 splits and
    D 640, in the VARIANTS form (window 64, 4 sinks, softcap 30). The rows
    (``FOLD_ROWS``, S 512): a first token, an inactive row (a stale write,
    0 rows), a write clamped to S - 1, writes on each side of the 128-row
    chunk edge, a length-0 row; the inactive and length-0 rows' table rows
    point at the null page 0 in the paged form, as the engines leave them."""
    from starflashattention_tpu_torch.core.quant import quantize_value
    from starflashattention_tpu_torch.ops.cache_append import append_rows_kv, append_rows_paged_kv
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode, flash_decode_append
    from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_append

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    f32, bf16 = torch.float32, torch.bfloat16
    s, ps, layer = FOLD_SEQ, 16, 1
    wpos = torch.tensor([p for p, _ in FOLD_ROWS], dtype=torch.int32, device=dev)
    lengths = torch.tensor([n for _, n in FOLD_ROWS], dtype=torch.int32, device=dev)
    pos = torch.clamp(wpos, max=s - 1)
    b = wpos.shape[0]
    full = (torch.randperm(b * s // ps, generator=torch.Generator().manual_seed(SEED)) + 1).reshape(b, s // ps)
    full = full.to(device=dev, dtype=torch.int32)
    table = full.clone()
    table[(lengths == 0).nonzero().flatten()] = 0
    variants = dict(window=64, sinks=4, softcap=30.0)
    checks = 0
    for d in (64, 128, 256, 640):
        hq, hkv = (16, 1) if d == 640 else (8, 2)
        combos = ((bf16, None),) if d == 640 else ((f32, None), (bf16, None), (f32, "int8"), (bf16, "int8"),
                                                   (f32, "fp8"), (bf16, "fp8"))
        for q_dtype, mode in combos:
            q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=q_dtype)
            rows = [torch.randn(shape, generator=gen, device=dev, dtype=q_dtype)
                    for shape in ((2, b, hkv, s, d),) * 2 + ((b, hkv, d),) * 2]
            sc = {}
            if mode is not None:
                scales = torch.full((hkv,), KV_SCALE[mode], dtype=f32, device=dev)
                rows = [quantize_value(t, scales, mode, head_axis=2 if t.dim() == 5 else 1) for t in rows]
                sc = dict(k_scales=scales, v_scales=scales)
            k_tab, v_tab, kn, vn = rows
            kv = mode or str(q_dtype).replace("torch.", "")
            forms = [("1 split", dict(num_splits=1)), ("4 splits", dict(num_splits=4))]
            if d != 640:
                forms.append(("window 64 + 4 sinks + softcap 30", dict(num_splits=1, **variants)))
            for label, opts in forms:
                kw = dict(layer=layer, block_k=256, **sc, **opts)
                _fold_check(f"fold D={d} q {q_dtype} KV {kv} {label}", (k_tab, v_tab),
                            lambda k, v: flash_decode_append(q, k, v, kn, vn, wpos, lengths, **kw),
                            lambda k, v: (append_rows_kv(k, v, kn, vn, layer, pos),
                                          flash_decode(q, k, v, lengths, **kw))[1], quiet=True)
                checks += 1
            pools = (_pools_from(k_tab, full, ps), _pools_from(v_tab, full, ps))
            for label, opts in [("paged", {})] + ([] if d == 640 else [("paged, window 64 + 4 sinks + softcap 30",
                                                                        variants)]):
                kw = dict(layer=layer, **sc, **opts)
                _fold_check(f"fold D={d} q {q_dtype} KV {kv} {label}", pools,
                            lambda k, v: paged_flash_decode_append(q, k, v, table, kn, vn, wpos, lengths, **kw),
                            lambda k, v: (append_rows_paged_kv(k, v, kn, vn, layer, table, pos),
                                          paged_flash_decode(q, k, v, table, lengths, **kw))[1], quiet=True)
                checks += 1
            del rows, k_tab, v_tab, pools
    checks += _verify_fold_forms(dev, variants)
    log(f"[fold] {checks} forms of the fused launch equal the append then the decode or the verify, bit for bit")


def _verify_fold_forms(dev, variants):
    """K9 folded into K1's verify launch in every form the verify takes,
    held bit for bit (output and whole tables) to the standalone block
    append at min(pos, S - T) followed by the verify: D 64, 128 and 256,
    fp32 and bf16 q on a cache in q's dtype, int8 and fp8, plain and in the
    VARIANTS form (``variants``), at the spans of ``VERIFY_FOLD_ROWS`` (Hq
    8, Hkv 2, S ``FOLD_SEQ``, 128-row chunks). Its inputs come from a
    generator of its own. -> the number of forms."""
    from starflashattention_tpu_torch.core.quant import quantize_value
    from starflashattention_tpu_torch.ops.cache_append import append_block_kv
    from starflashattention_tpu_torch.ops.flash_decode import flash_verify, flash_verify_append

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    f32, bf16 = torch.float32, torch.bfloat16
    s, t, layer, hq, hkv = FOLD_SEQ, SPEC_DRAFTS + 1, 1, 8, 2
    pos = torch.tensor([p for p, _ in VERIFY_FOLD_ROWS], dtype=torch.int32, device=dev)
    n_valid = torch.tensor([n for _, n in VERIFY_FOLD_ROWS], dtype=torch.int32, device=dev)
    lengths, clamped = pos + 1, torch.clamp(pos, max=s - t)
    b = pos.shape[0]
    checks = 0
    for d in (64, 128, 256):
        for q_dtype, mode in ((f32, None), (bf16, None), (f32, "int8"), (bf16, "int8"), (f32, "fp8"),
                              (bf16, "fp8")):
            q = torch.randn((b, hq, t, d), generator=gen, device=dev, dtype=q_dtype)
            rows = [torch.randn(shape, generator=gen, device=dev, dtype=q_dtype)
                    for shape in ((2, b, hkv, s, d),) * 2 + ((b, hkv, t, d),) * 2]
            sc = {}
            if mode is not None:
                scales = torch.full((hkv,), KV_SCALE[mode], dtype=f32, device=dev)
                rows = [quantize_value(x, scales, mode, head_axis=2 if x.dim() == 5 else 1) for x in rows]
                sc = dict(k_scales=scales, v_scales=scales)
            k_tab, v_tab, kn, vn = rows
            kv = mode or str(q_dtype).replace("torch.", "")
            for label, opts in (("verify", {}), ("verify, window 64 + 4 sinks + softcap 30", variants)):
                kw = dict(layer=layer, **sc, **opts)
                _fold_check(f"fold D={d} q {q_dtype} KV {kv} {label}", (k_tab, v_tab),
                            lambda k, v: flash_verify_append(q, k, v, kn, vn, pos, n_valid, lengths, **kw),
                            lambda k, v: (append_block_kv(k, v, kn, vn, layer, clamped, n_valid),
                                          flash_verify(q, k, v, lengths, **kw))[1], quiet=True)
                checks += 1
            del rows, k_tab, v_tab
    return checks


def _fold_times(timer, fused, alone, seq):
    """The fused launch, the decode alone and the append then the decode,
    each the median of ``FOLD_ROUNDS`` interleaved timer rounds, and the
    append's part of the fused launch: the median of the rounds' fused less
    alone (the kernels line's ms of a ``FOLD_ENTRIES`` row)."""
    rounds = [(timer(fused), timer(alone), timer(seq)) for _ in range(FOLD_ROUNDS)]

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    return (*(median([r[i] for r in rounds]) for i in range(3)), median([r[0] - r[1] for r in rounds]))


def _tables_err(got, want):
    """Largest absolute difference over whole K and V tables (or pools)."""
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def _fold_rows(dev, timer, q, k_tab, v_tab, lengths, layer):
    """K3 folded into K1 (1 split) and K2 (4 splits) at the decode shape:
    each row of the step writes its new row at lengths - 1, the last row it
    attends. The fused launch against K3 then the decode (bit for bit),
    timed beside the decode alone and beside K3 followed by the decode, in
    one call. Its kernels-line row is the append's part of the launch, so
    that K1's (K2's) row, which counts the same launches, keeps the decode's
    time: ms the fused launch less the decode alone, its bound the rows
    written and the write positions read (the fused launch reads the new
    row in place of the table row the decode reads), its plain twin
    ``append_rows_kv_plain`` and its library call an index assignment a
    table, both at the same positions, its error over the whole tables
    against the plain twins'. Its new rows come from a generator of its own,
    so the rows after it in phase 2 draw what they drew before it was
    added."""
    from starflashattention_tpu_torch.ops.cache_append import append_rows_kv, append_rows_kv_plain
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode, flash_decode_append, flash_decode_append_plain

    _, b, hkv, s, d = k_tab.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=q.dtype)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=q.dtype)
    wpos = lengths - 1
    bnd, by = bound_ms(2 * b * hkv * d * q.element_size() + b * 4, 0)
    bidx, wpos_l = torch.arange(b, device=dev), wpos.long()
    res = {}
    ka, va = k_tab.clone(), v_tab.clone()
    kp, vp = k_tab.clone(), v_tab.clone()

    def index_put_kv():  # the library call: one advanced-index assignment a table
        kp[layer, bidx, :, wpos_l] = k_new
        vp[layer, bidx, :, wpos_l] = v_new

    for splits in (1, 4):
        entry = FOLD_ENTRIES[splits]
        kw = dict(layer=layer, num_splits=splits, block_k=256)
        fused = lambda k, v: flash_decode_append(q, k, v, k_new, v_new, wpos, lengths, **kw)  # noqa: E731
        seq = lambda k, v: (append_rows_kv(k, v, k_new, v_new, layer, wpos), flash_decode(q, k, v, lengths, **kw))[1]  # noqa: E731
        _fold_check(f"{entry} B={b} Hq={q.shape[1]} Hkv={hkv} S={s} D={d}", (k_tab, v_tab), fused, seq)
        out = fused(ka, va)
        ref = flash_decode_append_plain(q, kp, vp, k_new, v_new, wpos, lengths, **kw)
        _check(f"{entry} against its plain twin", (out.float() - ref.float()).abs().max().item(), 2.0**-8 * 4)
        err = _tables_err((ka, va), (kp, vp))
        _check(f"{entry} whole tables against the plain twin's", err, 0.0)
        t_fused, t_alone, t_seq, share = _fold_times(timer, lambda: fused(ka, va),
                                                     lambda: flash_decode(q, ka, va, lengths, **kw),
                                                     lambda: seq(ka, va))
        res[entry] = dict(max_abs_err=err, ms=share,
                          plain_ms=timer(lambda: append_rows_kv_plain(kp, vp, k_new, v_new, layer, wpos)),
                          bound_ms=bnd, bound_by=by, library_ms=timer(index_put_kv))
        decode = "K1" if splits == 1 else "K2"
        log(f"[fold] {entry}: fused {t_fused:.4f} ms, {decode} alone {t_alone:.4f} ms, K3 then {decode} "
            f"{t_seq:.4f} ms (medians of {FOLD_ROUNDS} interleaved rounds); the append's part of the fused "
            f"launch {share:+.4f} ms (its bound {bnd:.6f} ms); fused {'below' if t_fused < t_seq else 'NOT below'} "
            f"K3 then {decode}")
    return res


def _launch_floor_ms(dev, timer):
    """The time of one launch of an empty kernel with the kernels' timer:
    the floor a launch-bound kernel sits on."""
    from starflashattention_tpu_torch.ops import _build

    lib = _build.load("cache_append", {"launch_floor": [_build.P]})
    return timer(lambda: _build.check(lib, lib.launch_floor(_build.stream_ptr(dev)), "launch_floor"))


def phase_kernels(dev, timer):
    """Each kernel against its plain twin at main-path shapes; returns
    {entry name: measurements} for the kernels line."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops.cache_append import append_rows, append_rows_kv, append_rows_kv_plain
    from starflashattention_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_plain, flash_decode_with_stats, flash_decode_with_stats_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain
    from starflashattention_tpu_torch.ops import quant_matmul as qmm
    from starflashattention_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    res = {}

    # -- decode attention: B=16, Hq=32, Hkv=8, S=1024, D=128, 2-layer table, layer 1
    b, hq, hkv, s, d, n_layers, layer = 16, 32, 8, 1024, 128, 2, 1
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=bf16)
    k_tab = torch.randn((n_layers, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    v_tab = torch.randn((n_layers, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 1, s
    n_valid = int(lengths.sum())
    dec_bytes = 2 * q.numel() * 2 + 2 * n_valid * hkv * d * 2 + b * 4
    dec_ops = 4 * hq * d * n_valid
    kv_rep = repeat_kv(k_tab[layer], hq // hkv), repeat_kv(v_tab[layer], hq // hkv)
    sdpa_mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(q[:, :, None], kv_rep[0], kv_rep[1], attn_mask=sdpa_mask)

    lib_ms = timer(sdpa_decode)
    # bf16 outputs of two fp32 computations over the same bf16 inputs: each
    # rounds once, and their fp32 sums run in another order, so they may
    # differ by one bf16 ulp of |o| <= 4.
    tol = 2.0**-8 * 4
    for splits, entry in ((1, "flash_decode (1 split, fused)"), (4, "flash_decode (split-KV partials)")):
        kw = dict(layer=layer, num_splits=splits, block_k=256)
        out = flash_decode(q, k_tab, v_tab, lengths, **kw)
        ref = flash_decode_plain(q, k_tab, v_tab, lengths, **kw)
        _check(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d}",
               (out.float() - ref.float()).abs().max().item(), tol)
        _check_ulps(entry, out, ref, 1)
        bnd, by = bound_ms(dec_bytes, dec_ops)  # the wrapper's inputs and output
        run = lambda: flash_decode(q, k_tab, v_tab, lengths, **kw)  # noqa: E731
        res[entry] = dict(
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=timer(run),
            plain_ms=timer(lambda: flash_decode_plain(q, k_tab, v_tab, lengths, **kw), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms)
        log_rate(entry, res[entry]["ms"], dec_bytes, dec_ops,
                 split_grid(b, hkv, s) if splits == 1 else (splits, s // splits))
        if splits == 1:
            coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])
            _variants_form(entry, run, lambda: flash_decode(q, k_tab, v_tab, lengths, window=s, **kw), out,
                           timer, res[entry]["ms"])
    got = flash_decode_with_stats(q, k_tab, v_tab, lengths, layer=layer, num_splits=4, block_k=256)
    want = flash_decode_with_stats_plain(q, k_tab, v_tab, lengths, layer=layer, num_splits=4, block_k=256)
    for name, err in _partial_errors(got, want).items():
        _check(f"flash_decode_with_stats {name}", err, 0.0 if name == "dead splits" else 1e-4)

    # -- cache append on the same table, whole-table equality
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=bf16)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev, dtype=bf16)
    pos = torch.clamp(lengths, max=s - 1)
    ka, va = k_tab.clone(), v_tab.clone()
    kp, vp = k_tab.clone(), v_tab.clone()
    append_rows_kv(ka, va, k_new, v_new, layer, pos)
    append_rows_kv_plain(kp, vp, k_new, v_new, layer, pos)
    same = torch.equal(ka, kp) and torch.equal(va, vp)
    _check("append_rows_kv whole table", 0.0 if same else float("inf"), 0.0)
    bnd, by = bound_ms(2 * 2 * b * hkv * d * 2 + b * 4, 0)
    bidx = torch.arange(b, device=dev)
    pos_l = pos.long()

    def index_put_kv():  # the library call: one advanced-index assignment a table
        kp[layer, bidx, :, pos_l] = k_new
        vp[layer, bidx, :, pos_l] = v_new

    res["append_rows_kv"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: append_rows_kv(ka, va, k_new, v_new, layer, pos)),
        plain_ms=timer(lambda: append_rows_kv_plain(kp, vp, k_new, v_new, layer, pos)),
        bound_ms=bnd, bound_by=by, library_ms=timer(index_put_kv))
    # -- the one-table append (K3b: append_rows, no caller on the main path)
    one = k_tab.clone()
    one_plain = k_tab.clone()
    append_rows(one, k_new, layer, pos)
    append_rows_kv_plain(one_plain, None, k_new, None, layer, pos)
    _check("append_rows (one table) whole table", 0.0 if torch.equal(one, one_plain) else float("inf"), 0.0)
    bnd, by = bound_ms(2 * b * hkv * d * 2 + b * 4, 0)
    k3b = dict(ms=timer(lambda: append_rows(one, k_new, layer, pos)),
               plain_ms=timer(lambda: append_rows_kv_plain(one_plain, None, k_new, None, layer, pos)),
               library_ms=timer(lambda: one_plain.__setitem__((layer, bidx, slice(None), pos_l), k_new)),
               bound_ms=bnd, bound_by=by)
    log(f"[time] append_rows (K3b, not on the main path): kernel {k3b['ms']:.4f} ms, plain "
        f"{k3b['plain_ms']:.4f} ms, library (index assignment) {k3b['library_ms']:.4f} ms, "
        f"bound {bnd:.6f} ms ({by}), max_abs_err 0.000e+00")
    del one, one_plain
    log(f"[time] launch floor: an empty kernel (one block of 32 threads, csrc/cache_append.cu launch_floor) "
        f"{_launch_floor_ms(dev, timer):.4f} ms, beside K3b's and the standalone K9's")
    res.update(_fold_rows(dev, timer, q, k_tab, v_tab, lengths, layer))
    _fold_forms(dev)

    res.update(_paged_kernels(dev, timer, gen, q, k_tab, v_tab, lengths, layer, dec_bytes, dec_ops,
                              k_new, v_new, lib_ms))
    res.update(_spec_kernels(dev, timer, gen))
    res.update(_quantized_kv_kernels(dev, timer, q, k_tab, v_tab, lengths, layer, k_new, v_new))
    del k_tab, v_tab, ka, va, kp, vp, kv_rep
    res.update(_variant_kernels(dev, timer, gen))
    res.update(_latent_kernels(dev, timer, gen))

    # -- quant_matmul: the five projection shapes, stacked L=4, layer 3
    h, inter, vocab = 4096, 11008, 32000
    shapes = {"wqkv": (h, (hq + 2 * hkv) * d, bf16), "wo": (hq * d, h, torch.float32),
              "w_gate_up": (h, 2 * inter, bf16), "w_down": (inter, h, torch.float32),
              "lm_head": (h, vocab, torch.float32)}
    from starflashattention_tpu_torch.core.quant import quantize_weight

    for mode, wdtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        for name, (kdim, ndim, out_dtype) in shapes.items():
            wq = quantize_weight(torch.randn((4, kdim, ndim), generator=gen, device=dev), mode)
            w, scale = wq["w"], wq["scale"]
            assert w.dtype == wdtype
            w_deq = (w[3].float() * scale[3][None, :]).to(bf16)
            for rows in (16, 2048):
                x = torch.randn((rows, kdim), generator=gen, device=dev, dtype=bf16)
                out = quant_matmul(x, w, scale, layer=3, out_dtype=out_dtype)
                ref = quant_matmul_plain(x, w, scale, layer=3, out_dtype=out_dtype)
                err = (out.float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                # fp32 sums of up to 11008 exact products, in another order
                # (f32 out: measured up to 1.1e-5 of the peak at K=11008);
                # plus one bf16 rounding on each side (bf16 out)
                rel = 2.0**-7 if out_dtype == bf16 else 1e-4
                _check(f"quant_matmul {mode} {name} rows={rows} K={kdim} N={ndim} out={out_dtype}",
                       err, rel * peak)
                fn = lambda: quant_matmul(x, w, scale, layer=3, out_dtype=out_dtype)  # noqa: E731
                if rows <= 64:
                    _same_bits(f"quant_matmul {mode} {name} rows={rows}", fn)
                    if mode == "int8" and name in ("wo", "w_down"):
                        _split_k_grid(f"quant_matmul int8 {name} rows={rows}", qmm.quant_matmul, x, w, scale, 3,
                                      out_dtype, 0, timer)
                t = timer(fn)
                t_plain = timer(lambda: quant_matmul_plain(x, w, scale, layer=3, out_dtype=out_dtype), iters=5)
                t_lib = timer(lambda: torch.matmul(x, w_deq))
                n_bytes = x.numel() * 2 + kdim * ndim + ndim * 4 + rows * ndim * out.element_size()
                n_ops = 2 * rows * kdim * ndim
                bnd, by = bound_ms(n_bytes, n_ops)
                log(f"[time] quant_matmul {mode} {name} rows={rows}: kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
                    f"torch.matmul(bf16 dequantized) {t_lib:.4f} ms, bound {bnd:.4f} ms ({by})")
                if rows > 64:
                    log_rate(f"quant_matmul {mode} tiled {name} rows={rows} K={kdim} N={ndim}", t, n_bytes, n_ops)
                key = QMM_ENTRY[rows] if mode == "int8" else QMM_FP8_TILED if rows > 64 else QMM_FP8_SMALL
                agg = res.setdefault(key, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                               n_bytes=0, n_ops=0))
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                agg["ms"] += t
                agg["plain_ms"] += t_plain
                agg["library_ms"] += t_lib
                agg["n_bytes"] += n_bytes
                agg["n_ops"] += n_ops
            del w, scale, w_deq, wq
    for key in (QMM_ENTRY[16], QMM_FP8_SMALL, QMM_ENTRY[2048], QMM_FP8_TILED):
        agg = res[key]
        n_bytes, n_ops = agg.pop("n_bytes"), agg.pop("n_ops")
        agg["bound_ms"], agg["bound_by"] = bound_ms(n_bytes, n_ops)
        log_rate(f"{key}, the five shapes", agg["ms"], n_bytes, n_ops)
    res.update(_quantized_matmuls(dev, timer, gen, shapes))
    _arrivals_at_zero()

    # -- prefill attention: B=2, Sq=512, Skv=1024, q_offsets [0, 300]
    b, sq, skv = 2, 512, 1024
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev, dtype=bf16)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=dev, dtype=bf16)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=dev, dtype=bf16)
    q_off = torch.tensor([0, 300], dtype=torch.int32, device=dev)
    lens = q_off + sq
    out = flash_prefill(q, k, v, lens, q_offsets=q_off)
    ref = flash_prefill_plain(q, k, v, lens, q_offsets=q_off)
    err = (out.float() - ref.float()).abs().max().item()
    # the kernel rounds P to bf16 for the PV product (as the TPU kernel does),
    # the plain version keeps it fp32; both round the output to bf16
    _check(f"flash_prefill B={b} Sq={sq} Skv={skv} q_offsets=[0,300]", err, 2e-2)
    n_pairs = sum(int(lo) * sq + sq * (sq + 1) // 2 for lo in q_off.tolist())
    n_bytes = 2 * q.numel() * 2 + 2 * int(lens.sum()) * hkv * d * 2
    bnd, by = bound_ms(n_bytes, 4 * d * hq * n_pairs)
    kk, vv = repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv)
    qpos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
    kpos = torch.arange(skv, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    res["flash_prefill"] = dict(
        max_abs_err=err,
        ms=timer(lambda: flash_prefill(q, k, v, lens, q_offsets=q_off)),
        plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, q_offsets=q_off), iters=5),
        bound_ms=bnd, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)))
    del q, k, v, kk, vv, mask
    res.update(_train_kernels(dev, timer, gen))
    res.update(_train_variant_kernels(dev, timer, gen))
    res.update(_ring_kernels(dev, timer, gen))
    res.update(_fused_mlp_kernels(dev, timer, gen))
    for name, r in res.items():
        log(f"[time] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}")
    for name, r in res.items():  # the redesigned attention rows (K5 but MLA's latent row, K12)
        if (name.startswith("flash_prefill") and name != LATENT_ENTRIES["prefill"]
                or name.startswith("flash_bwd")) and r["bound_by"] == "operations":
            log(f"[rate] {name}: {r['ms']:.4f} ms, {r['bound_ms'] * PEAK_BF16_OPS_PER_S / r['ms'] / 1e12:.1f} "
                f"TFLOP/s, {r['bound_ms'] / r['ms']:.1%} of its bound (operations)")
    return res


# ---------------------------------------------------------------- K13 (phase 2)

FUSED_MLP_ENTRY = "fused_mlp (B=16, int8, bf16 x)"  # the K13 row of the kernels line
FUSED_MLP_LAYERS, FUSED_MLP_LAYER = 32, 16  # 7B-GQA's stack, a middle layer
FUSED_MLP_HIDDEN, FUSED_MLP_INTERS = 4096, (11008, 2752)  # 7B-GQA's MLP and a TP-4 shard's
FUSED_MLP_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-3}  # of each row's peak (see _fused_mlp_kernels)


def _fused_mlp_stacks(dev, gen, h, inter, mode):
    """(w1, s1, w2, s2) stacks of FUSED_MLP_LAYERS layers: random 8-bit
    bytes with per-channel scales of a unit-variance weight, the checked
    layer quantized from a seeded normal weight (fp8 random bytes would
    hold NaN codes)."""
    from starflashattention_tpu_torch.core.quant import quantize_weight

    out = []
    for rows, cols in ((h, 2 * inter), (inter, h)):
        q = quantize_weight(torch.randn((rows, cols), generator=gen, device=dev), mode)
        w = torch.empty((FUSED_MLP_LAYERS, rows, cols), dtype=q["w"].dtype, device=dev)
        if mode == "int8":
            w.copy_(torch.randint(-127, 128, w.shape, generator=gen, device=dev, dtype=torch.int8))
        else:
            for i in range(FUSED_MLP_LAYERS):
                w[i] = q["w"]
        w[FUSED_MLP_LAYER] = q["w"]
        s = q["scale"][None].repeat(FUSED_MLP_LAYERS, 1).contiguous()
        out += [w, s]
    return out


def _fused_mlp_kernels(dev, timer, gen):
    """K13 at 7B-GQA's MLP (H 4096, I 11008, an (L 32, ...) stack, layer
    16) and at a TP-4 shard's (I 2752): B 1, 16 and 64, int8 and fp8 e4m3
    weights, fp32 and bf16 x, each against ``fused_mlp_plain``. fp32 x: the
    same exact products summed in another order, 2e-5 of the row's peak;
    bf16 x: ``act`` is rounded to bf16 between the matmuls and an fp32 sum
    in another order can round it to the other side of a tie, 4e-3 of the
    peak (the reading is printed). Timed (CUDA events, L2 flushed, median
    of 20) beside two K4 calls with torch's ``silu * up`` between them (the
    serving MLP's route) and bf16 ``torch.matmul`` on dequantized weights
    (two calls and the elementwise: no single PyTorch call computes an MLP,
    so the row's library time is null), against the bound of its bytes
    (3 H I weight bytes, 135.3 MB at 7B). Then K13's own path: the 32
    layers' MLPs of a B=16 decode step through ``fused_mlp`` with the
    counters zeroed before and read after. Returns the kernels line's row
    with the path's launches."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
    from starflashattention_tpu_torch.ops.quant_matmul import quant_matmul

    h, bf16 = FUSED_MLP_HIDDEN, torch.bfloat16
    res = {}
    for inter in FUSED_MLP_INTERS:
        for mode in ("int8", "fp8"):
            w1, s1, w2, s2 = _fused_mlp_stacks(dev, gen, h, inter, mode)
            deq1 = (w1[FUSED_MLP_LAYER].float() * s1[FUSED_MLP_LAYER]).to(bf16)
            deq2 = (w2[FUSED_MLP_LAYER].float() * s2[FUSED_MLP_LAYER]).to(bf16)
            for b in (1, 16, 64):
                for x_dtype in (torch.float32, bf16):
                    x = torch.randn((b, h), generator=gen, device=dev).to(x_dtype)
                    kw = dict(layer=FUSED_MLP_LAYER)
                    out = fused_mlp(x, w1, s1, w2, s2, **kw)
                    ref = fused_mlp_plain(x, w1, s1, w2, s2, **kw)
                    torch.cuda.synchronize()
                    err = ((out - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1).clamp(min=1e-30)).max().item()
                    tag = f"fused_mlp {mode} I={inter} B={b} x={str(x_dtype)[6:]}"
                    _check(f"{tag} (error over each row's peak)", err, FUSED_MLP_TOL[x_dtype])
                    if x_dtype != bf16 or mode != "int8" and b != 16:
                        continue
                    n_bytes = 3 * h * inter + (2 * inter + h) * 4 + b * h * (2 + 4)
                    bnd, by = bound_ms(n_bytes, 6 * b * h * inter)

                    def two_k4():
                        gu = quant_matmul(x, w1, s1, layer=FUSED_MLP_LAYER, out_dtype=bf16)
                        act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(bf16)
                        return quant_matmul(act, w2, s2, layer=FUSED_MLP_LAYER)

                    def dense_bf16():
                        gu = torch.matmul(x, deq1)
                        return torch.matmul((F.silu(gu[:, :inter]) * gu[:, inter:]).to(bf16), deq2)

                    r = dict(max_abs_err=(out - ref).abs().max().item(), ms=timer(lambda: fused_mlp(x, w1, s1, w2, s2, **kw)),
                             plain_ms=timer(lambda: fused_mlp_plain(x, w1, s1, w2, s2, **kw), iters=5),
                             two_k4_ms=timer(two_k4), dense_bf16_ms=timer(dense_bf16), bound_ms=bnd, bound_by=by,
                             library_ms=None)
                    log(f"[time] {tag}: K13 {r['ms']:.4f} ms, two K4 + silu*up {r['two_k4_ms']:.4f} ms, bf16 "
                        f"torch.matmul on dequantized weights {r['dense_bf16_ms']:.4f} ms, plain "
                        f"{r['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB), error over "
                        f"the peak {err:.3e}")
                    if inter == FUSED_MLP_INTERS[0] and mode == "int8" and b == 16:
                        res[FUSED_MLP_ENTRY] = r
            del w1, s1, w2, s2, deq1, deq2
            torch.cuda.empty_cache()
    # K13's own path: a decode step's 32 MLPs (B=16, int8, bf16 x)
    w1, s1, w2, s2 = _fused_mlp_stacks(dev, gen, h, FUSED_MLP_INTERS[0], "int8")
    x = torch.randn((16, h), generator=gen, device=dev).to(bf16)
    torch.cuda.synchronize()
    reset_counts()
    outs = [fused_mlp(x, w1, s1, w2, s2, layer=layer) for layer in range(FUSED_MLP_LAYERS)]
    torch.cuda.synchronize()
    counts = read_counts()
    want = zero_counts(fused_mlp=FUSED_MLP_LAYERS)
    if counts != want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"fused_mlp path: launch counts {counts} != {want}, or a non-finite output")
    log(f"[kernel] fused_mlp path: the {FUSED_MLP_LAYERS} MLPs of a B=16 decode step, one launch each "
        f"({counts['fused_mlp']} launches)")
    res[FUSED_MLP_ENTRY]["path_launches"] = counts["fused_mlp"]
    del w1, s1, w2, s2, outs
    torch.cuda.empty_cache()
    return res


def _train_kernels(dev, timer, gen):
    """K5 with the LSE and the two K12 kernels. Checks first, at B=3, Hq=32,
    Hkv=8, Sq=384, Skv=1024, D=128, q_offsets [0, 300, 17] and lengths
    [384, 684, 0] (a zero-length sequence), causal and not; then each
    kernel at phase 9a's step shapes (B=2, S=2048, causal, no padding):
    held to its plain twin, timed beside its twin and a library call, K12
    run twice for equal bytes."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.ops.flash_bwd import (bwd_delta, flash_bwd_dkdv, flash_bwd_dkdv_plain,
                                                            flash_bwd_dq, flash_bwd_dq_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain

    bf16 = torch.bfloat16
    hq, hkv, d = 32, 8, 128

    def inputs(b, sq, skv):
        q, do = (torch.randn((b, hq, sq, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
        return q, k, v, do

    def k12_errors(q, k, v, do, lens, kw):
        """Both K12 kernels against their plain twins -> (each gradient's
        max abs error, the same relative to its peak), (dq, dk, dv), delta,
        o, lse."""
        o, lse = flash_prefill(q, k, v, lens, return_lse=True, **kw)
        delta = bwd_delta(o, do)
        dq = flash_bwd_dq(q, k, v, lse, do, delta, lens, **kw)
        dk, dv = flash_bwd_dkdv(q, k, v, lse, do, delta, lens, **kw)
        refs = (flash_bwd_dq_plain(q, k, v, lse, do, delta, lens, **kw),
                *flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lens, **kw))
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((dq, dk, dv), refs)]
        rels = [e / b.float().abs().max().item() for e, b in zip(errs, refs)]
        return errs, rels, (dq, dk, dv), delta, o, lse

    # -- checks: ragged, a zero-length sequence, q offsets, causal and not
    q, k, v, do = inputs(3, 384, 1024)
    q_off = torch.tensor([0, 300, 17], dtype=torch.int32, device=dev)
    lens = torch.tensor([384, 684, 0], dtype=torch.int32, device=dev)
    for causal in (True, False):
        kw = dict(causal=causal, q_offsets=q_off)
        tag = f"B=3 Sq=384 Skv=1024 lengths [384,684,0] q_offsets [0,300,17] causal={causal}"
        out, lse = flash_prefill(q, k, v, lens, return_lse=True, **kw)
        ref, lse_ref = flash_prefill_plain(q, k, v, lens, return_lse=True, **kw)
        empty = lse_ref > 1e38
        # the output as K5's row holds it (P rounded to bf16 for PV); the LSE:
        # fp32 sums of the same products in another order, exp2f / log2f
        _check(f"flash_prefill return_lse output {tag}", (out.float() - ref.float()).abs().max().item(), 2e-2)
        _check(f"flash_prefill return_lse lse {tag}", (lse - lse_ref)[~empty].abs().max().item(), 1e-4)
        _check("flash_prefill return_lse: the zero-length sequence's rows hold 3e38, and only they",
               0.0 if bool(empty[2].all()) and not bool(empty[:2].any()) and bool((lse[empty] == 3e38).all())
               else float("inf"), 0.0)
        _check("flash_prefill without the LSE: the same output bytes",
               0.0 if torch.equal(out, flash_prefill(q, k, v, lens, **kw)) else float("inf"), 0.0)
        _, rels, (dq, _, _), _, _, _ = k12_errors(q, k, v, do, lens, kw)
        # the kernels round P and dS to bf16 before their products (as the TPU
        # kernels do) and write bf16; the twins keep fp32 and round once
        for name, rel in zip(("dq", "dk", "dv"), rels):
            _check(f"flash_prefill_bwd {name} {tag}", rel, 2e-2, what="max abs error over the peak")
        _check("flash_prefill_bwd dq of the zero-length sequence is 0", dq[2].abs().max().item(), 0.0)
    del q, k, v, do

    _dq_head_dims(dev, q_off, lens)

    # -- phase 9a's step shapes: B=2, S=2048, causal
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = inputs(b, s, s)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    kw = dict(causal=True)
    errs, rels, grads, delta, o, lse = k12_errors(q, k, v, do, lens, kw)
    tag = f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal"
    for name, rel in zip(("dq", "dk", "dv"), rels):
        _check(f"flash_prefill_bwd {name} {tag}", rel, 2e-2, what="max abs error over the peak")
    again = (flash_bwd_dq(q, k, v, lse, do, delta, lens, **kw), *flash_bwd_dkdv(q, k, v, lse, do, delta, lens, **kw))
    _check(f"flash_prefill_bwd two runs, bytes that differ ({tag})",
           float(sum(int((a.view(torch.int16) != g.view(torch.int16)).sum()) for a, g in zip(again, grads))), 0.0)
    out_ref, lse_ref = flash_prefill_plain(q, k, v, lens, return_lse=True, **kw)
    k5_err = (o.float() - out_ref.float()).abs().max().item()
    _check(f"flash_prefill return_lse output {tag}", k5_err, 2e-2)
    _check(f"flash_prefill return_lse lse {tag}", (lse - lse_ref).abs().max().item(), 1e-4)
    del lse_ref, out_ref

    pairs = b * hq * s * (s + 1) // 2  # (query, key) pairs in band
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, b * hq * s * 4  # bf16 (B,Hq,S,D), (B,Hkv,S,D); fp32 rows
    # the library yardstick: SDPA (its own fused causal kernels, enable_gqa);
    # its backward timed as forward + backward minus the forward
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), leaves, do)

    sdpa_fwd = timer(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
    sdpa_bwd = timer(sdpa_fwd_bwd) - timer(sdpa)
    res = {}
    bnd, by = bound_ms(qb + 2 * kvb + qb + rowb, 4 * d * pairs)  # q, k, v in; o, lse out
    res["flash_prefill (return_lse, training)"] = dict(
        max_abs_err=k5_err,
        ms=timer(lambda: flash_prefill(q, k, v, lens, return_lse=True, **kw)),
        plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, return_lse=True, **kw), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=sdpa_fwd)
    # the serving instantiation at the same shape: the LSE's own cost
    _check(f"flash_prefill without the LSE: the same output bytes ({tag})",
           0.0 if torch.equal(o, flash_prefill(q, k, v, lens, **kw)) else float("inf"), 0.0)
    bnd, by = bound_ms(qb + 2 * kvb + qb, 4 * d * pairs)  # q, k, v in; o out
    res[K5_TRAIN_NO_LSE] = dict(
        max_abs_err=k5_err, ms=timer(lambda: flash_prefill(q, k, v, lens, **kw)),
        plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, **kw), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=sdpa_fwd)
    t_no_lse = res[K5_TRAIN_NO_LSE]["ms"]
    # dq: the S and dP recompute and ds @ k, 6 D a pair; dk/dv: the recompute,
    # p^T @ do and ds^T @ q, 8 D a pair (the two kernels together: 14 D, where
    # one fused pass would do 10 D)
    ins = qb + 2 * kvb + qb + 2 * rowb  # q, k, v, do, lse, delta
    for name, fn, plain, n_out, ops_per_pair, err in (
            ("flash_bwd_dq", flash_bwd_dq, flash_bwd_dq_plain, qb, 6 * d, errs[0]),
            ("flash_bwd_dkdv", flash_bwd_dkdv, flash_bwd_dkdv_plain, 2 * kvb, 8 * d, max(errs[1:]))):
        bnd, by = bound_ms(ins + n_out, ops_per_pair * pairs)
        res[name] = dict(max_abs_err=err,
                         ms=timer(lambda: fn(q, k, v, lse, do, delta, lens, **kw)),
                         plain_ms=timer(lambda: plain(q, k, v, lse, do, delta, lens, **kw), iters=5),
                         bound_ms=bnd, bound_by=by, library_ms=sdpa_bwd)
    log(f"[time] K5 at {tag}: with the LSE {res['flash_prefill (return_lse, training)']['ms']:.4f} ms, "
        f"without it {t_no_lse:.4f} ms")
    log(f"[time] K12 at {tag}: library (SDPA) forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms; "
        f"max abs errors dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (relative to each peak "
        f"{rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e})")
    del q, k, v, do, o, lse, delta, grads, again, leaves
    torch.cuda.empty_cache()
    res[K12_SPLIT] = _split_dkdv_row(dev, timer)
    return res


def _dq_head_dims(dev, q_off, lens):
    """K12's dq at head_dim 64 (G 4, 8) and 256 (G 1, 2) on the ragged
    inputs of ``_train_kernels``' checks (Sq 384, Skv 1024, a zero-length
    sequence), causal and not: within 2e-2 of the plain twin's peak, zeros
    on the empty sequence, the same bytes twice (the other tiles of the
    kernel: 128 rows of 32 or 16 a head, and 64 rows at D 256). Its inputs
    come from a generator of its own, so the rows after it keep theirs."""
    from starflashattention_tpu_torch.ops.flash_bwd import bwd_delta, flash_bwd_dq, flash_bwd_dq_plain
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for d, hq, hkv in ((64, 32, 8), (64, 16, 2), (256, 16, 16), (256, 16, 8)):
        q, do = (torch.randn((3, hq, 384, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
        k, v = (torch.randn((3, hkv, 1024, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
        for causal in (True, False):
            kw = dict(causal=causal, q_offsets=q_off)
            o, lse = flash_prefill(q, k, v, lens, return_lse=True, **kw)
            args = (q, k, v, lse, do, bwd_delta(o, do), lens)
            dq, ref = flash_bwd_dq(*args, **kw), flash_bwd_dq_plain(*args, **kw)
            tag = f"D={d} Hq={hq} Hkv={hkv} ragged causal={causal}"
            _check(f"flash_bwd_dq {tag}", (dq.float() - ref.float()).abs().max().item()
                   / ref.float().abs().max().item(), 2e-2, what="max abs error over the peak")
            _check(f"flash_bwd_dq {tag}: the zero-length sequence", dq[2].abs().max().item(), 0.0)
            _check_equal(f"flash_bwd_dq {tag}: two runs", flash_bwd_dq(*args, **kw), dq)
        del q, do, k, v, o, lse, args, dq, ref


def _split_dkdv_row(dev, timer):
    """K12's dk/dv where its plan cuts the walks into pieces: phase 14e's TP
    x DP shard of phase 9's step (B=1, Hq=16, Hkv=4, S=2048, D=128,
    causal). The split held to the twin at 2e-2 of each peak, the same
    bytes on two runs, the split counted on the wrapper; the same walks in
    one block each held to the twin too; timed at the plan's piece, at
    half and twice it, and unsplit, beside SDPA's backward. Its inputs come
    from a generator of their own, so the rows after it keep theirs."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.ops import flash_bwd
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill

    b, hq, hkv, s, d = 1, 16, 4, TRAIN_SEQ, 128
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    o, lse = flash_prefill(q, k, v, lens, return_lse=True)
    delta = flash_bwd.bwd_delta(o, do)
    args = (q, k, v, lse, do, delta, lens)
    tag = f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal"
    bkv, bq, _ = flash_bwd.dkdv_geometry(d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, splits = flash_bwd.dkdv_split_plan(b, hkv, hq // hkv, s, s, True, None, 0, sms, bkv, bq)
    _check(f"flash_bwd_dkdv: the plan cuts the walks into pieces at {tag}", 0.0 if splits > 1 else float("inf"),
           0.0, what=f"{splits} pieces of {chunk} steps")
    before = flash_bwd.flash_bwd_dkdv.launches_split
    got = flash_bwd.flash_bwd_dkdv(*args)
    _check(f"flash_bwd_dkdv: the split launch counted once at {tag}",
           float(abs(flash_bwd.flash_bwd_dkdv.launches_split - before - 1)), 0.0, what="counts off by")
    refs = flash_bwd.flash_bwd_dkdv_plain(*args)
    errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, refs)]
    for name, e, r in zip(("dk", "dv"), errs, refs):
        _check(f"flash_bwd_dkdv split walks {name} {tag}", e / r.float().abs().max().item(), 2e-2,
               what="max abs error over the peak")
    again = flash_bwd.flash_bwd_dkdv(*args)
    _check(f"flash_bwd_dkdv split walks, two runs, bytes that differ ({tag})",
           float(sum(int((a.view(torch.int16) != g.view(torch.int16)).sum()) for a, g in zip(again, got))), 0.0)
    full = flash_bwd.dkdv_longest_walk(q, k)
    whole = flash_bwd.flash_bwd_dkdv_split(*args, plan=(full, 1))
    for name, a, r in zip(("dk", "dv"), whole, refs):
        _check(f"flash_bwd_dkdv unsplit walks {name} {tag}",
               (a.float() - r.float()).abs().max().item() / r.float().abs().max().item(), 2e-2,
               what="max abs error over the peak")
    del again, whole
    times = {}
    for c in (max(chunk // 2, 1), chunk, 2 * chunk, full):  # pieces of c steps; the last: one a walk
        plan = (c, flash_bwd.dkdv_walk_splits(full, c))
        times[plan] = timer(lambda plan=plan: flash_bwd.flash_bwd_dkdv_split(*args, plan=plan))
    log(f"[time] flash_bwd_dkdv at {tag} on {sms} SMs, the plan's {splits} pieces of {chunk} steps: "
        + ", ".join(f"{n} pieces of {c} {t:.4f} ms" for (c, n), t in times.items())
        + f" (the last: every walk in one block, {times[(full, 1)] / times[(chunk, splits)]:.2f}x the plan's)")

    pairs = b * hq * s * (s + 1) // 2
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, b * hq * s * 4
    bnd, by = bound_ms(qb + 2 * kvb + qb + 2 * rowb + 2 * kvb, 8 * d * pairs)  # q, k, v, do, lse, delta; dk, dv
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)

    sdpa_bwd = timer(lambda: torch.autograd.grad(sdpa(), leaves, do)) - timer(sdpa)
    row = dict(max_abs_err=max(errs), ms=timer(lambda: flash_bwd.flash_bwd_dkdv(*args)),
               plain_ms=timer(lambda: flash_bwd.flash_bwd_dkdv_plain(*args), iters=5),
               bound_ms=bnd, bound_by=by, library_ms=sdpa_bwd)
    del q, k, v, do, o, lse, delta, got, refs, leaves, args
    torch.cuda.empty_cache()
    return row


def _sink_heavy(q, k, sinks, gen):
    """q and k with the sinks made heavy, as trained models' sinks are: every
    query gains a shared direction u (half a typical row) and the sink keys
    lie along u, so that each row gives its sinks a share of its weight
    (with random q and k, 4 sinks beside 4096 band keys hold a thousandth,
    which no check at these tolerances could see)."""
    d = q.shape[-1]
    u = torch.randn((d,), generator=gen, device=q.device)
    u = u / u.norm() * d**0.5
    q = (q.float() + 0.5 * u).to(q.dtype)
    k = k.clone()
    k[:, :, :sinks] = u.to(k.dtype)
    return q, k


def _flex_train(q, k, v, do, window, sinks, softcap, scale, q_offset=0):
    """One compiled ``flex_attention`` call on a training step's causal
    rows, query row i at position ``q_offset + i`` of the KV rows (the band
    and the sinks as the block mask, the cap as the score_mod): (forward,
    forward + backward -> the gradients)."""
    base = torch.full((q.shape[0],), q_offset + 1, dtype=torch.int32, device=q.device)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    call = _flex_call(*leaves, base, window, sinks, softcap, scale)

    def fwd():
        with torch.no_grad():
            return call()

    def fwd_bwd():
        return torch.autograd.grad(call(), leaves, do)

    return fwd, fwd_bwd


def _train_variant_kernels(dev, timer, gen):
    """K5 with the LSE and K12 with the variants at phase 11's shapes: the
    training step's causal rows (B=1, q_offsets 0, no padding). Mistral-7B
    (Hq 32, Hkv 8, D 128, S 8192, window 4096, 4 sinks), Gemma-2-9B (Hq 16,
    Hkv 8, D 256, softcap 50, sm_scale 1/16, S 6144; a sliding layer's
    window 4096 and a full layer's none) and Gemma-7B (Hq = Hkv = 16, D 256,
    S 4608, no option). Each form is held to its plain twin (the output in
    bf16 ulps of each element, the LSE within 1e-4, each gradient within
    2e-2 of its peak), K12 run twice for equal bytes, and each option is
    shown to move the result: the same kernels run without it lie over 4x
    each tolerance from the twin (dq over the rows the option acts on,
    past the window for the window and the sinks, against their own peak;
    Gemma-2's q is scaled so that the cap bends its scores, and unscaled
    for its window; Mistral's sinks are made heavy, see _sink_heavy).
    Timed beside the twins and one library call: a compiled
    ``flex_attention`` forward, and forward + backward less the forward for
    K12 (SDPA's for Gemma-7B, which has no option); the bounds count the
    in-band pairs. Prints the banded K12 against the unbanded one at
    Mistral's shape (ratio expected near the 0.75 of the pairs)."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.ops.flash_bwd import (bwd_delta, flash_bwd_dkdv, flash_bwd_dkdv_plain,
                                                            flash_bwd_dq, flash_bwd_dq_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain

    bf16, e, res = torch.bfloat16, TRAIN_VARIANT_ENTRIES, {}
    tol = 2e-2  # of each gradient's peak: P and dS rounded to bf16 on the kernels' side

    def grads(q, k, v, do, lens, kw):
        o, lse = flash_prefill(q, k, v, lens, return_lse=True, **kw)
        delta = bwd_delta(o, do)
        return o, lse, delta, (flash_bwd_dq(q, k, v, lse, do, delta, lens, **kw),
                               *flash_bwd_dkdv(q, k, v, lse, do, delta, lens, **kw))

    def rel(got, refs):
        return [(a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
                for a, b in zip(got, refs)]

    def group(tag, keys, q, k, v, do, kw, drops, library):
        """One form: checks, the options' sensitivity, times. ``keys`` =
        (forward, dq, dk/dv) entries; ``drops`` = [(what, overrides, a
        factor for q or None, the first q row the option acts on)];
        ``library(out_ref)`` -> (forward ms, backward ms) or None."""
        b, hq, s, d = q.shape
        hkv = k.shape[1]
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        shape = f"B={b} Hq={hq} Hkv={hkv} D={d} S={s}"
        o, lse, delta, got = grads(q, k, v, do, lens, kw)
        ref, lse_ref = flash_prefill_plain(q, k, v, lens, return_lse=True, **kw)
        _check_ulps(f"{keys[0]} {shape} output", o, ref, 2)
        lse_err = (lse - lse_ref).abs().max().item()
        _check(f"{keys[0]} {shape} lse", lse_err, 1e-4)
        _check(f"{keys[0]}: output bytes equal to the call without the LSE",
               0.0 if torch.equal(o, flash_prefill(q, k, v, lens, **kw)) else float("inf"), 0.0)
        refs = (flash_bwd_dq_plain(q, k, v, lse, do, delta, lens, **kw),
                *flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lens, **kw))
        rels = rel(got, refs)
        for name, r in zip(("dq", "dk", "dv"), rels):
            _check(f"{keys[1 if name == 'dq' else 2]} {shape} {name}", r, tol, what="max abs error over the peak")
        again = (flash_bwd_dq(q, k, v, lse, do, delta, lens, **kw),
                 *flash_bwd_dkdv(q, k, v, lse, do, delta, lens, **kw))
        _check(f"{tag} K12 two runs, bytes that differ",
               float(sum(int((a.view(torch.int16) != g.view(torch.int16)).sum()) for a, g in zip(again, got))), 0.0)
        del again
        for what, over, q_scale, r0 in drops:
            if q_scale is None:
                qd, ref_d, refs_d = q, ref, refs
            else:  # another q, on which the option holds weight: its own twins
                qd = (q.float() * q_scale).to(q.dtype)
                _, lse_d, delta_d, _ = grads(qd, k, v, do, lens, kw)
                ref_d = flash_prefill_plain(qd, k, v, lens, **kw)
                refs_d = (flash_bwd_dq_plain(qd, k, v, lse_d, do, delta_d, lens, **kw),
                          *flash_bwd_dkdv_plain(qd, k, v, lse_d, do, delta_d, lens, **kw))
            o2, _, _, got2 = grads(qd, k, v, do, lens, {**kw, **over})
            # dq from row r0 on, the rows the option acts on, against their own peak
            fwd_ulps = _ulps(o2, ref_d)
            bwd_rel = max(rel((got2[0][:, :, r0:], *got2[1:]), (refs_d[0][:, :, r0:], *refs_d[1:])))
            ok = fwd_ulps > 4 * 3.0 and bwd_rel > 4 * tol
            log(f"[kernel] {tag} without {what}: the output {fwd_ulps:.3e} bf16 ulps and the gradients "
                f"{bwd_rel:.3e} of their peaks from the twins, over 4x the tolerances (3 ulps, {tol}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: {what} does not move the result past the checks' tolerances")
            del o2, got2, qd, ref_d, refs_d
        pos = torch.arange(s, device=dev) + 1
        pairs = b * hq * int(_attended_rows(pos, kw.get("window"), kw.get("sinks", 0)).sum())
        qb, kvb, rowb = q.numel() * 2, k.numel() * 2, b * hq * s * 4
        lib = library(ref, refs)
        fwd_bnd = bound_ms(qb + 2 * kvb + qb + rowb, 4 * d * pairs)
        res[keys[0]] = dict(
            max_abs_err=(o.float() - ref.float()).abs().max().item(),
            ms=timer(lambda: flash_prefill(q, k, v, lens, return_lse=True, **kw)),
            plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, return_lse=True, **kw), iters=5),
            bound_ms=fwd_bnd[0], bound_by=fwd_bnd[1], library_ms=None if lib is None else lib[0])
        ins = qb + 2 * kvb + qb + 2 * rowb  # q, k, v, do, lse, delta
        abs_errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, refs)]
        for key, fn, plain, n_out, ops, err in (
                (keys[1], flash_bwd_dq, flash_bwd_dq_plain, qb, 6 * d, abs_errs[0]),
                (keys[2], flash_bwd_dkdv, flash_bwd_dkdv_plain, 2 * kvb, 8 * d, max(abs_errs[1:]))):
            bnd, by = bound_ms(ins + n_out, ops * pairs)
            res[key] = dict(max_abs_err=err,
                            ms=timer(lambda fn=fn: fn(q, k, v, lse, do, delta, lens, **kw)),
                            plain_ms=timer(lambda plain=plain: plain(q, k, v, lse, do, delta, lens, **kw), iters=5),
                            bound_ms=bnd, bound_by=by, library_ms=None if lib is None else lib[1])
        log(f"[time] {tag} {shape}: K5 with the LSE {res[keys[0]]['ms']:.4f} ms, K12 dq {res[keys[1]]['ms']:.4f} "
            f"ms, dk/dv {res[keys[2]]['ms']:.4f} ms (bounds {res[keys[0]]['bound_ms']:.4f} / "
            f"{res[keys[1]]['bound_ms']:.4f} / {res[keys[2]]['bound_ms']:.4f} ms, {pairs / (b * hq):.0f} pairs a head); "
            f"library {'none' if lib is None else f'forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms'}")
        del o, lse, delta, got, ref, lse_ref, refs
        torch.cuda.empty_cache()
        return lens

    def flex_library(tag, q, k, v, do, kw, scale):
        def library(ref, refs):
            """flex_attention held to the twins (its forward within
            LIBRARY_ULPS, its gradients within 5e-2 of each peak: its own
            bf16 roundings; a wrong mask or cap is off by far more)."""
            try:
                fwd, fwd_bwd = _flex_train(q, k, v, do, kw.get("window"), kw.get("sinks", 0),
                                           kw.get("softcap"), scale)
                out, g = fwd(), fwd_bwd()
            except Exception as exc:  # noqa: BLE001 (the yardstick only: the kernels' checks stand)
                log(f"[time] {tag}: flex_attention does not run here ({type(exc).__name__}: "
                    f"{str(exc).splitlines()[0][:160]}); library_ms null")
                return None
            _check_ulps(f"{tag} library call (flex_attention) output", out, ref, LIBRARY_ULPS - 1)
            _check(f"{tag} library call (flex_attention) gradients", max(rel(g, refs)), 5e-2,
                   what="max abs error over the peak")
            del out, g
            t_fwd = timer(fwd)
            return t_fwd, timer(fwd_bwd) - t_fwd
        return library

    # -- Mistral-7B: window 4096 + 4 sinks, D 128, S 8192
    hq, hkv, d, s = 32, 8, 128, TRAIN_VARIANT_SEQ["mistral"]
    w, sk = VARIANT_WINDOW, VARIANT_SINKS
    q, do = (torch.randn((1, hq, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    q, k = _sink_heavy(q, k, sk, gen)
    kw = dict(window=w, sinks=sk)
    lens = group("Mistral-7B training", (e["mistral_fwd"], e["mistral_dq"], e["mistral_dkdv"]), q, k, v, do, kw,
                 [("the sinks", dict(sinks=0), None, w), ("the window", dict(window=None, sinks=0), None, w)],
                 flex_library("Mistral-7B training", q, k, v, do, kw, d**-0.5))
    o, lse = flash_prefill(q, k, v, lens, return_lse=True)
    delta = bwd_delta(o, do)
    t_full = (timer(lambda: flash_bwd_dq(q, k, v, lse, do, delta, lens)),
              timer(lambda: flash_bwd_dkdv(q, k, v, lse, do, delta, lens)))
    band = res[e["mistral_dq"]]["ms"], res[e["mistral_dkdv"]]["ms"]
    pos = torch.arange(s, device=dev) + 1
    share = int(_attended_rows(pos, w, sk).sum()) / (s * (s + 1) // 2)
    log(f"[time] K12 at Mistral-7B's shape: banded dq {band[0]:.4f} / dk/dv {band[1]:.4f} ms, unbanded causal "
        f"{t_full[0]:.4f} / {t_full[1]:.4f} ms: ratios {band[0] / t_full[0]:.3f} / {band[1] / t_full[1]:.3f} "
        f"(in-band share of the causal pairs {share:.3f})")
    del q, k, v, do, o, lse, delta

    # -- Gemma-2-9B: D 256, softcap 50, sm_scale 1/16, S 6144; sliding and full layers
    hq, hkv, d, s = 16, 8, 256, TRAIN_VARIANT_SEQ["gemma2"]
    sm = 256.0**-0.5
    q = (torch.randn((1, hq, s, d), generator=gen, device=dev) * GEMMA2_Q_SCALE).to(bf16)
    do = torch.randn((1, hq, s, d), generator=gen, device=dev, dtype=bf16)
    k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    for tag, keys, win in (
            ("Gemma-2-9B training, sliding layer", ("gemma2_fwd", "gemma2_dq", "gemma2_dkdv"), w),
            ("Gemma-2-9B training, full layer", ("gemma2_full_fwd", "gemma2_full_dq", "gemma2_full_dkdv"), None)):
        kw = dict(sm_scale=sm, window=win, softcap=GEMMA2_SOFTCAP)
        # the window on unscaled q: scores bent to the cap put nearly all of a
        # row's weight on its few largest keys, wherever they lie
        drops = [("the softcap", dict(softcap=None), None, 0)] + (
            [("the window", dict(window=None), 1 / GEMMA2_Q_SCALE, win)] if win else [])
        group(tag, tuple(e[x] for x in keys), q, k, v, do, kw, drops, flex_library(tag, q, k, v, do, kw, sm))
    del q, k, v, do

    # -- Gemma-7B: D 256, Hq = Hkv = 16, S 4608, no option (library: SDPA)
    hq, hkv, d, s = 16, 16, 256, TRAIN_VARIANT_SEQ["gemma"]
    q, do = (torch.randn((1, hq, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    k, v = (torch.randn((1, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))

    def sdpa_library(ref, refs):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        t_fwd = timer(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        t_all = timer(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves, is_causal=True),
                                                  leaves, do))
        return t_fwd, t_all - t_fwd

    group("Gemma-7B training", (e["gemma_fwd"], e["gemma_dq"], e["gemma_dkdv"]), q, k, v, do, {}, [],
          sdpa_library)
    del q, k, v, do
    torch.cuda.empty_cache()
    return res


def _chunk_heavy(q, k, sinks, chunk, gen):
    """``_sink_heavy`` at the head of EVERY chunk of ``chunk`` rows: the
    first ``sinks`` keys of each chunk lie along q's shared direction. Only
    chunk 0's are sinks; a kernel that took the raw ``sinks`` on a later
    chunk (ignoring ``kv_offset``) would attend that chunk's heavy keys from
    rows whose band lies far past them, which moves its rows by far."""
    d = q.shape[-1]
    u = torch.randn((d,), generator=gen, device=q.device)
    u = u / u.norm() * d**0.5
    q = (q.float() + 0.5 * u).to(q.dtype)
    k = k.clone()
    for c0 in range(0, k.shape[2], chunk):
        k[:, :, c0:c0 + sinks] = u.to(k.dtype)
    return q, k


def _bwd_row_errors(got, refs, q, k, v, lse, do, delta, lens, q_off, *, window, sinks, kv_offset):
    """dq, dk and dv (``got``) against the twins' (``refs``), each row (a
    query row of dq, a key row of dk and dv) over its own scale: the larger
    of the row's peak and 2^-8 of the peak of the sums of its terms'
    magnitudes (``P (|dP| + |delta|) @ |K|`` for dq, its transpose on ``|Q|``
    for dk, ``P^T @ |dO|`` for dv), the floor at which the bf16 rounding of
    P and dS shows. The floor serves the rows whose terms cancel (a row of
    one key: ``dP - delta`` is 0 up to fp32 sums) and the rows no key or
    row reaches (0 on both sides). Returns the three largest ratios. One KV
    head's group at a time, on fp32 (Sq, Skv) tensors."""
    from starflashattention_tpu_torch.ops.flash_prefill import attention_mask, prefill_options, scores_log2

    opts = prefill_options(window, sinks, None, kv_offset, True)
    mask = attention_mask(q.shape[2], k.shape[2], lens, q_off, True, q.device, opts["window"], opts["sinks"])
    sm, hkv = q.shape[-1] ** -0.5, k.shape[1]
    g = q.shape[1] // hkv
    worst = [0.0, 0.0, 0.0]
    for h in range(hkv):
        hs = slice(h * g, (h + 1) * g)
        qs, dos, kh, vh = q[:, hs].float(), do[:, hs].float(), k[:, h:h + 1].float(), v[:, h:h + 1].float()
        s2, _ = scores_log2(qs, kh, sm)
        p = torch.where(mask, torch.exp2(s2 - lse[:, hs].float()[..., None]), 0.0)
        del s2
        a = p * ((dos @ vh.transpose(-1, -2)).abs() + delta[:, hs].float().abs()[..., None])
        terms = (sm * (a @ kh.abs()), sm * (a.transpose(-1, -2) @ qs.abs()).sum(1, keepdim=True),
                 (p.transpose(-1, -2) @ dos.abs()).sum(1, keepdim=True))
        del a, p
        for i, (x, r, t) in enumerate(zip(got, refs, terms)):
            rows = hs if i == 0 else slice(h, h + 1)
            x, r = x[:, rows].float(), r[:, rows].float()
            scale = torch.maximum(r.abs().amax(dim=-1), 2.0**-8 * t.amax(dim=-1)).clamp(min=1e-30)
            worst[i] = max(worst[i], ((x - r).abs().amax(dim=-1) / scale).max().item())
    return worst


def _ring_kernels(dev, timer, gen):
    """K5 with the LSE and both K12 kernels with ``kv_offset``, at one step
    of phase 13a's Mistral-7B ring (Hq 32, Hkv 8, D 128, window 4096, 4
    sinks; B=1 here so that the plain twins fit): the q chunk of rank 2
    (rows 16384-24575) against the KV chunk of rank 1 (rows 8192-16383),
    so ``q_offsets`` 8192 and ``kv_offset`` 8192: the rows' band covers the
    chunk's last 4095 rows for the first 4096 q rows, and the sinks lie in
    no row of it. First the ring's empty chunks (a KV chunk wholly in the
    rows' future, a sequence of length 0): 0, the LSE 3e38 and zero
    gradients, equal to the twins. Then held to the twins with
    ``kv_offset``: the output within 4 bf16 ulps of each element, the LSE
    within 1e-4, each gradient row within 2e-2 of its own scale
    (``_bwd_row_errors``), K12 run twice for equal bytes; the same kernels
    given the raw sinks (``kv_offset`` 0) lie over 4x the tolerance from
    the twins' peaks (the first keys of every chunk are heavy,
    ``_chunk_heavy``).
    Timed beside the twins and a compiled ``flex_attention`` with the
    offset sink mask (forward, and forward + backward less the forward);
    the bound counts the in-band pairs."""
    from starflashattention_tpu_torch.ops.flash_bwd import (bwd_delta, flash_bwd_dkdv, flash_bwd_dkdv_plain,
                                                            flash_bwd_dq, flash_bwd_dq_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain

    bf16, tol = torch.bfloat16, 2e-2
    hq, hkv, d, c = 32, 8, 128, RING_SEQ // RING_WORLD
    w, sk = VARIANT_WINDOW, VARIANT_SINKS

    # -- the ring's empty chunks, first: sequence 0's KV chunk lies wholly in
    # its rows' future (q_offsets -1024) and sequence 1 has length 0; both
    # kernels walk no tile there: 0, the LSE 3e38 and zero gradients, bit for
    # bit the twins', with and without the band
    qe, doe = (torch.randn((2, hq, 1024, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    ke, ve = (torch.randn((2, hkv, 1024, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    lens_e = torch.tensor([1024, 0], dtype=torch.int32, device=dev)
    off_e = torch.tensor([-1024, 1024], dtype=torch.int32, device=dev)
    for opts in (dict(kv_offset=1024), dict(window=w, sinks=sk, kv_offset=1024)):
        o, lse = flash_prefill(qe, ke, ve, lens_e, q_offsets=off_e, return_lse=True, **opts)
        o_ref, lse_ref = flash_prefill_plain(qe, ke, ve, lens_e, q_offsets=off_e, return_lse=True, **opts)
        delta = bwd_delta(o, doe)
        got = (flash_bwd_dq(qe, ke, ve, lse, doe, delta, lens_e, off_e, **opts),
               *flash_bwd_dkdv(qe, ke, ve, lse, doe, delta, lens_e, off_e, **opts))
        refs = (flash_bwd_dq_plain(qe, ke, ve, lse, doe, delta, lens_e, off_e, **opts),
                *flash_bwd_dkdv_plain(qe, ke, ve, lse, doe, delta, lens_e, off_e, **opts))
        exact = (bool((o == 0).all()) and torch.equal(o, o_ref) and bool((lse == 3e38).all())
                 and torch.equal(lse, lse_ref) and all(bool((g == 0).all()) and torch.equal(g, r)
                                                       for g, r in zip(got, refs)))
        _check(f"K5 / K12 {opts}: a KV chunk in the rows' future and a sequence of length 0 give 0, the LSE "
               "3e38 and zero gradients, equal to the twins", 0.0 if exact else float("inf"), 0.0)
    del qe, doe, ke, ve, o, lse, o_ref, lse_ref, delta, got, refs
    q, do = (torch.randn((1, hq, c, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    k, v = (torch.randn((1, hkv, c, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    q, k = _chunk_heavy(q, k, sk, c, gen)
    lens = torch.full((1,), c, dtype=torch.int32, device=dev)
    q_off = torch.full((1,), c, dtype=torch.int32, device=dev)
    kw = dict(q_offsets=q_off, window=w, sinks=sk, kv_offset=c)
    bkw = dict(window=w, sinks=sk, kv_offset=c)
    tag = f"ring step B=1 Hq={hq} Hkv={hkv} D={d}, q rows {2 * c}-{3 * c - 1} on KV rows {c}-{2 * c - 1}"

    def run(opts):
        o, lse = flash_prefill(q, k, v, lens, return_lse=True, **{**kw, **opts})
        delta = bwd_delta(o, do)
        b_opts = {**bkw, **opts}
        return o, lse, delta, (flash_bwd_dq(q, k, v, lse, do, delta, lens, q_off, **b_opts),
                               *flash_bwd_dkdv(q, k, v, lse, do, delta, lens, q_off, **b_opts))

    def rel(got, refs):
        return [(a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
                for a, b in zip(got, refs)]

    o, lse, delta, got = run({})
    ref, lse_ref = flash_prefill_plain(q, k, v, lens, return_lse=True, **kw)
    # 4 ulps, one more than the sibling K5 rows' 3: this chunk's rows attend
    # 1 to 4,095 keys, and a few-key row's output (P rounded to bf16 before
    # PV, as the TPU kernel does) can cancel below its terms; the kernel and
    # flex_attention both read 3.06 ulps against the twin on one seed
    _check_ulps(f"{RING_ENTRIES['fwd']} {tag} output", o, ref, 3)
    _check(f"{RING_ENTRIES['fwd']} {tag} lse", (lse - lse_ref).abs().max().item(), 1e-4)
    refs = (flash_bwd_dq_plain(q, k, v, lse, do, delta, lens, q_off, **bkw),
            *flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lens, q_off, **bkw))
    for name, r in zip(("dq", "dk", "dv"), _bwd_row_errors(got, refs, q, k, v, lse, do, delta, lens, q_off,
                                                           **bkw)):
        _check(f"{RING_ENTRIES['dq' if name == 'dq' else 'dkdv']} {tag} {name}", r, tol,
               what="largest error of a row over the row's own scale")
    again = (flash_bwd_dq(q, k, v, lse, do, delta, lens, q_off, **bkw),
             *flash_bwd_dkdv(q, k, v, lse, do, delta, lens, q_off, **bkw))
    _check("K12 with kv_offset, two runs, bytes that differ",
           float(sum(int((a.view(torch.int16) != g.view(torch.int16)).sum()) for a, g in zip(again, got))), 0.0)
    del again
    o2, _, _, got2 = run(dict(kv_offset=0))
    fwd_rel, bwd_rel = rel([o2], [ref])[0], max(rel(got2, refs))
    ok = fwd_rel > 4 * tol and bwd_rel > 4 * tol
    log(f"[kernel] {tag} with the raw sinks (kv_offset 0): the output {fwd_rel:.3e} and the gradients "
        f"{bwd_rel:.3e} of their peaks from the twins, over 4x the tolerance {tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kv_offset does not move the result past the checks' tolerances")
    del o2, got2
    pairs = hq * sum(max(0, w - 1 - i) for i in range(min(c, w)))  # row i: the chunk's rows past c + i - w
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, hq * c * 4
    lib = (None, None)
    try:
        fwd, fwd_bwd = _flex_train(q, k, v, do, w, max(sk - c, 0), None, d**-0.5, q_offset=c)
        lib_out, lib_g = fwd(), fwd_bwd()
    except Exception as exc:  # noqa: BLE001 (the yardstick only: the kernels' checks stand)
        log(f"[time] {tag}: flex_attention does not run here ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}); library_ms null")
    else:
        _check_ulps(f"{tag} library call (flex_attention) output", lib_out, ref, LIBRARY_ULPS - 1)
        _check(f"{tag} library call (flex_attention) gradients", max(rel(lib_g, refs)), 5e-2,
               what="max abs error over the peak")
        del lib_out, lib_g
        t_fwd = timer(fwd)
        lib = (t_fwd, timer(fwd_bwd) - t_fwd)
    res = {}
    bnd, by = bound_ms(qb + 2 * kvb + qb + rowb, 4 * d * pairs)
    res[RING_ENTRIES["fwd"]] = dict(
        max_abs_err=(o.float() - ref.float()).abs().max().item(),
        ms=timer(lambda: flash_prefill(q, k, v, lens, return_lse=True, **kw)),
        plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, return_lse=True, **kw), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=lib[0])
    ins = qb + 2 * kvb + qb + 2 * rowb  # q, k, v, do, lse, delta
    abs_errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, refs)]
    for key, fn, plain, n_out, ops, err in (
            ("dq", flash_bwd_dq, flash_bwd_dq_plain, qb, 6 * d, abs_errs[0]),
            ("dkdv", flash_bwd_dkdv, flash_bwd_dkdv_plain, 2 * kvb, 8 * d, max(abs_errs[1:]))):
        bnd, by = bound_ms(ins + n_out, ops * pairs)
        res[RING_ENTRIES[key]] = dict(
            max_abs_err=err, ms=timer(lambda fn=fn: fn(q, k, v, lse, do, delta, lens, q_off, **bkw)),
            plain_ms=timer(lambda plain=plain: plain(q, k, v, lse, do, delta, lens, q_off, **bkw), iters=5),
            bound_ms=bnd, bound_by=by, library_ms=lib[1])
    log(f"[time] {tag}: K5 with the LSE {res[RING_ENTRIES['fwd']]['ms']:.4f} ms, K12 dq "
        f"{res[RING_ENTRIES['dq']]['ms']:.4f} ms, dk/dv {res[RING_ENTRIES['dkdv']]['ms']:.4f} ms "
        f"({pairs // hq} pairs a head in band); library "
        f"{'none' if lib[0] is None else f'forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms'}")
    del q, k, v, do, o, lse, delta, got, ref, lse_ref, refs
    torch.cuda.empty_cache()
    return res


def _paged_kernels(dev, timer, gen, q, k_tab, v_tab, lengths, layer, dec_bytes, dec_ops, k_new, v_new,
                   sdpa_ms):
    """K7 and K8 at the decode shapes: the rows of the contiguous table laid
    out in pages of 128 rows under a shuffled page table (pages_per_seq 8),
    so K1 on the table is the yardstick for K7 on the pools. K7's library
    call is SDPA on the same rows laid out contiguously (``sdpa_ms``). Then
    K8 folded into K7, as ``_fold_rows`` does for K3."""
    from starflashattention_tpu_torch.ops.cache_append import (
        append_rows_paged_kv, append_rows_paged_kv_plain)
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode
    from starflashattention_tpu_torch.ops.paged_decode import (paged_flash_decode, paged_flash_decode_append,
                                                               paged_flash_decode_append_plain,
                                                               paged_flash_decode_plain)

    n_layers, b, hkv, s, d = k_tab.shape
    ps = PAGE_SIZE
    pps = s // ps
    num_pages = b * pps + 1  # page 0 is the null page
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    table = perm.reshape(b, pps).to(device=dev, dtype=torch.int32)
    k_pool, v_pool = _pools_from(k_tab, table, ps), _pools_from(v_tab, table, ps)
    res = {}
    out = paged_flash_decode(q, k_pool, v_pool, table, lengths, layer=layer)
    ref = paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, layer=layer)
    err = (out.float() - ref.float()).abs().max().item()
    # as for K1: two fp32 computations over the same bf16 inputs, each
    # rounded once to bf16, may differ by one bf16 ulp of |o| <= 4
    _check(f"paged_flash_decode B={b} Hq={q.shape[1]} Hkv={hkv} D={d} page_size={ps} "
           f"pages_per_seq={pps} shuffled table, lengths 1..{s}", err, 2.0**-8 * 4)
    _check_ulps("paged_flash_decode", out, ref, 1)
    bnd, by = bound_ms(dec_bytes + table.numel() * 4, dec_ops)
    yard = timer(lambda: flash_decode(q, k_tab, v_tab, lengths, layer=layer, num_splits=1, block_k=256))
    run = lambda: paged_flash_decode(q, k_pool, v_pool, table, lengths, layer=layer)  # noqa: E731
    res["paged_flash_decode"] = dict(
        max_abs_err=err,
        ms=timer(run),
        plain_ms=timer(lambda: paged_flash_decode_plain(q, k_pool, v_pool, table, lengths, layer=layer),
                       iters=5),
        bound_ms=bnd, bound_by=by, library_ms=sdpa_ms)
    log_rate("paged_flash_decode", res["paged_flash_decode"]["ms"], dec_bytes + table.numel() * 4, dec_ops,
             split_grid(b, hkv, s))
    coarser_grid("paged_flash_decode", run, b, hkv, s, timer, res["paged_flash_decode"]["ms"])
    log(f"[time] paged_flash_decode yardstick: flash_decode (1 split) on the same rows laid out "
        f"contiguously {yard:.4f} ms")

    pos = torch.clamp(lengths, max=s - 1)
    ka, va = k_pool.clone(), v_pool.clone()
    kp, vp = k_pool.clone(), v_pool.clone()
    append_rows_paged_kv(ka, va, k_new, v_new, layer, table, pos)
    append_rows_paged_kv_plain(kp, vp, k_new, v_new, layer, table, pos)
    same = torch.equal(ka, kp) and torch.equal(va, vp)
    _check("append_rows_paged_kv whole pools", 0.0 if same else float("inf"), 0.0)
    bnd, by = bound_ms(2 * 2 * b * hkv * d * 2 + b * 4 + b * 4, 0)
    bidx, pos_l = torch.arange(b, device=dev), pos.long()

    def index_put_paged():  # the library call: one advanced-index assignment a pool
        phys = table[bidx, pos_l // ps].long()
        kp[layer, :, phys, pos_l % ps] = k_new.transpose(0, 1)
        vp[layer, :, phys, pos_l % ps] = v_new.transpose(0, 1)

    res["append_rows_paged_kv"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: append_rows_paged_kv(ka, va, k_new, v_new, layer, table, pos)),
        plain_ms=timer(lambda: append_rows_paged_kv_plain(kp, vp, k_new, v_new, layer, table, pos)),
        bound_ms=bnd, bound_by=by, library_ms=timer(index_put_paged))

    # K8 folded into K7: each row writes at lengths - 1, the last row it
    # attends; its row is the append's part of the launch, as in _fold_rows
    entry = FOLD_ENTRIES["paged"]
    wpos = lengths - 1
    wpos_l = wpos.long()
    fused = lambda k, v: paged_flash_decode_append(q, k, v, table, k_new, v_new, wpos, lengths,  # noqa: E731
                                                   layer=layer)
    seq = lambda k, v: (append_rows_paged_kv(k, v, k_new, v_new, layer, table, wpos),  # noqa: E731
                        paged_flash_decode(q, k, v, table, lengths, layer=layer))[1]
    _fold_check(f"{entry} shuffled table", (k_pool, v_pool), fused, seq)
    out = fused(ka, va)
    ref = paged_flash_decode_append_plain(q, kp, vp, table, k_new, v_new, wpos, lengths, layer=layer)
    _check(f"{entry} against its plain twin", (out.float() - ref.float()).abs().max().item(), 2.0**-8 * 4)
    err = _tables_err((ka, va), (kp, vp))
    _check(f"{entry} whole pools against the plain twin's", err, 0.0)
    t_fused, t_alone, t_seq, share = _fold_times(
        timer, lambda: fused(ka, va), lambda: paged_flash_decode(q, ka, va, table, lengths, layer=layer),
        lambda: seq(ka, va))
    # the rows written and the write positions read (the table lookup and
    # the new row's read are the decode's own)
    bnd, by = bound_ms(2 * b * hkv * d * 2 + b * 4, 0)

    def index_put_fold():  # the library call: one advanced-index assignment a pool
        phys = table[bidx, wpos_l // ps].long()
        kp[layer, :, phys, wpos_l % ps] = k_new.transpose(0, 1)
        vp[layer, :, phys, wpos_l % ps] = v_new.transpose(0, 1)

    res[entry] = dict(
        max_abs_err=err, ms=share,
        plain_ms=timer(lambda: append_rows_paged_kv_plain(kp, vp, k_new, v_new, layer, table, wpos)),
        bound_ms=bnd, bound_by=by, library_ms=timer(index_put_fold))
    log(f"[fold] {entry}: fused {t_fused:.4f} ms, K7 alone {t_alone:.4f} ms, K8 then K7 {t_seq:.4f} ms "
        f"(medians of {FOLD_ROUNDS} interleaved rounds); the append's part of the fused launch {share:+.4f} ms "
        f"(its bound {bnd:.6f} ms); fused {'below' if t_fused < t_seq else 'NOT below'} K8 then K7")
    return res


def _spec_kernels(dev, timer, gen):
    """K1's verify mode and K9 at a verify step's shapes: B=8 slots, Hq=32,
    Hkv=8, S=1024, D=128, T=5 tokens, ragged lengths, a 2-layer table at
    layer 1. Verify on bf16 and int8 KV against its plain twin (in bf16
    ulps), every query token j bit for bit against the fused decode at
    lengths + j; K9 whole tables equal (bf16 and int8 rows), one row
    inactive (n_valid 0). Library calls: SDPA with the staircase mask, an
    advanced-index assignment a table."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.quant import quantize_value
    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops.cache_append import append_block_kv, append_block_kv_plain
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode, flash_verify, flash_verify_plain

    b, hq, hkv, s, d, t, layer = SPEC_SLOTS, 32, 8, 1024, 128, SPEC_DRAFTS + 1, 1
    bf16 = torch.bfloat16
    q = torch.randn((b, hq, t, d), generator=gen, device=dev, dtype=bf16)
    k_tab = torch.randn((2, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    v_tab = torch.randn((2, b, hkv, s, d), generator=gen, device=dev, dtype=bf16)
    lengths = torch.randint(1, s - t + 2, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 1, s - t + 1  # the last token of row 1 attends the whole table
    tok_len = lengths[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None, :]  # (B, T)
    mask = (torch.arange(s, device=dev)[None, None, :] < tok_len[:, :, None])[:, None]  # (B, 1, T, S)
    n_pairs = int(tok_len.sum())
    n_rows = int((lengths + t - 1).sum())  # K/V rows the step reads: its last token's
    res = {}
    for mode in ("bf16", "int8"):
        kw = dict(layer=layer)
        kq, vq = k_tab, v_tab
        if mode == "int8":
            scales = torch.full((hkv,), KV_SCALE["int8"], dtype=torch.float32, device=dev)
            kq, vq = (quantize_value(x, scales, "int8", head_axis=2) for x in (k_tab, v_tab))
            kw.update(k_scales=scales, v_scales=scales)
        entry = "flash_verify" if mode == "bf16" else "flash_verify int8 KV"
        out = flash_verify(q, kq, vq, lengths, **kw)
        ref = flash_verify_plain(q, kq, vq, lengths, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"[kernel] {entry}: max_abs_err {err:.3e}")
        # as the fused decode: one bf16 rounding each side (two with int8 KV)
        _check_ulps(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d} T={t}", out, ref, 1 if mode == "bf16" else 2)
        bitwise = max((out[:, :, j].float() - flash_decode(q[:, :, j], kq, vq, lengths + j, num_splits=1,
                                                           **kw).float()).abs().max().item()
                      for j in range(t))
        _check(f"{entry} token j vs fused flash_decode at lengths + j (bit for bit)", bitwise, 0.0)
        elt = kq.element_size()
        n_bytes = 2 * n_rows * hkv * d * elt + 2 * q.numel() * 2 + b * 4 + (2 * hkv * 4 if mode == "int8" else 0)
        bnd, by = bound_ms(n_bytes, 4 * hq * d * n_pairs)
        deq = [repeat_kv((x[layer].float() * (KV_SCALE["int8"] if mode == "int8" else 1.0)).to(bf16),
                         hq // hkv) for x in (kq, vq)]
        run = lambda: flash_verify(q, kq, vq, lengths, **kw)  # noqa: E731
        res[entry] = dict(
            max_abs_err=err, ms=timer(run),
            plain_ms=timer(lambda: flash_verify_plain(q, kq, vq, lengths, **kw), iters=5),
            bound_ms=bnd, bound_by=by,
            library_ms=timer(lambda: F.scaled_dot_product_attention(q, deq[0], deq[1], attn_mask=mask)))
        log_rate(entry, res[entry]["ms"], n_bytes, 4 * hq * d * n_pairs, split_grid(b, hkv, s))
        coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])
        if mode == "bf16":  # the same table's one-token decode, at the longest token's length
            q0, last = q[:, :, 0].contiguous(), lengths + t - 1
            yard = timer(lambda: flash_decode(q0, kq, vq, last, num_splits=1, **kw))
            log(f"[time] flash_verify yardstick: fused flash_decode of one token a sequence at lengths + "
                f"T - 1 on the same table {yard:.4f} ms (verify / decode {res[entry]['ms'] / yard:.2f}x "
                f"for T = {t} tokens)")
        del deq

    # K9: rows at min(lengths, S - T) as the verify step writes them; row 2 inactive
    k_new = torch.randn((b, hkv, t, d), generator=gen, device=dev, dtype=bf16)
    v_new = torch.randn((b, hkv, t, d), generator=gen, device=dev, dtype=bf16)
    pos = torch.clamp(lengths, max=s - t)
    n_valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    n_valid[2] = 0
    for mode in ("bf16", "int8"):
        kn, vn, kt, vt = k_new, v_new, k_tab, v_tab
        if mode == "int8":
            kn, vn, kt, vt = (x.to(torch.int8) for x in (k_new, v_new, k_tab, v_tab))
        tabs = [x.clone() for x in (kt, vt, kt, vt)]
        append_block_kv(tabs[0], tabs[1], kn, vn, layer, pos, n_valid)
        append_block_kv_plain(tabs[2], tabs[3], kn, vn, layer, pos, n_valid)
        same = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in ((tabs[0], tabs[2]), (tabs[1], tabs[3])))
        _check(f"append_block_kv {mode} rows B={b} Hkv={hkv} T={t} D={d}, whole tables", 0.0 if same else
               float("inf"), 0.0)
        ms = timer(lambda: append_block_kv(tabs[0], tabs[1], kn, vn, layer, pos, n_valid))
        if mode == "int8":
            log(f"[time] append_block_kv on int8 rows: {ms:.4f} ms")
            continue
        jj = torch.arange(t, device=dev)[None, :]
        bi, ji = (jj < n_valid[:, None]).nonzero(as_tuple=True)
        rows = (pos[:, None].long() + jj)[bi, ji]

        def index_put_block():  # the library call: one advanced-index assignment a table
            tabs[2][layer][bi, :, rows] = kn[bi, :, ji]
            tabs[3][layer][bi, :, rows] = vn[bi, :, ji]

        bnd, by = bound_ms(2 * 2 * int(n_valid.sum()) * hkv * d * 2 + 2 * b * 4, 0)
        k9 = res["append_block_kv"] = dict(
            max_abs_err=0.0, ms=ms,
            plain_ms=timer(lambda: append_block_kv_plain(tabs[2], tabs[3], kn, vn, layer, pos, n_valid)),
            bound_ms=bnd, bound_by=by, library_ms=timer(index_put_block))
        log(f"[time] append_block_kv (K9 standalone, on no path since its fold): kernel {k9['ms']:.4f} ms, plain "
            f"{k9['plain_ms']:.4f} ms, library (index assignment) {k9['library_ms']:.4f} ms, bound {bnd:.6f} ms "
            f"({by})")
        del tabs
    res.update(_verify_fold_row(dev, timer, q, k_tab, v_tab, lengths, layer, n_valid))
    return res


def _verify_fold_row(dev, timer, q, k_tab, v_tab, lengths, layer, n_valid):
    """K9 folded into K1's verify mode at the verify step's shape: each row
    writes its span at min(lengths - 1, S - T), as ``_verify_core`` passes
    it (its start, lengths - 1), the inactive row (``n_valid`` 0) none. The
    fused launch against K9 then the verify (bit for bit), timed beside the
    verify alone and beside K9 then the verify, in one call. Its
    kernels-line row is the append's part of the launch, so that the
    verify's row, which counts the same launches, keeps the verify's time:
    ms the fused launch less the verify alone, its bound the rows written
    and the positions and counts read (the fused launch reads the new rows
    in place of the table rows the verify reads), its plain twin
    ``append_block_kv_plain`` and its library call an index assignment a
    table, both at the same positions, its error over the whole tables
    against the plain twin's. Its new rows come from a generator of its
    own, so the rows after it in phase 2 draw what they drew before it was
    added."""
    from starflashattention_tpu_torch.ops.cache_append import append_block_kv, append_block_kv_plain
    from starflashattention_tpu_torch.ops.flash_decode import (flash_verify, flash_verify_append,
                                                               flash_verify_append_plain)

    entry = FOLD_ENTRIES["verify"]
    b, hq, t, d = q.shape
    hkv, s = k_tab.shape[2], k_tab.shape[3]
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    k_new, v_new = (torch.randn((b, hkv, t, d), generator=gen, device=dev, dtype=q.dtype) for _ in range(2))
    start = lengths - 1
    pos = torch.clamp(start, max=s - t)
    kw = dict(layer=layer)
    fused = lambda k, v: flash_verify_append(q, k, v, k_new, v_new, start, n_valid, lengths, **kw)  # noqa: E731
    seq = lambda k, v: (append_block_kv(k, v, k_new, v_new, layer, pos, n_valid),  # noqa: E731
                        flash_verify(q, k, v, lengths, **kw))[1]
    _fold_check(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d} T={t}", (k_tab, v_tab), fused, seq)
    ka, va = k_tab.clone(), v_tab.clone()
    kp, vp = k_tab.clone(), v_tab.clone()
    out = fused(ka, va)
    ref = flash_verify_append_plain(q, kp, vp, k_new, v_new, start, n_valid, lengths, **kw)
    _check_ulps(f"{entry} against its plain twin", out, ref, 1)
    err = _tables_err((ka, va), (kp, vp))
    _check(f"{entry} whole tables against the plain twin's", err, 0.0)
    t_fused, t_alone, t_seq, share = _fold_times(timer, lambda: fused(ka, va),
                                                 lambda: flash_verify(q, ka, va, lengths, **kw),
                                                 lambda: seq(ka, va))
    jj = torch.arange(t, device=dev)[None, :]
    bi, ji = (jj < n_valid[:, None]).nonzero(as_tuple=True)
    rows = (pos[:, None].long() + jj)[bi, ji]

    def index_put_block():  # the library call: one advanced-index assignment a table
        kp[layer][bi, :, rows] = k_new[bi, :, ji]
        vp[layer][bi, :, rows] = v_new[bi, :, ji]

    bnd, by = bound_ms(2 * int(n_valid.sum()) * hkv * d * q.element_size() + 2 * b * 4, 0)
    res = {entry: dict(max_abs_err=err, ms=share,
                       plain_ms=timer(lambda: append_block_kv_plain(kp, vp, k_new, v_new, layer, pos, n_valid)),
                       bound_ms=bnd, bound_by=by, library_ms=timer(index_put_block))}
    log(f"[fold] {entry}: fused {t_fused:.4f} ms, K1 verify alone {t_alone:.4f} ms, K9 then K1 verify "
        f"{t_seq:.4f} ms (medians of {FOLD_ROUNDS} interleaved rounds); the append's part of the fused launch "
        f"{share:+.4f} ms (its bound {bnd:.6f} ms); fused {'below' if t_fused < t_seq else 'NOT below'} K9 then "
        f"K1 verify")
    return res


def _attended_rows(lengths, window, sinks):
    """KV rows a decode row of each length attends: its band, min(len,
    window), plus the sinks below it."""
    lens = lengths.long()
    if window is None:
        return lens
    return torch.clamp(lens, max=window) + torch.clamp(lens - window, min=0).clamp(max=sinks)


def _poison_below(tab, starts, sinks):
    """A copy of a (1, B, Hkv, S, D) table whose whole POISON_BLOCK-row
    blocks below each sequence's band start ``starts[b]`` hold NaN; the
    blocks that hold sinks are spared. Returns (copy, rows poisoned)."""
    out, n = tab.clone(), 0
    first = -(-sinks // POISON_BLOCK) * POISON_BLOCK
    for b, lo in enumerate(starts.tolist()):
        end = max(lo, 0) // POISON_BLOCK * POISON_BLOCK
        if end > first:
            out[:, b, :, first:end] = float("nan")
            n += end - first
    return out, n


def _reclaim_below(table, starts, sinks, ps):
    """The page table with every page inside a whole POISON_BLOCK-row block
    below the band set to the null page 0, sink pages kept (the engine's
    reclamation, at block granularity). Returns (table, pages nulled)."""
    out, n = table.clone(), 0
    first = -(-sinks // POISON_BLOCK) * POISON_BLOCK // ps
    for b, lo in enumerate(starts.tolist()):
        end = max(lo, 0) // POISON_BLOCK * POISON_BLOCK // ps
        if end > first:
            out[b, first:end] = 0
            n += end - first
    return out, n


def _band_check(name, kernel_clean, kernel_poisoned, n_poisoned):
    """The kernel never reads below the band: NaN there changes no bit of
    its output."""
    if n_poisoned <= 0:
        raise AssertionError(f"{name}: the band check poisoned nothing")
    finite = bool(torch.isfinite(kernel_poisoned).all())
    same = finite and torch.equal(kernel_poisoned, kernel_clean)
    log(f"[kernel] {name} band check: {n_poisoned} rows or pages below the band set to NaN (the null "
        f"page for pages), output finite {finite}, bit for bit the clean cache's {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: the kernel read below its band")


def _sensitive(name, what, changed, ref, roundings):
    """The check above can fail: the kernel run without ``what`` lies more
    than 4x the tolerance away from the twin."""
    tol = roundings + 1.0
    err = _ulps(changed, ref)
    ok = err > 4 * tol
    log(f"[kernel] {name} without {what}: {err:.3e} bf16 ulps from the twin, over 4x the tolerance "
        f"{tol:.1f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {what} does not move the output past the check's tolerance")


_FLEX = []


def _flex_call(q, k, v, base, window, sinks, softcap, scale):
    """One ``flex_attention`` call (compiled) computing a variant kernel's
    function: query row i of sequence b attends the KV rows below
    ``base[b] + i`` that lie in its band or are sinks (the block mask, built
    here once), and ``softcap`` (if any) caps the scaled scores (the
    score_mod).
    q (B, Hq, Lq, D); k, v (B, Hkv, S, D). Returns the call."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if not _FLEX:
        # one compiled program per row's shapes and closures; past dynamo's
        # default of 8 the call would quietly run eagerly
        torch._dynamo.config.cache_size_limit = 64
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    window = k.shape[2] + 2 if window is None else window

    def band(b, h, qi, kv):
        n = base[b] + qi
        return (kv < n) & ((kv >= n - window) | (kv < sinks))

    def cap(score, b, h, qi, kv):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(band, q.shape[0], None, q.shape[2], k.shape[2], device=q.device)
    score_mod = None if softcap is None else cap
    return lambda: _FLEX[0](q, k, v, score_mod=score_mod, block_mask=mask, scale=scale, enable_gqa=True)


def _variants_form(entry, run, run_variants, out, timer, ms):
    """The plain decode (``run``, timed at ``ms``) once more in the split
    kernel's VARIANTS form (``run_variants``: a window as long as the table,
    which masks nothing): bit for bit the plain form's ``out``; logs the
    time of both forms."""
    same = torch.equal(run_variants(), out)
    _check(f"{entry} in the VARIANTS form (window = S), bit for bit the plain form", 0.0 if same else
           float("inf"), 0.0, what="mismatch")
    t = timer(run_variants)
    log(f"[variants] {entry}: plain form {ms:.4f} ms, VARIANTS form (window, sinks and softcap as runtime "
        f"arguments) {t:.4f} ms ({t / ms - 1:+.1%})")


def split_grid(b, hkv, s, d=128):
    """(N, C) of a merging split-KV decode call on this card at head_dim d
    (one grid for D 64, 128 and 256): the chunk count and the rows each
    block walks (ops/flash_decode.split_chunking)."""
    from starflashattention_tpu_torch.ops.flash_decode import sm_count, split_chunking

    c, n = split_chunking(s, b, hkv, sm_count(torch.device("cuda", 0)), d)
    return n, c


@contextlib.contextmanager
def forced_chunk(c):
    """Inside the block, merging split-KV decode calls take chunks of ``c``
    rows (ops/flash_decode.split_chunking patched)."""
    from starflashattention_tpu_torch.ops import flash_decode as fd

    keep = fd.split_chunking
    fd.split_chunking = lambda s, *_: (c, -(-s // c))
    try:
        yield
    finally:
        fd.split_chunking = keep


def coarser_grid(entry, fn, b, hkv, s, timer, ms):
    """Log the chunk grid a merging split-KV row ran at ``ms`` and time the
    row once more on a coarser grid, chunks twice as long; returns that
    time."""
    n, c = split_grid(b, hkv, s)
    with forced_chunk(2 * c):
        coarse = timer(fn)
    log(f"[grid] {entry}: {n} chunks of {c} rows a (sequence, KV head), {ms:.4f} ms; coarser grid, "
        f"{-(-s // (2 * c))} chunks of {2 * c} rows: {coarse:.4f} ms ({coarse / ms - 1:+.1%})")
    return coarse


def _variant_kernels(dev, timer, gen):
    """The attention variants at the phase 10 families' shapes, S = 8192
    cache rows and lengths 5,000-8,000 (past the 4096 window): K1 with the
    window and 4 sinks (Mistral-7B: Hq 32, Hkv 8, D 128), K1 at D 256 with
    softcap 50 on a sliding (4096) and a full layer (Gemma-2-9B: Hq 16,
    Hkv 8), K1 verify (T = 5) with both, K2 at D 256 with 4 splits
    (Gemma-7B: Hq = Hkv = 16), K7 on both families' rows in 128-row pages,
    K5 on 2048-row chunks (PagedEngine's) at offsets 4608 and 6144. Each
    against its plain twin in bf16 ulps of each element, the windowed ones
    also through the NaN band check. Gemma-2's q is scaled so that its
    scores reach the cap, and K1, K7 and K5 are run once without the cap
    (and Mistral's K1 and K5 without the sinks) to show that the check sees
    the option. Library: SDPA with the band mask; with a softcap,
    flex_attention with the cap as its score_mod and the band as its block
    mask, itself held to the twin."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_plain,
                                                               flash_verify, flash_verify_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain
    from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_plain

    bf16, s, w, sk, cap = torch.bfloat16, VARIANT_SEQ, VARIANT_WINDOW, VARIANT_SINKS, GEMMA2_SOFTCAP
    b = VARIANT_BATCH
    res = {}
    kpos = torch.arange(s, device=dev)

    def tables(hkv, d):
        return [torch.randn((1, b, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2)]

    def flex_library(entry, q4, k, v, base, kw, ref):
        """Library ms of a softcap row: flex_attention, first held to the
        twin (within LIBRARY_ULPS: it rounds its scores or P to bf16 on its
        own terms; a wrong mask or cap is off by hundreds)."""
        call = _flex_call(q4, k, v, base, kw.get("window"), kw.get("sinks", 0), kw["softcap"],
                          kw["sm_scale"])
        _check_ulps(f"{entry} library call (flex_attention)", call().reshape(ref.shape), ref, LIBRARY_ULPS - 1)
        return timer(call)

    lengths = torch.randint(5000, 8001, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 5000, 8000

    def decode_row(entry, q, k_tab, v_tab, lens, kw, band, library, drop=None):
        """K1 (or K2) against its twin; ``band`` = (window, sinks) for the
        NaN check and the in-band bound, else None; ``library(ref)`` -> ms;
        ``drop`` = (what, option overrides) for the sensitivity check."""
        hq, d = q.shape[1], q.shape[-1]
        hkv = k_tab.shape[2]
        out = flash_decode(q, k_tab, v_tab, lens, **kw)
        ref = flash_decode_plain(q, k_tab, v_tab, lens, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        _check_ulps(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d} lengths {lens.min().item()}.."
                    f"{lens.max().item()}", out, ref, 1)
        if drop is not None:
            _sensitive(entry, drop[0], flash_decode(q, k_tab, v_tab, lens, **{**kw, **drop[1]}), ref, 1)
        rows = int(_attended_rows(lens, *(band or (None, 0))).sum())
        n_bytes, n_ops = 2 * q.numel() * 2 + 2 * rows * hkv * d * 2 + b * 4, 4 * hq * d * rows
        bnd, by = bound_ms(n_bytes, n_ops)
        if band is not None:
            kp, n = _poison_below(k_tab, lens - band[0], band[1])
            vp, _ = _poison_below(v_tab, lens - band[0], band[1])
            _band_check(entry, out, flash_decode(q, kp, vp, lens, **kw), n)
            del kp, vp
        run = lambda: flash_decode(q, k_tab, v_tab, lens, **kw)  # noqa: E731
        res[entry] = dict(max_abs_err=err, ms=timer(run),
                          plain_ms=timer(lambda: flash_decode_plain(q, k_tab, v_tab, lens, **kw), iters=5),
                          bound_ms=bnd, bound_by=by, library_ms=library(ref) if library else None)
        splits = kw["num_splits"]
        grid = split_grid(b, hkv, s) if splits == 1 else (splits, s // splits)
        log_rate(entry, res[entry]["ms"], n_bytes, n_ops, grid)
        if d == 128 and splits == 1:
            coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])

    def band_mask(lens, window, sinks):  # (B, 1, 1, S): the decode row's attended rows
        m = (kpos[None, :] < lens[:, None]) & (kpos[None, :] >= lens[:, None] - window)
        return (m | (kpos[None, :] < sinks))[:, None, None]

    def paged_row(entry, q, k_tab, v_tab, lens, kw, band, library, drop=None):
        hq, d = q.shape[1], q.shape[-1]
        hkv = k_tab.shape[2]
        ps, pps = PAGE_SIZE, s // PAGE_SIZE
        perm = torch.randperm(b * pps, generator=torch.Generator().manual_seed(SEED)) + 1
        table = perm.reshape(b, pps).to(device=dev, dtype=torch.int32)
        kpool, vpool = _pools_from(k_tab, table, ps), _pools_from(v_tab, table, ps)
        out = paged_flash_decode(q, kpool, vpool, table, lens, layer=0, **kw)
        ref = paged_flash_decode_plain(q, kpool, vpool, table, lens, layer=0, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        _check_ulps(f"{entry} B={b} Hq={hq} Hkv={hkv} D={d} page_size={ps} pages_per_seq={pps} shuffled",
                    out, ref, 1)
        if drop is not None:
            _sensitive(entry, drop[0], paged_flash_decode(q, kpool, vpool, table, lens, layer=0,
                                                          **{**kw, **drop[1]}), ref, 1)
        reclaimed, n = _reclaim_below(table, lens - band[0], band[1], ps)
        kpool[:, :, 0], vpool[:, :, 0] = float("nan"), float("nan")  # the null page
        _band_check(entry, out, paged_flash_decode(q, kpool, vpool, reclaimed, lens, layer=0, **kw), n)
        kpool[:, :, 0], vpool[:, :, 0] = 0.0, 0.0
        rows = int(_attended_rows(lens, *band).sum())
        n_bytes = 2 * q.numel() * 2 + 2 * rows * hkv * d * 2 + b * 4 + table.numel() * 4
        bnd, by = bound_ms(n_bytes, 4 * hq * d * rows)
        run = lambda: paged_flash_decode(q, kpool, vpool, table, lens, layer=0, **kw)  # noqa: E731
        res[entry] = dict(
            max_abs_err=err, ms=timer(run),
            plain_ms=timer(lambda: paged_flash_decode_plain(q, kpool, vpool, table, lens, layer=0, **kw),
                           iters=5),
            bound_ms=bnd, bound_by=by, library_ms=library(ref) if library else None)
        log_rate(entry, res[entry]["ms"], n_bytes, 4 * hq * d * rows, split_grid(b, hkv, s))
        if d == 128:
            coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])
        del kpool, vpool

    # -- Mistral-7B: window 4096 + 4 sinks, D 128
    hq, hkv, d = 32, 8, 128
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=bf16)
    k_tab, v_tab = tables(hkv, d)
    kw = dict(layer=0, num_splits=1, window=w, sinks=sk)
    kr, vr = (repeat_kv(x[0], hq // hkv) for x in (k_tab, v_tab))
    mask = band_mask(lengths, w, sk)
    sdpa = lambda ref: timer(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr,  # noqa: E731
                                                                    attn_mask=mask))
    decode_row(VARIANT_ENTRIES["mistral_decode"], q, k_tab, v_tab, lengths, kw, (w, sk), sdpa,
               drop=("the sinks", dict(sinks=0)))
    paged_row(VARIANT_ENTRIES["mistral_paged"], q, k_tab, v_tab, lengths, dict(window=w, sinks=sk),
              (w, sk), sdpa)
    del kr, vr, k_tab, v_tab

    # -- Gemma-2-9B: D 256, softcap 50, query_scale 256; sliding and full
    # layers. q is scaled by GEMMA2_Q_SCALE so that the scores (sm_scale
    # 1/16) spread over several times the cap and the tanh bends them.
    hq, hkv, d = 16, 8, 256
    sm = 256.0**-0.5
    q = (torch.randn((b, hq, d), generator=gen, device=dev) * GEMMA2_Q_SCALE).to(bf16)
    k_tab, v_tab = tables(hkv, d)
    no_cap = ("the softcap", dict(softcap=None))
    for key, win in (("gemma2_decode", w), ("gemma2_decode_full", s + 2)):
        kw = dict(layer=0, num_splits=1, sm_scale=sm, window=win, softcap=cap)
        entry = VARIANT_ENTRIES[key]
        decode_row(entry, q, k_tab, v_tab, lengths, kw, (win, 0) if win < s else None,
                   lambda ref, entry=entry, kw=kw: flex_library(entry, q[:, :, None], k_tab[0], v_tab[0],
                                                                lengths, kw, ref),
                   drop=no_cap if win < s else None)
    kw = dict(sm_scale=sm, window=w, softcap=cap)
    entry = VARIANT_ENTRIES["gemma2_paged"]
    paged_row(entry, q, k_tab, v_tab, lengths, kw, (w, 0),
              lambda ref: flex_library(entry, q[:, :, None], k_tab[0], v_tab[0], lengths, kw, ref),
              drop=no_cap)
    # verify: T = 5 tokens, token 0 at the lengths above (its last token's band ends at lengths + 4)
    t = SPEC_DRAFTS + 1
    qv = (torch.randn((b, hq, t, d), generator=gen, device=dev) * GEMMA2_Q_SCALE).to(bf16)
    vlens = torch.clamp(lengths, max=s - t + 1)
    kw = dict(layer=0, sm_scale=sm, window=w, softcap=cap)
    entry = VARIANT_ENTRIES["gemma2_verify"]
    out = flash_verify(qv, k_tab, v_tab, vlens, **kw)
    ref = flash_verify_plain(qv, k_tab, v_tab, vlens, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    _check_ulps(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d} T={t}", out, ref, 1)
    bitwise = max((out[:, :, j].float() - flash_decode(qv[:, :, j], k_tab, v_tab, vlens + j, num_splits=1,
                                                       **kw).float()).abs().max().item() for j in range(t))
    _check(f"{entry} token j vs fused flash_decode at lengths + j (bit for bit)", bitwise, 0.0)
    kp, n = _poison_below(k_tab, vlens - w, 0)
    vp, _ = _poison_below(v_tab, vlens - w, 0)
    _band_check(entry, out, flash_verify(qv, kp, vp, vlens, **kw), n)
    del kp, vp
    tok_len = vlens[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    n_pairs = int(_attended_rows(tok_len.flatten(), w, 0).sum())
    n_rows = int((torch.clamp(vlens + t - 1, max=s) - torch.clamp(vlens - w, min=0)).sum())
    n_bytes = 2 * qv.numel() * 2 + 2 * n_rows * hkv * d * 2 + b * 4
    bnd, by = bound_ms(n_bytes, 4 * hq * d * n_pairs)
    res[entry] = dict(max_abs_err=err, ms=timer(lambda: flash_verify(qv, k_tab, v_tab, vlens, **kw)),
                      plain_ms=timer(lambda: flash_verify_plain(qv, k_tab, v_tab, vlens, **kw), iters=5),
                      bound_ms=bnd, bound_by=by,
                      library_ms=flex_library(entry, qv, k_tab[0], v_tab[0], vlens, kw, ref))
    log_rate(entry, res[entry]["ms"], n_bytes, 4 * hq * d * n_pairs, split_grid(b, hkv, s))
    del k_tab, v_tab, qv

    # -- Gemma-7B: D 256, Hq = Hkv = 16, 4 splits (K2), no band
    hq, hkv, d = 16, 16, 256
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=bf16)
    k_tab, v_tab = tables(hkv, d)
    mask = (kpos[None, :] < lengths[:, None])[:, None, None]
    decode_row(VARIANT_ENTRIES["gemma_split"], q, k_tab, v_tab, lengths,
               dict(layer=0, num_splits=4, block_k=256), None,
               lambda ref: timer(lambda: F.scaled_dot_product_attention(q[:, :, None], k_tab[0], v_tab[0],
                                                                        attn_mask=mask)))
    del k_tab, v_tab

    # -- prefill: 2048-row chunks (PagedEngine's) at offsets 4608 and 6144 of S = 8192
    sq = VAR_CHUNK
    q_off = torch.tensor([4608, 6144], dtype=torch.int32, device=dev)
    lens = q_off + sq
    for key, (hq, hkv, d, kw, drop) in (
            ("gemma2_prefill", (16, 8, 256, dict(sm_scale=256.0**-0.5, window=w, softcap=cap), no_cap)),
            ("mistral_prefill", (32, 8, 128, dict(window=w, sinks=sk), ("the sinks", dict(sinks=0))))):
        entry = VARIANT_ENTRIES[key]
        sinks = kw.get("sinks", 0)
        scale = GEMMA2_Q_SCALE if "softcap" in kw else 1.0
        q = (torch.randn((2, hq, sq, d), generator=gen, device=dev) * scale).to(bf16)
        k, v = (torch.randn((2, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
        out = flash_prefill(q, k, v, lens, q_offsets=q_off, **kw)
        ref = flash_prefill_plain(q, k, v, lens, q_offsets=q_off, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        # two roundings on the kernel's side (P to bf16 for P @ V, the output), one on the twin's
        _check_ulps(f"{entry} B=2 Hq={hq} Hkv={hkv} D={d} Sq={sq} Skv={s} q_offsets=[4608,6144]", out, ref, 2)
        _sensitive(entry, drop[0], flash_prefill(q, k, v, lens, q_offsets=q_off, **{**kw, **drop[1]}), ref, 2)
        starts = q_off - w + 1  # the band start of each chunk's first row
        kp, n = _poison_below(k[None], starts, sinks)
        vp, _ = _poison_below(v[None], starts, sinks)
        _band_check(entry, out, flash_prefill(q, kp[0], vp[0], lens, q_offsets=q_off, **kw), n)
        del kp, vp
        pos = (q_off[:, None] + torch.arange(sq, device=dev)[None, :]).flatten()
        n_pairs = int(_attended_rows(pos + 1, w, sinks).sum())
        # rows read: each chunk's band from its first row's start, plus the sinks below it
        n_rows = sum(int(n) - max(int(lo), 0) + min(max(int(lo), 0), sinks)
                     for n, lo in zip(lens.tolist(), starts.tolist()))
        bnd, by = bound_ms(2 * q.numel() * 2 + 2 * n_rows * hkv * d * 2, 4 * d * hq * n_pairs)
        if "softcap" in kw:
            library = flex_library(entry, q, k, v, q_off + 1, kw, ref)
        else:
            kk, vv = repeat_kv(k, hq // hkv), repeat_kv(v, hq // hkv)
            qpos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
            m = ((kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < lens[:, None, None])
                 & ((kpos[None, None, :] > qpos[:, :, None] - w) | (kpos[None, None, :] < sinks)))[:, None]
            library = timer(lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=m))
            del kk, vv, m
        res[entry] = dict(max_abs_err=err, ms=timer(lambda: flash_prefill(q, k, v, lens, q_offsets=q_off, **kw)),
                          plain_ms=timer(lambda: flash_prefill_plain(q, k, v, lens, q_offsets=q_off, **kw),
                                         iters=5),
                          bound_ms=bnd, bound_by=by, library_ms=library)
        del q, k, v
    torch.cuda.empty_cache()
    return res


def _latent_kernels(dev, timer, gen):
    """MLA's latent geometry (DeepSeek-V2-Lite: 16 query heads on one
    640-lane latent KV head, sm_scale 192 ** -0.5, bf16): K1 at B 4, S 4096,
    lengths 2,000-4,064; K2 (4 splits) on the same rows, its partials held
    to flash_decode_with_stats_plain; K7 on the same rows in 128-row
    shuffled pages; K5 on 2048-row causal chunks at offsets 0 and 2048. Each
    within 1 (decode) or 2 (K5) roundings of each element of its twin, and
    each shown to see the shape: with q's rope lanes (512-575) zeroed, or
    its heads rolled by 8, the kernel lies over 4x that tolerance from the
    twin. K1 is also timed on chunks half and twice the grid's (``[grid]``)
    and against a partials-only launch at its grid (``[merge]``: the
    in-launch merge's share). Library: SDPA with the length (causal) mask
    on the rows repeated to 16 heads. Then the
    expert stacks at decode rows (4), through the free (L * E, ...) view at
    index lidx * E + e: K6 on DeepSeek-V2-Lite's int4 g128 experts (gate_up
    2048 -> 2816 written in bf16, down 1408 -> 2048 in fp32) and K4 on
    Mixtral-8x7B's int8 experts (4096 -> 28672, 14336 -> 4096), against
    their twins, library ``torch.matmul`` on the bf16 dequantized expert."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.quant import dequantize_weight
    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops import quant_matmul as qmm
    from starflashattention_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_plain,
                                                               flash_decode_with_stats,
                                                               flash_decode_with_stats_plain)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain
    from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_plain

    bf16, e = torch.bfloat16, LATENT_ENTRIES
    b, hq, s, d, sm = LATENT_BATCH, LATENT_GROUP, LATENT_SEQ, 640, 192.0**-0.5
    res = {}

    def shape_checks(entry, run, q, ref, roundings):
        """The check sees the latent row's rope lanes and each head's own q."""
        no_rope = q.clone()
        no_rope[..., 512:576] = 0
        _sensitive(entry, "q's rope lanes (512-575)", run(no_rope), ref, roundings)
        _sensitive(entry, "each head's own q (heads rolled by 8)", run(q.roll(8, dims=1)), ref, roundings)

    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=bf16)
    k_tab, v_tab = (torch.randn((1, b, 1, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    lo, hi = s // 2 - 48, s - 32  # 2,000-4,064 rows at 4096
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = lo, hi
    n_valid = int(lengths.sum())
    kr, vr = repeat_kv(k_tab[0], hq), repeat_kv(v_tab[0], hq)
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr, attn_mask=mask, scale=sm))
    del kr, vr
    dec_bytes, dec_ops = 2 * q.numel() * 2 + 2 * n_valid * d * 2 + b * 4, 4 * hq * d * n_valid
    kw = dict(layer=0, num_splits=1, sm_scale=sm)
    out = flash_decode(q, k_tab, v_tab, lengths, **kw)
    ref = flash_decode_plain(q, k_tab, v_tab, lengths, **kw)
    _check_ulps(f"{e['decode']} B={b} Hq={hq} Hkv=1 S={s} lengths {lengths.tolist()}", out, ref, 1)
    shape_checks(e["decode"], lambda qq: flash_decode(qq, k_tab, v_tab, lengths, **kw), q, ref, 1)
    bnd, by = bound_ms(dec_bytes, dec_ops)
    run = lambda: flash_decode(q, k_tab, v_tab, lengths, **kw)  # noqa: E731
    res[e["decode"]] = dict(
        max_abs_err=(out.float() - ref.float()).abs().max().item(), ms=timer(run),
        plain_ms=timer(lambda: flash_decode_plain(q, k_tab, v_tab, lengths, **kw), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    log_rate(e["decode"], res[e["decode"]]["ms"], dec_bytes, dec_ops, split_grid(b, 1, s, d))
    _latent_grid(e["decode"], run, out, q, k_tab, v_tab, lengths, sm, timer, res[e["decode"]]["ms"])

    # K2: the caller's 4 splits (the ModelConfig default), merged by lse_combine_splits
    kw4 = dict(layer=0, num_splits=4, sm_scale=sm)
    out = flash_decode(q, k_tab, v_tab, lengths, **kw4)
    ref = flash_decode_plain(q, k_tab, v_tab, lengths, **kw4)
    _check_ulps(f"{e['split']} B={b} Hq={hq} Hkv=1 S={s}", out, ref, 1)
    shape_checks(e["split"], lambda qq: flash_decode(qq, k_tab, v_tab, lengths, **kw4), q, ref, 1)
    parts = flash_decode_with_stats(q, k_tab, v_tab, lengths, **kw4)
    for name, err in _partial_errors(parts, flash_decode_with_stats_plain(q, k_tab, v_tab, lengths,
                                                                          **kw4)).items():
        _check(f"{e['split']}: flash_decode_with_stats {name}", err, 0.0 if name == "dead splits" else 1e-4)
    del parts
    res[e["split"]] = dict(
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        ms=timer(lambda: flash_decode(q, k_tab, v_tab, lengths, **kw4)),
        plain_ms=timer(lambda: flash_decode_plain(q, k_tab, v_tab, lengths, **kw4), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    log_rate(e["split"], res[e["split"]]["ms"], dec_bytes, dec_ops, (4, s // 4))

    pps = s // PAGE_SIZE
    perm = torch.randperm(b * pps, generator=torch.Generator().manual_seed(SEED)) + 1
    table = perm.reshape(b, pps).to(device=dev, dtype=torch.int32)
    kpool, vpool = _pools_from(k_tab, table, PAGE_SIZE), _pools_from(v_tab, table, PAGE_SIZE)
    kw = dict(layer=0, sm_scale=sm)
    out = paged_flash_decode(q, kpool, vpool, table, lengths, **kw)
    ref = paged_flash_decode_plain(q, kpool, vpool, table, lengths, **kw)
    _check_ulps(f"{e['paged']} page_size={PAGE_SIZE} pages_per_seq={pps} shuffled", out, ref, 1)
    shape_checks(e["paged"], lambda qq: paged_flash_decode(qq, kpool, vpool, table, lengths, **kw), q, ref, 1)
    n_bytes = dec_bytes + table.numel() * 4
    bnd, by = bound_ms(n_bytes, dec_ops)
    res[e["paged"]] = dict(
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        ms=timer(lambda: paged_flash_decode(q, kpool, vpool, table, lengths, **kw)),
        plain_ms=timer(lambda: paged_flash_decode_plain(q, kpool, vpool, table, lengths, **kw), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    log_rate(e["paged"], res[e["paged"]]["ms"], n_bytes, dec_ops, split_grid(b, 1, s, d))
    del kpool, vpool

    sq = LATENT_CHUNK
    q_off = torch.tensor([0, sq], dtype=torch.int32, device=dev)
    lens = q_off + sq
    qp = torch.randn((2, hq, sq, d), generator=gen, device=dev, dtype=bf16)
    k, v = k_tab[0, :2].contiguous(), v_tab[0, :2].contiguous()
    del k_tab, v_tab
    out = flash_prefill(qp, k, v, lens, q_offsets=q_off, sm_scale=sm)
    ref = flash_prefill_plain(qp, k, v, lens, q_offsets=q_off, sm_scale=sm)
    # two roundings on the kernel's side (P to bf16 for P @ V, the output), one on the twin's
    _check_ulps(f"{e['prefill']} B=2 Sq={sq} Skv={s} q_offsets={q_off.tolist()}", out, ref, 2)
    shape_checks(e["prefill"], lambda qq: flash_prefill(qq, k, v, lens, q_offsets=q_off, sm_scale=sm), qp,
                 ref, 2)
    n_pairs = sum(int(lo) * sq + sq * (sq + 1) // 2 for lo in q_off.tolist())
    bnd, by = bound_ms(2 * qp.numel() * 2 + 2 * int(lens.sum()) * d * 2, 4 * d * hq * n_pairs)
    kk, vv = repeat_kv(k, hq), repeat_kv(v, hq)
    qpos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
    kpos = torch.arange(s, device=dev)
    cmask = ((kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    res[e["prefill"]] = dict(
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        ms=timer(lambda: flash_prefill(qp, k, v, lens, q_offsets=q_off, sm_scale=sm)),
        plain_ms=timer(lambda: flash_prefill_plain(qp, k, v, lens, q_offsets=q_off, sm_scale=sm), iters=3),
        bound_ms=bnd, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(qp, kk, vv, attn_mask=cmask, scale=sm)))
    del qp, k, v, kk, vv, cmask, out, ref
    torch.cuda.empty_cache()
    _latent_group_rows(dev, timer, sm)

    # -- the expert stacks: (L * E, ...) views, expert e of layer lidx at lidx * E + e
    rows = LATENT_BATCH
    for key, (mode, n_exp, lidx, ex, projs) in EXPERT_STACKS.items():
        entry = e[key]
        agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
        n_bytes = n_ops = 0
        n_stack, eidx = (lidx + 1) * n_exp, lidx * n_exp + ex
        fn, plain = ((qmm.quant_matmul_int4, qmm.quant_matmul_int4_plain) if mode == "int4"
                     else (qmm.quant_matmul, qmm.quant_matmul_plain))
        for name, kdim, ndim in projs:
            out_dtype = bf16 if name == "gate_up" else None  # as _moe_mlp writes them
            if mode == "int4":  # random nibble pairs and g128 scales
                w = torch.randint(-128, 128, (n_stack, kdim // 2, ndim), generator=gen, device=dev,
                                  dtype=torch.int8)
                scale = torch.rand((n_stack, kdim // 128, ndim), generator=gen, device=dev) * 0.01 + 0.005
            else:
                w = torch.randint(-127, 128, (n_stack, kdim, ndim), generator=gen, device=dev, dtype=torch.int8)
                scale = torch.rand((n_stack, ndim), generator=gen, device=dev) * 0.01 + 0.005
            deq = dequantize_weight({"w": w[eidx], "scale": scale[eidx]}, bf16)
            x = torch.randn((rows, kdim), generator=gen, device=dev, dtype=bf16)
            out = fn(x, w, scale, layer=eidx, out_dtype=out_dtype)
            ref = plain(x, w, scale, layer=eidx, out_dtype=out_dtype)
            err = (out.float() - ref.float()).abs().max().item()
            # fp32 sums of the same exact products in another order; one bf16 rounding each side (bf16 out)
            _check(f"{entry} {name} index {eidx} of {n_stack} K={kdim} N={ndim} out={out_dtype or torch.float32}",
                   err, (2.0**-7 if out_dtype == bf16 else 1e-4) * ref.float().abs().max().item())
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            _same_bits(f"{entry} {name}", lambda: fn(x, w, scale, layer=eidx, out_dtype=out_dtype))
            if mode == "int4" and name == "down":
                _split_k_grid(f"{entry} {name}", fn, x, w, scale, eidx, out_dtype or torch.float32,
                              w.shape[1] // scale.shape[1], timer)
            agg["ms"] += timer(lambda: fn(x, w, scale, layer=eidx, out_dtype=out_dtype))
            agg["plain_ms"] += timer(lambda: plain(x, w, scale, layer=eidx, out_dtype=out_dtype), iters=5)
            agg["library_ms"] += timer(lambda: torch.matmul(x, deq))
            n_bytes += x.numel() * 2 + w[eidx].numel() + scale[eidx].numel() * 4 + out.numel() * out.element_size()
            n_ops += 2 * rows * kdim * ndim
            del w, scale, deq
        agg["bound_ms"], agg["bound_by"] = bound_ms(n_bytes, n_ops)
        res[entry] = agg
    torch.cuda.empty_cache()
    return res


# K5 at D 640 beside DeepSeek's 16 heads: (G, Hkv, Sq, Skv, q_offsets, lengths), the
# offsets and lengths off the 32-key tiles (the second sequence's length short of its rows)
LATENT_GROUP_ROWS = ((2, 4, 1000, 3000, (37, 1111), (1037, 2001)),
                     (4, 2, 777, 2500, (5, 1500), (782, 2207)),
                     (6, 1, 1500, 2048, (0, 333), (1500, 1700)))


def _latent_group_rows(dev, timer, sm):
    """K5 at D 640 with G 2, 4 and 6 (its tiles then hold 64, 32 and 21
    positions, 6 x 21 leaving 2 rows idle) against its twin, within 2
    roundings (3 ulps) of each element; a ``[time]`` line each."""
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for g, hkv, sq, skv, q_off, lens in LATENT_GROUP_ROWS:
        q = torch.randn((2, g * hkv, sq, 640), generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn((2, hkv, skv, 640), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
        q_off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(q_offsets=q_off_t, sm_scale=sm)
        out = flash_prefill(q, k, v, lens_t, **kw)
        ref = flash_prefill_plain(q, k, v, lens_t, **kw)
        tag = f"flash_prefill D640 G{g} Hkv={hkv} Sq={sq} Skv={skv} q_offsets={list(q_off)} lengths={list(lens)}"
        _check_ulps(tag, out, ref, 2)
        log(f"[time] {tag}: kernel {timer(lambda: flash_prefill(q, k, v, lens_t, **kw)):.4f} ms")
        del q, k, v, out, ref
    torch.cuda.empty_cache()


def _latent_grid(entry, run, out, q, k_tab, v_tab, lengths, sm, timer, ms):
    """K1 at D 640 on its grid beside chunks half and twice as long
    (``[grid]``), and beside one launch of the same kernel in partials mode
    at its grid, which writes the chunks' (o, m, l) and merges nothing
    (``[merge]``: the merge's share of the call). The partials, merged by
    lse_combine_splits, are held to the merged call's output."""
    from starflashattention_tpu_torch.ops import _build
    from starflashattention_tpu_torch.ops import flash_decode as fd

    b, hq, d = q.shape
    s = k_tab.shape[3]
    n, c = split_grid(b, 1, s, d)
    times = {}
    for c2 in (c // 2, 2 * c):
        with forced_chunk(c2):
            times[c2] = timer(run)
    log(f"[grid] {entry}: {n} chunks of {c} rows a sequence, {ms:.4f} ms; half ({-(-s // (c // 2))} of "
        f"{c // 2}): {times[c // 2]:.4f} ms ({times[c // 2] / ms - 1:+.1%}); twice ({-(-s // (2 * c))} of "
        f"{2 * c}): {times[2 * c]:.4f} ms ({times[2 * c] / ms - 1:+.1%})")
    parts = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
                  for shape in ((b, hq, n, d), (b, hq, n), (b, hq, n)))
    ptr = _build.P(k_tab.data_ptr()), _build.P(v_tab.data_ptr())

    def partials():
        fd.launch_split(q, *ptr, lengths, hkv=1, s=s, scale=sm, kv_code=0, parts=parts, split_len=c)

    partials()
    _check_ulps(f"{entry} partials at its grid, merged by lse_combine_splits, against the merged call",
                fd.lse_combine_splits(*parts, dtype=q.dtype), out, 1)
    t = timer(partials)
    log(f"[merge] {entry}: merging call {ms:.4f} ms; partials only at the same grid ({n} chunks of {c} "
        f"rows, no merge) {t:.4f} ms; the merge's share {(ms - t) / ms:.1%}")


def _pools_from(tab, table, ps):
    """(L, B, Hkv, S, D) table -> (L, Hkv, B * S / ps + 1, ps, D) pools with
    page (b, i) at table[b, i] (page 0 is the null page). Moves bytes, so
    1-byte tables go through a uint8 view."""
    n_layers, b, hkv, s, d = tab.shape
    pps = s // ps
    pool = torch.zeros((n_layers, hkv, b * pps + 1, ps, d), dtype=tab.dtype, device=tab.device)
    view = (lambda t: t.view(torch.uint8)) if tab.element_size() == 1 else (lambda t: t)
    view(pool)[:, :, table.reshape(-1).long()] = view(tab).reshape(n_layers, b, hkv, pps, ps, d).transpose(
        1, 2).reshape(n_layers, hkv, b * pps, ps, d)
    return pool


def _quantized_kv_kernels(dev, timer, q, k_tab, v_tab, lengths, layer, k_new, v_new):
    """K1 (fused), K2 (split) and K7 on int8 and fp8 copies of the decode
    tables (quantized against the calibration scales), and K3 / K8 on 1-byte
    rows. The library call is SDPA on the dequantized bf16 rows (the
    dequantization itself not timed)."""
    import torch.nn.functional as F

    from starflashattention_tpu_torch.core.quant import quantize_value
    from starflashattention_tpu_torch.core.reference import repeat_kv
    from starflashattention_tpu_torch.ops.cache_append import (
        append_rows_kv, append_rows_kv_plain, append_rows_paged_kv, append_rows_paged_kv_plain)
    from starflashattention_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_plain

    n_layers, b, hkv, s, d = k_tab.shape
    hq = q.shape[1]
    ps = PAGE_SIZE
    perm = torch.randperm(b * (s // ps), generator=torch.Generator().manual_seed(SEED + 1)) + 1
    table = perm.reshape(b, s // ps).to(device=dev, dtype=torch.int32)
    n_valid = int(lengths.sum())
    sdpa_mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    res = {}
    for mode in ("int8", "fp8"):
        scales = torch.full((hkv,), KV_SCALE[mode], dtype=torch.float32, device=dev)
        kq = quantize_value(k_tab, scales, mode, head_axis=2)
        vq = quantize_value(v_tab, scales, mode, head_axis=2)
        kw = dict(layer=layer, k_scales=scales, v_scales=scales)
        deq = [repeat_kv((t[layer].float() * KV_SCALE[mode]).to(q.dtype), hq // hkv) for t in (kq, vq)]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(q[:, :, None], deq[0], deq[1],
                                                              attn_mask=sdpa_mask))
        # 1-byte K/V rows, the q and output rows, the scales and lengths
        n_bytes = 2 * n_valid * hkv * d + 2 * q.numel() * 2 + 2 * hkv * 4 + b * 4
        bnd, by = bound_ms(n_bytes, 4 * hq * d * n_valid)
        # both sides fold the same scales into the same q and compute in
        # fp32, so they differ by at most an ulp of each element's own value
        # at each bf16 rounding: two on the fused path (the output, then
        # times v_scale), one on the split and paged paths
        for splits, entry in ((1, f"flash_decode {mode} KV (1 split, fused)"),
                              (4, f"flash_decode {mode} KV (split-KV partials)")):
            kws = dict(kw, num_splits=splits, block_k=256)
            out = flash_decode(q, kq, vq, lengths, **kws)
            ref = flash_decode_plain(q, kq, vq, lengths, **kws)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[kernel] {entry}: max_abs_err {err:.3e}")
            _check_ulps(f"{entry} B={b} Hq={hq} Hkv={hkv} S={s} D={d} scale {KV_SCALE[mode]:.5f}", out, ref,
                        2 if splits == 1 else 1)
            run = lambda: flash_decode(q, kq, vq, lengths, **kws)  # noqa: E731
            res[entry] = dict(max_abs_err=err, ms=timer(run),
                              plain_ms=timer(lambda: flash_decode_plain(q, kq, vq, lengths, **kws), iters=5),
                              bound_ms=bnd, bound_by=by, library_ms=lib_ms)
            log_rate(entry, res[entry]["ms"], n_bytes, 4 * hq * d * n_valid,
                     split_grid(b, hkv, s) if splits == 1 else (splits, s // splits))
            if splits == 1:
                coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])
        kp, vp = _pools_from(kq, table, ps), _pools_from(vq, table, ps)
        out = paged_flash_decode(q, kp, vp, table, lengths, **kw)
        ref = paged_flash_decode_plain(q, kp, vp, table, lengths, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        entry = f"paged_flash_decode {mode} KV"
        log(f"[kernel] {entry}: max_abs_err {err:.3e}")
        _check_ulps(f"{entry} page_size={ps} shuffled table", out, ref, 1)
        bnd_p, by_p = bound_ms(n_bytes + table.numel() * 4, 4 * hq * d * n_valid)
        run = lambda: paged_flash_decode(q, kp, vp, table, lengths, **kw)  # noqa: E731
        res[entry] = dict(max_abs_err=err, ms=timer(run),
                          plain_ms=timer(lambda: paged_flash_decode_plain(q, kp, vp, table, lengths, **kw),
                                         iters=5),
                          bound_ms=bnd_p, bound_by=by_p, library_ms=lib_ms)
        log_rate(entry, res[entry]["ms"], n_bytes + table.numel() * 4, 4 * hq * d * n_valid,
                 split_grid(b, hkv, s))
        coarser_grid(entry, run, b, hkv, s, timer, res[entry]["ms"])

        # the appends move 1-byte rows: whole tables and pools equal
        kn = quantize_value(k_new, scales, mode, head_axis=1)
        vn = quantize_value(v_new, scales, mode, head_axis=1)
        pos = torch.clamp(lengths, max=s - 1)
        tabs = [t.clone() for t in (kq, vq, kq, vq)]
        append_rows_kv(tabs[0], tabs[1], kn, vn, layer, pos)
        append_rows_kv_plain(tabs[2], tabs[3], kn, vn, layer, pos)
        same = all(torch.equal(a.view(torch.uint8), b_.view(torch.uint8))
                   for a, b_ in ((tabs[0], tabs[2]), (tabs[1], tabs[3])))
        _check(f"append_rows_kv {mode} rows, whole table", 0.0 if same else float("inf"), 0.0)
        pools = [t.clone() for t in (kp, vp, kp, vp)]
        append_rows_paged_kv(pools[0], pools[1], kn, vn, layer, table, pos)
        append_rows_paged_kv_plain(pools[2], pools[3], kn, vn, layer, table, pos)
        same = all(torch.equal(a.view(torch.uint8), b_.view(torch.uint8))
                   for a, b_ in ((pools[0], pools[2]), (pools[1], pools[3])))
        _check(f"append_rows_paged_kv {mode} rows, whole pools", 0.0 if same else float("inf"), 0.0)
        log(f"[time] append_rows_kv on {mode} rows: {timer(lambda: append_rows_kv(tabs[0], tabs[1], kn, vn, layer, pos)):.4f} ms; "
            f"append_rows_paged_kv on {mode} rows: "
            f"{timer(lambda: append_rows_paged_kv(pools[0], pools[1], kn, vn, layer, table, pos)):.4f} ms")
        del kq, vq, kp, vp, tabs, pools, deq
    return res


def _int_mm_fn(x8, w):
    """``torch._int_mm`` on this card's layout rules (the library yardstick
    of W8A8), or None where it refuses both row- and column-major weights."""
    for wl in (w, w.t().contiguous().t()):
        try:
            torch._int_mm(x8, wl)
        except RuntimeError:
            continue
        return lambda: torch._int_mm(x8, wl)
    return None


def _quantized_matmuls(dev, timer, gen, shapes):
    """K6 (int4 weight-only, small-M at 16 rows and tiled at 2048) on the
    five 7B shapes with g128 scales, and K10 / K11 (W8A8 / W4A8) at 2048
    rows on the four layer shapes, each against its plain twin. Library
    calls: ``torch.matmul`` on bf16 dequantized weights (K6, K11), and
    ``torch._int_mm`` plus the two scale multiplies after the same row
    quantization (K10). The W8A8 / W4A8 entries run their row quantization
    (plain torch) before the kernel, as the main path does; each shape's
    entry time is split into ``quantize_rows`` and the kernel alone
    (``_launch_a8`` on the same rows), and the kernels line carries the
    kernel alone."""
    from starflashattention_tpu_torch.core.quant import dequantize_weight, quantize_weight
    from starflashattention_tpu_torch.ops import quant_matmul as qmm

    bf16 = torch.bfloat16
    res = {}

    def add(entry, err, t, t_plain, t_lib, n_bytes, n_ops):
        agg = res.setdefault(entry, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                         n_bytes=0, n_ops=0))
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += t
        agg["plain_ms"] += t_plain
        if t_lib is None or agg["library_ms"] is None:
            agg["library_ms"] = None
        else:
            agg["library_ms"] += t_lib
        agg["n_bytes"] += n_bytes
        agg["n_ops"] += n_ops

    for name, (kdim, ndim, out_dtype) in shapes.items():
        w4 = quantize_weight(torch.randn((2, kdim, ndim), generator=gen, device=dev), "int4")
        deq = dequantize_weight({"w": w4["w"][1], "scale": w4["scale"][1]}, bf16)
        scale_bytes = w4["scale"][1].numel() * 4
        for rows in (16, 2048):
            x = torch.randn((rows, kdim), generator=gen, device=dev, dtype=bf16)
            out = qmm.quant_matmul_int4(x, w4["w"], w4["scale"], layer=1, out_dtype=out_dtype)
            ref = qmm.quant_matmul_int4_plain(x, w4["w"], w4["scale"], layer=1, out_dtype=out_dtype)
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            # fp32 sums of the same exact products (nibble x bf16) in another
            # order, group by group; plus one bf16 rounding each side (bf16 out)
            rel = 2.0**-7 if out_dtype == bf16 else 1e-4
            _check(f"quant_matmul_int4 g128 {name} rows={rows} K={kdim} N={ndim} out={out_dtype}",
                   err, rel * peak)
            if rows <= 64:
                _same_bits(f"quant_matmul_int4 g128 {name} rows={rows}",
                           lambda: qmm.quant_matmul_int4(x, w4["w"], w4["scale"], layer=1, out_dtype=out_dtype))
            t = timer(lambda: qmm.quant_matmul_int4(x, w4["w"], w4["scale"], layer=1, out_dtype=out_dtype))
            t_plain = timer(lambda: qmm.quant_matmul_int4_plain(x, w4["w"], w4["scale"], layer=1,
                                                                out_dtype=out_dtype), iters=5)
            t_lib = timer(lambda: torch.matmul(x, deq))
            n_bytes = x.numel() * 2 + kdim * ndim // 2 + scale_bytes + rows * ndim * out.element_size()
            n_ops = 2 * rows * kdim * ndim
            log(f"[time] quant_matmul_int4 {name} rows={rows}: kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
                f"torch.matmul(bf16 dequantized) {t_lib:.4f} ms, bound {bound_ms(n_bytes, n_ops)[0]:.4f} ms")
            if rows > 64:
                log_rate(f"quant_matmul_int4 tiled {name} rows={rows} K={kdim} N={ndim}", t, n_bytes, n_ops)
            add(INT4_ENTRY[rows], err, t, t_plain, t_lib, n_bytes, n_ops)
        if name == "lm_head":  # the lm_head stays weight-only under w8a8_prefill
            continue
        w8 = quantize_weight(torch.randn((2, kdim, ndim), generator=gen, device=dev), "int8")
        x = torch.randn((2048, kdim), generator=gen, device=dev, dtype=bf16)
        x8, rs = qmm.quantize_rows(x)
        t_quant = timer(lambda: qmm.quantize_rows(x))
        for entry, w, plain in (("w8a8", w8, qmm.quant_matmul_w8a8_plain),
                                ("w4a8", w4, qmm.quant_matmul_w4a8_plain)):
            fn = getattr(qmm, "quant_matmul_" + entry)
            out = fn(x, w["w"], w["scale"], layer=1, out_dtype=out_dtype)
            ref = plain(x, w["w"], w["scale"], layer=1, out_dtype=out_dtype)
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            if entry == "w8a8":  # exact int32 sums and the same two fp32 multiplies: the same bytes
                _check_equal(f"quant_matmul_w8a8 {name} rows=2048 K={kdim} N={ndim} out={out_dtype}", out, ref)
            else:  # exact int32 sums; the fp32 group sums in another order; one bf16 rounding each side
                rel = 2.0**-7 if out_dtype == bf16 else 1e-5
                _check(f"quant_matmul_{entry} {name} rows=2048 K={kdim} N={ndim} out={out_dtype}", err, rel * peak)
            half = 0 if entry == "w8a8" else w["w"].shape[1] // w["scale"].shape[1]
            alone = lambda: qmm._launch_a8(fn, x8, rs, w["w"], w["scale"], 1, out_dtype, half)  # noqa: E731
            if not torch.equal(alone(), out):
                raise AssertionError(f"quant_matmul_{entry} {name}: the kernel alone differs from the entry")
            t_entry = timer(lambda: fn(x, w["w"], w["scale"], layer=1, out_dtype=out_dtype))
            t = timer(alone)
            t_plain = timer(lambda: plain(x, w["w"], w["scale"], layer=1, out_dtype=out_dtype), iters=5)
            if entry == "w8a8":
                mm = _int_mm_fn(x8, w["w"][1])
                s1 = w["scale"][1]
                t_lib = None if mm is None else timer(
                    lambda: (mm().float() * qmm.quantize_rows(x)[1] * s1).to(out_dtype))
                w_bytes = kdim * ndim + ndim * 4
            else:
                t_lib = timer(lambda: torch.matmul(x, deq))
                w_bytes = kdim * ndim // 2 + scale_bytes
            n_bytes = x.numel() * 2 + w_bytes + 2048 * ndim * out.element_size()
            n_ops = 2 * 2048 * kdim * ndim
            bnd, by = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS_PER_S)
            log(f"[time] quant_matmul_{entry} {name} rows=2048: kernel alone {t:.4f} ms (entry {t_entry:.4f} ms, "
                f"quantize_rows {t_quant:.4f} ms), plain {t_plain:.4f} ms, "
                f"library {'none' if t_lib is None else format(t_lib, '.4f') + ' ms'}, bound {bnd:.4f} ms "
                f"({by}, int8 rate; {bound_ms(n_bytes, n_ops)[0]:.4f} ms at the bf16 rate)")
            log_rate(f"quant_matmul_{entry} {name} rows=2048 K={kdim} N={ndim}, kernel alone", t, n_bytes, n_ops,
                     int8=True)
            add(A8_ENTRY[entry], err, t, t_plain, t_lib, n_bytes, n_ops)
            split = res[A8_ENTRY[entry]]
            split["entry_ms"] = split.get("entry_ms", 0.0) + t_entry
            split["quantize_rows_ms"] = split.get("quantize_rows_ms", 0.0) + t_quant
        del w8, x8, rs
        del w4, deq
    _w8a8_shards(dev)
    for entry, r in res.items():
        int8 = entry in A8_ENTRY.values()
        n_bytes, n_ops = r.pop("n_bytes"), r.pop("n_ops")
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, n_ops, PEAK_INT8_OPS_PER_S if int8 else PEAK_BF16_OPS_PER_S)
        if entry in INT4_ENTRY.values():
            log_rate(f"{entry}, the five shapes", r["ms"], n_bytes, n_ops)
        if int8:
            entry_ms, quant_ms = r.pop("entry_ms"), r.pop("quantize_rows_ms")
            log_rate(f"{entry}, the four shapes, kernel alone", r["ms"], n_bytes, n_ops, int8=True)
            log(f"[split] {entry}, the four shapes: entry {entry_ms:.4f} ms = quantize_rows {quant_ms:.4f} ms "
                f"({quant_ms / entry_ms:.1%}) + kernel alone {r['ms']:.4f} ms (sum of parts "
                f"{quant_ms + r['ms']:.4f} ms)")
    return res


def _check_equal(name, out, ref):
    """``out`` and ``ref`` hold the same bytes (the count of elements that differ must be 0)."""
    bits = torch.int32 if out.dtype == torch.float32 else torch.int16
    _check(name, float((out.view(bits) != ref.view(bits)).sum()), 0.0, what="elements whose bytes differ")


def _w8a8_shards(dev):
    """K10 at a TP-4 rank's W8A8 shapes (phase 14: the column shards of
    wqkv and w_gate_up, N 1536 and 5504, the second 21.5 tiles of 256; the
    row shards of wo and w_down, K 1024 and 2752, the second's last stage
    half), 2048 and 300 rows, fp32 and bf16 out: the plain twin's bytes.
    Its inputs come from a generator of their own."""
    from starflashattention_tpu_torch.core.quant import quantize_weight
    from starflashattention_tpu_torch.ops import quant_matmul as qmm

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    for kdim, ndim in ((4096, 1536), (1024, 4096), (4096, 5504), (2752, 4096)):
        w8 = quantize_weight(torch.randn((2, kdim, ndim), generator=gen, device=dev), "int8")
        for rows in (2048, 300):
            x = torch.randn((rows, kdim), generator=gen, device=dev, dtype=torch.bfloat16)
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(layer=1, out_dtype=out_dtype)
                _check_equal(f"quant_matmul_w8a8 TP-4 shard rows={rows} K={kdim} N={ndim} out={out_dtype}",
                             qmm.quant_matmul_w8a8(x, w8["w"], w8["scale"], **kw),
                             qmm.quant_matmul_w8a8_plain(x, w8["w"], w8["scale"], **kw))


# ---------------------------------------------------------------- phase 3


def _counters():
    from starflashattention_tpu_torch.ops import quant_matmul as qmm
    from starflashattention_tpu_torch.ops.cache_append import (append_block_kv, append_rows_kv,
                                                               append_rows_paged_kv)
    from starflashattention_tpu_torch.ops.flash_bwd import flash_bwd_dkdv, flash_bwd_dq
    from starflashattention_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_append, flash_verify,
                                                               flash_verify_append)
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
    from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp
    from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_append

    # the decode and verify paths fold their row append into the attention's
    # launch: the standalone appends (K3, K8, K9) must read 0 there, the
    # fold's counters steps x layers
    return {"append_rows_kv": append_rows_kv, "flash_decode": flash_decode,
            "flash_decode_append": flash_decode_append,
            "paged_flash_decode_append": paged_flash_decode_append,
            "flash_prefill": flash_prefill, "quant_matmul": qmm.quant_matmul,
            "append_rows_paged_kv": append_rows_paged_kv, "paged_flash_decode": paged_flash_decode,
            "quant_matmul_int4": qmm.quant_matmul_int4, "quant_matmul_w8a8": qmm.quant_matmul_w8a8,
            "quant_matmul_w4a8": qmm.quant_matmul_w4a8, "flash_verify": flash_verify,
            "flash_verify_append": flash_verify_append, "append_block_kv": append_block_kv,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkdv": flash_bwd_dkdv, "fused_mlp": fused_mlp}


# entries that also count a subset of their launches: (entry, attribute, count name)
_SUBSETS = (("flash_decode", "launches_banded", "flash_decode_banded"),
            ("quant_matmul", "launches_tiled", "quant_matmul_tiled"),
            ("quant_matmul_int4", "launches_tiled", "quant_matmul_int4_tiled"),
            ("flash_prefill", "launches_lse", "flash_prefill_lse"),
            ("flash_prefill", "launches_lse_banded", "flash_prefill_lse_banded"),
            ("flash_bwd_dq", "launches_banded", "flash_bwd_dq_banded"),
            ("flash_bwd_dkdv", "launches_banded", "flash_bwd_dkdv_banded"),
            ("flash_prefill", "launches_kv_offset", "flash_prefill_kv_offset"),
            ("flash_bwd_dq", "launches_kv_offset", "flash_bwd_dq_kv_offset"),
            ("flash_bwd_dkdv", "launches_kv_offset", "flash_bwd_dkdv_kv_offset"))


def reset_counts():
    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    for name, attr, _ in _SUBSETS:
        setattr(fns[name], attr, 0)


def read_counts():
    fns = _counters()
    counts = {name: fn.launches for name, fn in fns.items()}
    for name, attr, key in _SUBSETS:
        counts[key] = getattr(fns[name], attr)
    return counts


def zero_counts(**nonzero):
    """Every counter at 0 but those given."""
    return {**{k: 0 for k in read_counts()}, **nonzero}


def _prompts(cfg, dev, gen):
    lengths = torch.linspace(16, 256, SLICE_BATCH).round().to(torch.int32)
    lengths = lengths[torch.randperm(SLICE_BATCH, generator=torch.Generator().manual_seed(SEED))]
    prompts = torch.randint(0, cfg.vocab_size, (SLICE_BATCH, int(lengths.max())), generator=gen,
                            device=dev, dtype=torch.int32)
    return prompts, lengths.to(dev)


def build_model(cfg, dev, mode="int8"):
    """Seeded random weights, quantized (``mode`` "int8" or "int4" with g128
    scales) one layer at a time, and a quantized lm_head."""
    from starflashattention_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, quantize=mode, device=dev)
    return llama.quantize_model_weights(params, mode, lm_head=True, consume=True), gen


def time_prefill_decode(params, cfg, prompts, lengths, dev, steps):
    """A prefill, then ``steps`` greedy decode steps, each timed on the host
    clock after a synchronize; the logits must stay finite."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama

    hkv, d = cfg.kv_cache_dims()
    cache = contiguous.init_cache(cfg.num_layers, prompts.shape[0], hkv, cfg.max_seq_len, d,
                                  quant_mode=cfg.quant_mode, calibration_scale=cfg.kv_calibration_scale,
                                  device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    tok = llama.sample(logits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = llama.decode_step(params, cache, tok, cos, sin, cfg)
        tok = llama.sample(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite decode logits")
    return dict(prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
                decode_tok_s=prompts.shape[0] / step_ms * 1e3,
                prefill_tok_s=int(lengths.sum()) / prefill_ms * 1e3)


def stream_digest(toks):
    """The first 16 hex digits of the sha256 of a token tensor's int32
    bytes: two runs print the same digest only for the same streams."""
    return hashlib.sha256(toks.to(torch.int32).cpu().numpy().tobytes()).hexdigest()[:16]


def run_generate(params, cfg, prompts, lengths, dev, expected, tag):
    """Greedy ``generate`` with the counters zeroed just before and checked
    just after; returns (tokens, counts)."""
    from starflashattention_tpu_torch.models import llama

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = llama.generate(params, cfg, prompts, lengths, SLICE_NEW_TOKENS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"[{tag}] generate {wall * 1e3:.1f} ms; launches {counts}")
    log(f"[{tag}] greedy streams sha256 {stream_digest(toks)}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if toks.shape != (SLICE_BATCH, SLICE_NEW_TOKENS) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"bad token stream {toks.shape}")
    return toks, counts


def slice_counts(n_layers):
    """Phase 3's launches of one greedy ``generate`` (int8 weights and
    lm_head): per prefill one attention and four projections a layer, plus
    the lm_head (8 rows: the small-M kernel); per decode step one attention
    with its append folded in and four projections a layer, plus the
    lm_head."""
    steps = SLICE_NEW_TOKENS - 1
    return zero_counts(flash_prefill=n_layers, flash_decode_append=steps * n_layers,
                       flash_decode=steps * n_layers, quant_matmul=(4 * n_layers + 1) * (steps + 1),
                       quant_matmul_tiled=4 * n_layers)


def phase_slice(dev):
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    base = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ)
    t0 = time.perf_counter()
    params, gen = build_model(base, dev)
    torch.cuda.synchronize()
    log(f"[slice] llama_7b_gqa L={base.num_layers} H={base.hidden_size} Hq={base.num_q_heads} "
        f"Hkv={base.num_kv_heads} D={base.head_dim} I={base.intermediate_size} V={base.vocab_size}, "
        f"int8 weights + int8 lm_head, built in {time.perf_counter() - t0:.1f} s")
    prompts, lengths = _prompts(base, dev, gen)
    log(f"[slice] prompt lengths {lengths.tolist()}, {SLICE_NEW_TOKENS} greedy tokens")
    steps = SLICE_NEW_TOKENS - 1
    expected = slice_counts(base.num_layers)
    runs, streams = {}, {}
    for splits in (1, base.num_splits):
        cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ, num_splits=splits)
        streams[splits], counts = run_generate(params, cfg, prompts, lengths, dev, expected,
                                               f"slice num_splits={splits}")
        runs[splits] = dict(time_prefill_decode(params, cfg, prompts, lengths, dev, steps), counts=counts)
        r = runs[splits]
        log(f"[slice] num_splits={splits}: prefill {r['prefill_ms']:.1f} ms "
            f"({r['prefill_tok_s']:.0f} prompt tok/s), decode {r['decode_ms_per_step']:.3f} ms/step "
            f"({r['decode_tok_s']:.1f} tok/s at B={SLICE_BATCH}), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    agree = (streams[1] == streams[base.num_splits]).float().mean().item()
    log(f"[slice] token agreement between num_splits=1 and {base.num_splits}: {agree:.3f}")
    del params
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 7


def phase_quant_slice(dev):
    """The quantized deployment at full 7B-GQA width (see the module doc)."""
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import PagedEngine

    base = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ, quant_mode="int8")
    n, steps = base.num_layers, SLICE_NEW_TOKENS - 1
    t0 = time.perf_counter()
    params, gen = build_model(base, dev, "int4")
    torch.cuda.synchronize()
    log(f"[quant] llama_7b_gqa L={n} max_seq_len={base.max_seq_len}: int4 g128 weights + int4 lm_head, "
        f"int8 KV (calibration {base.kv_calibration_scale}), built in {time.perf_counter() - t0:.1f} s")
    prompts, lengths = _prompts(base, dev, gen)
    attend = dict(flash_prefill=n, flash_decode_append=steps * n, flash_decode=steps * n)
    # per decode step 4 projections a layer + the lm_head (small-M); per
    # prefill 4 projections a layer at 2048 rows, and the lm_head at 8 rows
    per_run = (4 * n + 1) * steps + 1
    plan = [  # (key, description, config overrides, expected counts)
        ("off", "int4, w8a8_prefill off, int8 KV, 1 split", dict(num_splits=1),
         zero_counts(**attend, quant_matmul_int4=per_run + 4 * n, quant_matmul_int4_tiled=4 * n)),
        ("w4a8", "int4, w8a8_prefill on (W4A8), int8 KV", dict(w8a8_prefill=True),
         zero_counts(**attend, quant_matmul_int4=per_run, quant_matmul_w4a8=4 * n)),
        ("w8a8", "int8, w8a8_prefill on (W8A8), fp8 KV", dict(w8a8_prefill=True, quant_mode="fp8"),
         zero_counts(**attend, quant_matmul=per_run, quant_matmul_w8a8=4 * n)),
    ]
    runs = {}
    for key, tag, overrides, expected in plan:
        if key == "w8a8":  # the int4 model's last use was the paged run below
            del params
            torch.cuda.empty_cache()
            params, _ = build_model(base, dev, "int8")
        cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ,
                                       **{"quant_mode": "int8", **overrides})
        _, counts = run_generate(params, cfg, prompts, lengths, dev, expected, f"quant {tag}")
        r = dict(time_prefill_decode(params, cfg, prompts, lengths, dev, steps), counts=counts)
        runs[key] = r
        log(f"[quant] {tag}: prefill {r['prefill_ms']:.1f} ms ({r['prefill_tok_s']:.0f} prompt tok/s), "
            f"decode {r['decode_ms_per_step']:.3f} ms/step ({r['decode_tok_s']:.1f} tok/s at "
            f"B={SLICE_BATCH}), peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if key == "w4a8":
            runs["paged"] = _quant_paged_serving(params, base, dev, PagedEngine)
    del params
    torch.cuda.empty_cache()
    return runs


def _quant_paged_serving(params, cfg, dev, engine_cls):
    """Phase 6's 24 requests through ``PagedEngine`` on int8 pages with the
    int4 model: every request finishes, K7 and K8 run on the int8 pools."""
    prompts = _serving_prompts(cfg.vocab_size)
    n, steps = cfg.num_layers, SERVE_STEPS

    def expect(st):
        dec = st.decode_rounds * steps * n
        # every prefill call holds 8 slots of >= 16 rows: the tiled kernel
        return zero_counts(flash_prefill=st.prefill_rounds * n, paged_flash_decode=dec,
                           paged_flash_decode_append=dec,
                           quant_matmul_int4=(st.prefill_rounds + st.decode_rounds * steps) * (4 * n + 1),
                           quant_matmul_int4_tiled=st.prefill_rounds * 4 * n)

    def make():
        return engine_cls(params, cfg, num_slots=SERVE_SLOTS, steps_per_round=steps, page_size=PAGE_SIZE,
                          prefill_chunk=SERVE_CHUNK, prefix_cache=True, num_pages=SERVE_PAGES, device=dev)

    eng, _, wall, counts = _serve(make, prompts, expect)
    if eng.cache.k_pages.dtype != torch.int8 or eng.cache.k_scales is None:
        raise AssertionError(f"the paged run did not hold int8 pages ({eng.cache.k_pages.dtype})")
    log(f"[quant] PagedEngine int8 pages, int4 weights: {wall:.2f} s, {json.dumps(eng.stats.summary())}")
    log(f"[quant] PagedEngine launches {counts}")
    return dict(wall_s=wall, stats=eng.stats.summary(), counts=counts)


# ---------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_ops():
    """Route the model's op calls to the plain PyTorch twins (on the card)."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.ops import flash_decode, flash_prefill, quant_matmul

    swaps = [(contiguous, "flash_decode_append", flash_decode.flash_decode_append_plain),
             (llama, "flash_prefill", flash_prefill.flash_prefill_plain)]
    swaps += [(llama, name, getattr(quant_matmul, name + "_plain"))
              for name in ("quant_matmul", "quant_matmul_int4", "quant_matmul_w8a8", "quant_matmul_w4a8")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_path_vs_path(dev):
    """4 layers at full width, prefill + 4 decode steps, through the kernels
    and through the plain twins: int8 weights with a bf16 cache, then the
    quantized deployment (int4 g128 weights + int4 lm_head, int8 KV,
    ``w8a8_prefill`` on: the 2048-row prefill on W4A8)."""
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    attend = ("flash_prefill", "flash_decode", "flash_decode_append")
    for tag, mode, overrides, kernels in (
            ("int8 weights, bf16 KV", "int8", {}, attend + ("quant_matmul",)),
            ("int4 weights, int8 KV, W4A8 prefill", "int4", dict(quant_mode="int8", w8a8_prefill=True),
             attend + ("quant_matmul_int4", "quant_matmul_w4a8"))):
        cfg = ModelConfig.llama_7b_gqa(num_layers=4, max_seq_len=SLICE_SEQ, **overrides)
        _path_vs_path(dev, cfg, mode, tag, kernels)


def _path_vs_path(dev, cfg, mode, tag, kernels, prompt_lengths=None):
    """One configuration through the kernels, then the plain twins; the
    kernel run must launch each of ``kernels``, the plain run none. Phase
    3's 8 prompts, or seeded prompts of ``prompt_lengths``."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama

    params, gen = build_model(cfg, dev, mode)
    if prompt_lengths is None:
        prompts, lengths = _prompts(cfg, dev, gen)
    else:
        lengths = torch.tensor(prompt_lengths, dtype=torch.int32, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (len(prompt_lengths), max(prompt_lengths)),
                                generator=gen, device=dev, dtype=torch.int32)
    cos, sin = llama.rope_tables(cfg, device=dev)

    def run(feed=None):
        """Prefill + 4 decode steps -> (logits, cache, tokens fed). The
        decode feeds this run's own greedy tokens, or ``feed``: random
        weights give near-ties in the logits, and a flipped argmax would
        send the two routes down different streams."""
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, prompts.shape[0], hkv, cfg.max_seq_len, d,
                                      quant_mode=cfg.quant_mode, calibration_scale=cfg.kv_calibration_scale,
                                      device=dev)
        logits, cache = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
        out, fed = [logits], []
        for i in range(4):
            fed.append(llama.sample(logits) if feed is None else feed[i])
            logits, cache = llama.decode_step(params, cache, fed[-1], cos, sin, cfg)
            out.append(logits)
        return torch.stack(out), cache, fed

    reset_counts()
    kern, kcache, fed = run()
    counts = read_counts()
    with plain_ops():
        plain, pcache, _ = run(feed=fed)
    if read_counts() != counts or not all(counts[k] for k in kernels):
        raise AssertionError(f"{tag}: kernel launches {counts}, then {read_counts()} after the plain run; "
                             f"the kernel run must launch each of {kernels}")
    err = (kern - plain).abs().max().item()
    peak = plain.abs().max().item()
    # bf16 activations: where the kernel and the plain version round a sum
    # to bf16 on either side of a tie, the flip propagates through the
    # layers (and, under W4A8, can move a row-quantized activation by one
    # int8 step); a few percent of the logit range bounds that at 4 layers.
    tol = 0.05 * peak
    _check(f"path vs path, {tag} (4 layers, prefill + 4 decode steps) logits (max |logit| {peak:.2f})",
           err, tol)
    same_argmax = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[path] {tag}: argmax agreement {same_argmax:.3f} (both routes decode the kernel route's "
        f"greedy tokens); cache lengths {kcache.lengths.tolist()} "
        f"vs {pcache.lengths.tolist()}; kernel launches {counts}")
    if not torch.equal(kcache.lengths, pcache.lengths):
        raise AssertionError("cache lengths differ")
    if cfg.quant_mode != "none":  # the 1-byte caches written through K3 and its plain twin
        for a, b in ((kcache.k, pcache.k), (kcache.v, pcache.v)):
            if a.dtype != torch.int8:
                raise AssertionError(f"{tag}: the cache is {a.dtype}, not int8")
            diff = (a.int() - b.int()).abs().max().item()
            log(f"[path] {tag}: int8 cache bytes, largest difference {diff}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6


def _serving_prompts(vocab):
    """24 prompts: a shared 256-token system prefix plus a ragged 16-384-token
    suffix, all from a seeded generator."""
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    lens = rng.integers(16, 385, SERVE_REQUESTS)
    return [system + rng.integers(0, vocab, int(n)).tolist() for n in lens]


def _serve(make_engine, prompts, expect, sampling=None, new_tokens=SERVE_NEW_TOKENS, adapters=None):
    """One engine run with the counters zeroed just before and read just
    after; checks the counts against ``expect(stats)`` and that every
    request finished with its full budget. ``adapters``: each request's
    adapter (multi-LoRA engines)."""
    from starflashattention_tpu_torch.serving import GREEDY, Request

    torch.cuda.synchronize()
    reset_counts()
    eng = make_engine()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens, sampling=s, adapter=a)
            for i, (p, s, a) in enumerate(zip(prompts, sampling or [GREEDY] * len(prompts),
                                              adapters or [None] * len(prompts)))]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = expect(eng.stats)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launch counts {got} != expected {want}")
    if eng.stats.finished != len(reqs) or any(len(r.output) != new_tokens for r in reqs):
        raise AssertionError(f"{len(reqs) - eng.stats.finished} requests did not finish")
    for r in reqs:
        if not all(0 <= t < eng.cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of range")
    return eng, reqs, wall, counts


def _serving_counts(n_layers, paged, steps=SERVE_STEPS):
    """Phase 6's launch counts of one engine run, from its stats (int8
    weights and lm_head: four projections a layer and the head a step)."""
    def counts(st):
        dec = st.decode_rounds * steps * n_layers
        return {"flash_prefill": st.prefill_rounds * n_layers,
                "flash_decode": 0 if paged else dec, "flash_decode_append": 0 if paged else dec,
                "paged_flash_decode": dec if paged else 0, "paged_flash_decode_append": dec if paged else 0,
                "append_rows_kv": 0, "append_rows_paged_kv": 0,
                "quant_matmul": (st.prefill_rounds + st.decode_rounds * steps) * (4 * n_layers + 1)}
    return counts


def phase_serving(dev):
    """Full-width 7B-GQA serving through both engines (see the module doc)."""
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine, SamplingParams
    from starflashattention_tpu_torch.utils import native

    cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ)
    t0 = time.perf_counter()
    params, _ = build_model(cfg, dev)
    torch.cuda.synchronize()
    log(f"[serve] llama_7b_gqa L={cfg.num_layers} max_seq_len={cfg.max_seq_len}, int8 weights + int8 "
        f"lm_head, bf16 KV, built in {time.perf_counter() - t0:.1f} s")
    prompts = _serving_prompts(cfg.vocab_size)
    log(f"[serve] {len(prompts)} requests, prompt lengths {min(map(len, prompts))}.."
        f"{max(map(len, prompts))} ({sum(map(len, prompts))} tokens, shared prefix {SERVE_PREFIX}), "
        f"{SERVE_NEW_TOKENS} new tokens each, {SERVE_SLOTS} slots, {SERVE_STEPS} steps a round")
    steps = SERVE_STEPS

    def expect(paged):
        return _serving_counts(cfg.num_layers, paged)

    def contiguous_engine():
        return Engine(params, cfg, num_slots=SERVE_SLOTS, steps_per_round=steps, return_logprobs=True,
                      device=dev)

    def paged_engine(**kw):
        return PagedEngine(params, cfg, num_slots=SERVE_SLOTS, steps_per_round=steps,
                           page_size=PAGE_SIZE, prefill_chunk=SERVE_CHUNK, prefix_cache=True,
                           num_pages=SERVE_PAGES, device=dev, **kw)

    runs = {}
    ceng, creqs, cwall, ccounts = _serve(contiguous_engine, prompts, expect(False))
    log(f"[serve] Engine: {cwall:.2f} s, {json.dumps(ceng.stats.summary())}")
    log(f"[serve] Engine launches {ccounts}")
    runs["contiguous"] = dict(wall_s=cwall, stats=ceng.stats.summary(), counts=ccounts)
    del ceng
    torch.cuda.empty_cache()

    peng, preqs, pwall, pcounts = _serve(lambda: paged_engine(return_logprobs=True), prompts, expect(True))
    pool_kind = "native C++ page pool" if isinstance(peng.pool, native.NativePagePool) else "Python SeqPagePool"
    log(f"[serve] PagedEngine: page_size {PAGE_SIZE}, num_pages {SERVE_PAGES} (page 0 null), "
        f"prefill_chunk {SERVE_CHUNK}, prefix cache on, {pool_kind}")
    log(f"[serve] PagedEngine: {pwall:.2f} s, {json.dumps(peng.stats.summary())}")
    log(f"[serve] PagedEngine launches {pcounts}")
    if peng.stats.preemptions < 1 or peng.stats.prefix_hits < 1:
        raise AssertionError(f"the paged run needs >= 1 preemption and >= 1 prefix hit, got "
                             f"{peng.stats.preemptions} and {peng.stats.prefix_hits}")
    runs["paged"] = dict(wall_s=pwall, stats=peng.stats.summary(), counts=pcounts, pool=pool_kind)
    del peng
    torch.cuda.empty_cache()

    same = sum(c.output == p.output for c, p in zip(creqs, preqs))
    agree_tokens, lp_diff = 0, 0.0
    for c, p in zip(creqs, preqs):
        n = next((i for i, (a, b) in enumerate(zip(c.output, p.output)) if a != b), len(c.output))
        agree_tokens += n
        if n:
            lp_diff = max(lp_diff, max(abs(a - b) for a, b in zip(c.logprobs[:n], p.logprobs[:n])))
    ok = lp_diff <= SERVE_LOGPROB_TOL
    log(f"[serve] streams equal token for token between the engines: {same}/{len(prompts)} "
        f"({same / len(prompts):.3f}); agreeing prefix tokens {agree_tokens}/"
        f"{len(prompts) * SERVE_NEW_TOKENS}; largest chosen-token logprob difference over them "
        f"{lp_diff:.4e} (tolerance {SERVE_LOGPROB_TOL:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"engine logprobs differ by {lp_diff} > {SERVE_LOGPROB_TOL}")
    runs["agreement"] = dict(streams_equal=same, requests=len(prompts), logprob_diff=lp_diff)

    sampled = [SamplingParams(temperature=0.8, top_p=0.95, seed=1000 + i) for i in range(len(prompts))]
    streams = []
    for rep in range(2):
        eng, reqs, wall, _ = _serve(lambda: paged_engine(enable_sampling=True), prompts, expect(True),
                                    sampling=sampled)
        streams.append([r.output for r in reqs])
        log(f"[serve] sampled PagedEngine run {rep + 1} (temperature 0.8, top_p 0.95): {wall:.2f} s, "
            f"preemptions {eng.stats.preemptions}, prefix hits {eng.stats.prefix_hits}")
        del eng
    if streams[0] != streams[1]:
        raise AssertionError("the two sampled runs with the same seeds gave different streams")
    greedy_same = sum(a == p.output for a, p in zip(streams[0], preqs))
    log(f"[serve] the two sampled runs gave identical streams; {greedy_same}/{len(prompts)} equal the greedy ones")
    del params
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 8


def _spec_prompts(vocab):
    """16 structured prompts, as the JAX package's spec benchmark builds its
    serving workload: a shared 24-token motif, an 8-token body, the motif,
    half the body, the motif (84 tokens), from a seeded generator."""
    rng = np.random.default_rng(SEED)
    m, nb, hi = 24, 8, min(2000, vocab - 1)
    motif = rng.integers(100, hi, size=m).tolist()
    out = []
    for _ in range(SPEC_REQUESTS):
        body = rng.integers(100, hi, size=nb).tolist()
        out.append(motif + body + motif + body[: nb // 2] + motif)
    return out


def _teacher_forced(params, cfg, prompts, streams, dev, lora=None, adapters=None):
    """Feed each stream to the plain decode route on the kernels (prefill,
    then one ``decode_step`` a token) -> (largest gap between a row's
    maximum logit and the emitted token's, as a share of the row's logit
    range; the share of emitted tokens that are the row's argmax). With a
    stacked ``lora``, row i runs on ``adapters[i]``."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.models import lora as lora_lib

    ad = {} if lora is None else dict(lora=lora, lora_sel=lora_lib.adapter_onehot(
        [-1 if a is None else a for a in adapters], lora_lib.num_adapters(lora), device=dev))

    b, n_new = len(prompts), len(streams[0])
    hkv, d = cfg.kv_cache_dims()
    cache = contiguous.init_cache(cfg.num_layers, b, hkv, cfg.max_seq_len, d, quant_mode=cfg.quant_mode,
                                  calibration_scale=cfg.kv_calibration_scale, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    toks = torch.tensor(streams, dtype=torch.int32, device=dev)  # (B, n_new)
    plens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    padded = torch.zeros((b, int(plens.max())), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    logits, cache = llama.prefill(params, cache, padded, plens, cos, sin, cfg, **ad)
    gaps, hits = [], []
    for i in range(n_new):
        row_max, row_min = logits.amax(dim=-1), logits.amin(dim=-1)
        chosen = logits.gather(1, toks[:, i : i + 1].long())[:, 0]
        gaps.append((row_max - chosen) / (row_max - row_min))
        hits.append(chosen == row_max)
        if i + 1 < n_new:
            logits, cache = llama.decode_step(params, cache, toks[:, i], cos, sin, cfg, **ad)
    return torch.stack(gaps).max().item(), torch.stack(hits).float().mean().item()


def _verify_trace(params, cfg, prompts, dev):
    """``SPEC_TRACED_STEPS`` prompt-lookup verify steps (``spec_decode_multi``,
    k = ``SPEC_DRAFTS``) of the phase's first ``SPEC_SLOTS`` requests after
    their prefill, under torch.profiler (``_traced_steps``): launches,
    device busy and idle share a verify step."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama

    b = min(SPEC_SLOTS, len(prompts))
    hkv, d = cfg.kv_cache_dims()
    cache = contiguous.init_cache(cfg.num_layers, b, hkv, cfg.max_seq_len, d, quant_mode=cfg.quant_mode,
                                  calibration_scale=cfg.kv_calibration_scale, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    plens = torch.tensor([len(p) for p in prompts[:b]], dtype=torch.int32, device=dev)
    history = torch.zeros((b, cfg.max_seq_len), dtype=torch.int32, device=dev)  # the prompts, as the engine writes them
    for i, p in enumerate(prompts[:b]):
        history[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    logits, cache = llama.prefill(params, cache, history[:, : int(plens.max())].contiguous(), plens, cos, sin, cfg)
    state = dict(tok=torch.argmax(logits, dim=-1).to(torch.int32), history=history)
    active = torch.ones((b,), dtype=torch.bool, device=dev)

    def run(n):
        _, _, state["tok"], _, state["history"] = llama.spec_decode_multi(
            params, cache, state["history"], state["tok"], cos, sin, active, cfg, n, num_draft=SPEC_DRAFTS,
            ngram=SPEC_NGRAM)

    run(1)  # warm-up
    return _traced_steps("spec", f"prompt-lookup verify steps (spec_decode_multi) at B={b}, k={SPEC_DRAFTS}",
                         lambda: run(SPEC_TRACED_STEPS), SPEC_TRACED_STEPS)


def _streams_digest(streams):
    """A short sha256 of a run's token streams (a list of token lists):
    two runs print the same digest only for the same streams."""
    return hashlib.sha256(json.dumps(streams).encode()).hexdigest()[:16]


def phase_spec(dev):
    """Speculative decoding at full 7B-GQA width (see the module doc)."""
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine

    cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ, num_splits=1)
    dcfg = ModelConfig.llama_7b_gqa(num_layers=SPEC_DRAFT_LAYERS, max_seq_len=SLICE_SEQ, num_splits=1)
    t0 = time.perf_counter()
    params, _ = build_model(cfg, dev)
    dgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dparams = llama.quantize_model_weights(llama.init_params(dcfg, dgen, quantize="int8", device=dev),
                                           "int8", lm_head=True, consume=True)
    torch.cuda.synchronize()
    prompts = _spec_prompts(cfg.vocab_size)
    log(f"[spec] llama_7b_gqa L={cfg.num_layers} max_seq_len={cfg.max_seq_len}, int8 weights + int8 "
        f"lm_head, 1 split; draft L={dcfg.num_layers} of the same width (int8, seed {SEED + 1}); built in "
        f"{time.perf_counter() - t0:.1f} s; {len(prompts)} requests of {len(prompts[0])} tokens, "
        f"{SPEC_NEW_TOKENS} new tokens each, {SPEC_SLOTS} slots, {SPEC_STEPS} steps a round, "
        f"k={SPEC_DRAFTS} drafts")
    n, dn, k = cfg.num_layers, dcfg.num_layers, SPEC_DRAFTS
    proj = 4 * n + 1

    def expect(kind):
        def counts(st):
            steps = st.decode_rounds * SPEC_STEPS  # decode or verify steps
            pre = st.prefill_rounds
            if kind == "plain":
                return zero_counts(flash_prefill=pre * n, flash_decode=steps * n, flash_decode_append=steps * n,
                                   quant_matmul=(pre + steps) * proj, quant_matmul_tiled=pre * 4 * n)
            want = zero_counts(flash_prefill=pre * n, flash_verify=steps * n, flash_verify_append=steps * n,
                               quant_matmul=(pre + steps) * proj, quant_matmul_tiled=pre * 4 * n)
            if kind == "draft":  # the draft prefills beside the target and decodes k+1 steps a verify step
                dsteps = steps * (k + 1)
                want.update(flash_prefill=pre * (n + dn), flash_decode=dsteps * dn,
                            flash_decode_append=dsteps * dn,
                            quant_matmul=(pre + steps) * proj + (pre + dsteps) * (4 * dn + 1),
                            quant_matmul_tiled=pre * 4 * (n + dn))
            return want
        return counts

    plan = [("plain", "plain Engine", cfg, {}),
            ("lookup", f"spec_decode={k}, spec_ngram={SPEC_NGRAM}", cfg,
             dict(spec_decode=k, spec_ngram=SPEC_NGRAM)),
            ("draft", f"spec_decode={k}, {dn}-layer draft model", cfg,
             dict(spec_decode=k, draft_model=(dparams, dcfg))),
            ("int8_kv", f"spec_decode={k}, int8 KV cache", dataclasses.replace(cfg, quant_mode="int8"),
             dict(spec_decode=k, spec_ngram=SPEC_NGRAM))]
    runs, streams = {}, {}
    for key, tag, run_cfg, kw in plan:
        def make():
            return Engine(params, run_cfg, num_slots=SPEC_SLOTS, steps_per_round=SPEC_STEPS, device=dev, **kw)

        eng, reqs, wall, counts = _serve(make, prompts, expect("draft" if key == "draft" else
                                                               "plain" if key == "plain" else "spec"),
                                         new_tokens=SPEC_NEW_TOKENS)
        st = eng.stats.summary()
        streams[key] = [r.output for r in reqs]
        runs[key] = dict(wall_s=wall, stats=st, counts=counts,
                         decode_tok_s=eng.stats.decode_tokens_per_s(), spec_steps=eng.stats.spec_steps)
        log(f"[spec] {tag}: {wall:.2f} s, {json.dumps(st)}")
        log(f"[spec] {tag}: launches {counts}")
        log(f"[spec] {tag}: greedy streams sha256 {_streams_digest(streams[key])}")
        if key != "plain":
            if eng.stats.spec_steps <= 0:
                raise AssertionError(f"{tag}: no speculative step")
            steps = eng.stats.decode_rounds * SPEC_STEPS
            log(f"[spec] {tag}: accept-per-step {st['spec_accept_per_step']} ({eng.stats.decode_tokens} "
                f"tokens over {eng.stats.spec_steps} slot verify steps); per verify step "
                f"{counts['flash_verify'] / steps:.0f} flash_verify, {counts['flash_verify_append'] / steps:.0f} "
                f"flash_verify_append, {counts['append_block_kv'] / steps:.0f} append_block_kv launches")
        del eng
        torch.cuda.empty_cache()

    plain_tok_s = runs["plain"]["decode_tok_s"]
    for key, tag, run_cfg, _ in plan[1:]:
        same = sum(a == p for a, p in zip(streams[key], streams["plain"]))
        gap, exact = _teacher_forced(params, run_cfg, prompts, streams[key], dev)
        ok = gap <= SPEC_TIE_TOL
        runs[key].update(streams_equal=same, tie_gap=gap, exact_argmax=exact)
        note = " (the plain run holds a bf16 cache)" if run_cfg.quant_mode != "none" else ""
        log(f"[spec] {tag}: streams equal to the plain run's{note} {same}/{len(prompts)} "
            f"({same / len(prompts):.3f}); "
            f"teacher-forced on the plain decode route: exact-argmax share {exact:.4f}, largest gap below "
            f"the row maximum {gap:.4e} of the row's logit range (tolerance {SPEC_TIE_TOL}) "
            f"{'ok' if ok else 'FAIL'}; decode {runs[key]['decode_tok_s']:.1f} tok/s against plain "
            f"{plain_tok_s:.1f} ({runs[key]['decode_tok_s'] / plain_tok_s:.3f}x)")
        if not ok:
            raise AssertionError(f"{tag}: an emitted token is {gap:.4f} of its row's range below the maximum")
    runs["verify_trace"] = _verify_trace(params, cfg, prompts, dev)
    del params, dparams
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 10


def _variant_prompts(vocab, lo, hi, n=VAR_PROMPTS, seed=SEED):
    """``n`` seeded random prompts with lengths spread over [lo, hi]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).tolist() for k in np.linspace(lo, hi, n).round()]


def _record_pages(eng):
    """After every decode round of a PagedEngine: (reclaimed pages per
    slot, pinned sink pages per slot, the host table)."""
    rounds = []
    decode_round = eng._decode_round

    def recorded():
        decode_round()
        rounds.append((eng._reclaimed.copy(), [list(p) for p in eng._sink_pages],
                       eng._host_table.copy()))

    eng._decode_round = recorded
    return rounds


def _engine_counts(n_layers, steps, banded_layers, kind, lm_head, projections=None, qmm="quant_matmul"):
    """Launch counts of one engine run from its stats: ``kind`` "contiguous",
    "paged" or "spec"; ``banded_layers`` layers a step whose window is
    narrower than the cache; ``lm_head`` 1 for a quantized head, 0 for a
    tied dense one; ``projections`` the ``qmm`` calls a step (default the
    four projections a layer and the head)."""
    projections = 4 * n_layers + lm_head if projections is None else projections

    def counts(st):
        dec = st.decode_rounds * steps  # decode or verify steps
        proj = (st.prefill_rounds + dec) * projections
        want = {"flash_prefill": st.prefill_rounds * n_layers, qmm: proj,
                "flash_decode": 0, "flash_decode_banded": 0, "append_rows_kv": 0, "paged_flash_decode": 0,
                "append_rows_paged_kv": 0, "flash_decode_append": 0, "paged_flash_decode_append": 0,
                "flash_verify": 0, "flash_verify_append": 0, "append_block_kv": 0}
        if kind == "contiguous":
            want.update(flash_decode=dec * n_layers, flash_decode_banded=dec * banded_layers,
                        flash_decode_append=dec * n_layers)
        elif kind == "paged":
            want.update(paged_flash_decode=dec * n_layers, paged_flash_decode_append=dec * n_layers)
        else:
            want.update(flash_verify=dec * n_layers, flash_verify_append=dec * n_layers)
        return want
    return counts


def _greedy_agreement(tag, a_reqs, b_reqs, label="variants"):
    """Share of equal streams, and the largest chosen-token logprob
    difference over the agreeing prefixes (both runs return logprobs)."""
    same = sum(x.output == y.output for x, y in zip(a_reqs, b_reqs))
    diff = 0.0
    for x, y in zip(a_reqs, b_reqs):
        n = next((i for i, (p, q) in enumerate(zip(x.output, y.output)) if p != q), len(x.output))
        if n:
            diff = max(diff, max(abs(p - q) for p, q in zip(x.logprobs[:n], y.logprobs[:n])))
    ok = diff <= SERVE_LOGPROB_TOL
    log(f"[{label}] {tag}: streams equal {same}/{len(a_reqs)}; largest chosen-token logprob difference "
        f"over the agreeing prefixes {diff:.4e} (tolerance {SERVE_LOGPROB_TOL:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: logprobs differ by {diff}")
    return same


def _tie_check(tag, params, cfg, prompts, streams, dev, label="variants", lora=None, adapters=None):
    """Phase 8's teacher-forced check on the plain decode route (with
    ``lora``, each row on its adapter)."""
    gap, exact = _teacher_forced(params, cfg, prompts, streams, dev, lora, adapters)
    ok = gap <= SPEC_TIE_TOL
    log(f"[{label}] {tag}: teacher-forced on the contiguous decode route: exact-argmax share {exact:.4f}, "
        f"largest gap below the row maximum {gap:.4e} of the row's logit range (tolerance "
        f"{SPEC_TIE_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: an emitted token is {gap:.4f} of its row's range below the maximum")
    return gap, exact


def _variant_generate(tag, params, cfg, prompts, dev, banded_layers, lm_head):
    """Greedy ``generate`` with its launch counts checked."""
    n, steps = cfg.num_layers, VAR_NEW_TOKENS - 1
    expected = zero_counts(flash_prefill=n, flash_decode=steps * n, flash_decode_banded=steps * banded_layers,
                           flash_decode_append=steps * n, quant_matmul=(4 * n + lm_head) * (steps + 1),
                           quant_matmul_tiled=4 * n)
    return _checked_generate(tag, params, cfg, prompts, dev, expected, VAR_NEW_TOKENS)


def _checked_generate(tag, params, cfg, prompts, dev, expected, new_tokens, label="variants"):
    """Greedy ``generate`` of ``new_tokens`` on ``prompts`` with the launch
    counters zeroed just before and held to ``expected`` just after."""
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    padded = torch.zeros((len(prompts), int(lengths.max())), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    from starflashattention_tpu_torch.models import llama

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = llama.generate(params, cfg, padded, lengths, new_tokens, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"[{label}] {tag} generate: {wall:.2f} s for {int(lengths.sum())} prompt tokens and "
        f"{new_tokens} tokens x {len(prompts)}; launches {counts}")
    if counts != expected:
        raise AssertionError(f"{tag}: launch counts {counts} != expected {expected}")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: token out of range")
    return dict(wall_s=wall, counts=counts, streams=toks.tolist())


@contextlib.contextmanager
def _k1_on_rounded_q():
    """Inside: the model's contiguous decode attention (K1, its append
    folded in) takes q * sm_scale rounded to q's dtype and an sm_scale of
    1, the paged kernel K7's scale fold (in fp32, then rounded), so both
    routes score the same rounded q."""
    from starflashattention_tpu_torch.cache import contiguous

    k1 = contiguous.flash_decode_append

    def rounded(q, *args, sm_scale=None, **kw):
        scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
        return k1((q.float() * scale).to(q.dtype), *args, sm_scale=1.0, **kw)

    contiguous.flash_decode_append = rounded
    try:
        yield
    finally:
        contiguous.flash_decode_append = k1


def _variant_serve(tag, make, prompts, expect, new_tokens=VAR_NEW_TOKENS, label="variants"):
    eng, reqs, wall, counts = _serve(make, prompts, expect, new_tokens=new_tokens)
    st = eng.stats.summary()
    log(f"[{label}] {tag}: {wall:.2f} s, {json.dumps(st)}")
    log(f"[{label}] {tag}: launches {counts}")
    return eng, reqs, dict(wall_s=wall, stats=st, counts=counts)


def phase_variants(dev):
    """The attention-variant families at full width (see the module doc)."""
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    out, t_phase = {}, time.perf_counter()

    # (a) Gemma-2-9B: generate, Engine, PagedEngine, prompt-lookup spec
    t0 = time.perf_counter()
    cfg = ModelConfig.gemma2_9b()
    params, _ = build_model(cfg, dev)
    torch.cuda.synchronize()
    n = cfg.num_layers
    sliding = sum((i + 1) % cfg.sliding_window_pattern != 0 for i in range(n))
    prompts = _variant_prompts(cfg.vocab_size, 4500, 6000)
    log(f"[variants] gemma2_9b L={n} H={cfg.hidden_size} Hq={cfg.num_q_heads} Hkv={cfg.num_kv_heads} "
        f"D={cfg.head_dim} V={cfg.vocab_size} max_seq_len={cfg.max_seq_len}, softcaps "
        f"{cfg.attn_softcap} / {cfg.final_softcap}, window {cfg.sliding_window} on {sliding} of {n} layers, "
        f"int8 weights, tied bf16 head, bf16 KV; built in {time.perf_counter() - t0:.1f} s; prompts "
        f"{[len(p) for p in prompts]}")
    g2 = {"generate": _variant_generate("gemma2 (a)", params, cfg, prompts, dev, sliding, 0)}
    common = dict(num_slots=VAR_SLOTS, steps_per_round=VAR_STEPS, device=dev)
    eng, creqs, g2["engine"] = _variant_serve(
        "gemma2 (a) Engine", lambda: Engine(params, cfg, return_logprobs=True, **common), prompts,
        _engine_counts(n, VAR_STEPS, sliding, "contiguous", 0))
    del eng
    eng, preqs, g2["paged"] = _variant_serve(
        "gemma2 (a) PagedEngine", lambda: PagedEngine(params, cfg, return_logprobs=True, page_size=PAGE_SIZE,
                                                      prefill_chunk=VAR_CHUNK, **common),
        prompts, _engine_counts(n, VAR_STEPS, sliding, "paged", 0))
    if eng._reclaimed.any() or any(eng._sink_pages):
        raise AssertionError("gemma2 (a): alternating full layers must reclaim no page")
    del eng
    g2["paged"]["streams_equal"] = _greedy_agreement("gemma2 (a) Engine vs PagedEngine", creqs, preqs)
    eng, sreqs, g2["spec"] = _variant_serve(
        "gemma2 (a) spec", lambda: Engine(params, cfg, spec_decode=SPEC_DRAFTS, spec_ngram=SPEC_NGRAM,
                                          **common),
        prompts, _engine_counts(n, VAR_STEPS, sliding, "spec", 0))
    if eng.stats.spec_steps <= 0:
        raise AssertionError("gemma2 (a) spec: no speculative step")
    del eng
    streams = [r.output for r in sreqs]
    g2["spec"]["streams_equal"] = sum(a == c.output for a, c in zip(streams, creqs))
    g2["spec"]["tie_gap"], _ = _tie_check("gemma2 (a) spec", params, cfg, prompts, streams, dev)
    gen_equal = sum(a == c.output for a, c in zip(g2["generate"]["streams"], creqs))
    log(f"[variants] gemma2 (a): generate's streams equal Engine's {gen_equal}/{len(prompts)}; spec's "
        f"{g2['spec']['streams_equal']}/{len(prompts)}; TTFT p50 {g2['engine']['stats']['p50_ttft_ms']} ms "
        f"(Engine), decode {g2['engine']['stats']['decode_tokens_per_s']} tok/s (Engine), "
        f"{g2['paged']['stats']['decode_tokens_per_s']} (PagedEngine), {g2['spec']['stats']['decode_tokens_per_s']} (spec); "
        f"{time.perf_counter() - t0:.1f} s")
    out["gemma2"] = g2
    del params
    torch.cuda.empty_cache()

    # (b) Mistral-7B with 4 attention sinks: Engine, then PagedEngine's rolling buffer
    t0 = time.perf_counter()
    cfg = ModelConfig.mistral_7b(attention_sinks=VARIANT_SINKS, num_splits=1)
    params, _ = build_model(cfg, dev)
    torch.cuda.synchronize()
    n = cfg.num_layers
    prompts = _variant_prompts(cfg.vocab_size, 5200, 5800, seed=SEED + 1)
    log(f"[variants] mistral_7b L={n} window {cfg.sliding_window}, {cfg.attention_sinks} sinks, int8 weights "
        f"+ int8 lm_head, bf16 KV; built in {time.perf_counter() - t0:.1f} s; prompts {[len(p) for p in prompts]}")
    mi = {}
    eng, creqs, mi["engine"] = _variant_serve(
        "mistral (b) Engine", lambda: Engine(params, cfg, return_logprobs=True, **common), prompts,
        _engine_counts(n, VAR_STEPS, n, "contiguous", 1))
    del eng
    rounds = []

    def paged():
        e = PagedEngine(params, cfg, return_logprobs=True, page_size=PAGE_SIZE, prefill_chunk=VAR_CHUNK,
                        debug_validate=True, **common)
        rounds.append(_record_pages(e))
        return e

    eng, preqs, mi["paged"] = _variant_serve("mistral (b) PagedEngine", paged, prompts,
                                             _engine_counts(n, VAR_STEPS, n, "paged", 1))
    sink_lp = -(-cfg.attention_sinks // (eng._walk_block_pages * PAGE_SIZE)) * eng._walk_block_pages
    reclaimed = max(int(r.max()) for r, _, _ in rounds[0])
    pinned_ok = all(len(sp[i]) == sink_lp and list(table[i, :sink_lp]) == sp[i]
                    and not table[i, sink_lp:sink_lp + int(r[i])].any()
                    for r, sp, table in rounds[0] for i in range(VAR_SLOTS) if r[i])
    log(f"[variants] mistral (b) PagedEngine: walk block {eng._walk_block_pages} pages of {PAGE_SIZE}; "
        f"largest reclaimed count a slot {reclaimed} pages; sink pages pinned ({sink_lp} a slot, at the "
        f"table's head, reclaimed entries null behind them) {pinned_ok}")
    if reclaimed <= 0 or not pinned_ok:
        raise AssertionError("mistral (b): no page was reclaimed, or the sink pages were not pinned")
    mi["paged"].update(reclaimed_max=reclaimed, sink_pages=sink_lp)
    del eng
    mi["paged"]["streams_equal"] = _greedy_agreement("mistral (b) Engine vs PagedEngine", creqs, preqs)
    mi["paged"]["tie_gap"], _ = _tie_check("mistral (b) PagedEngine", params, cfg, prompts,
                                           [r.output for r in preqs], dev)
    # why the engines can differ: K7 rounds q * sm_scale to bf16 (as JAX's
    # paged kernel does), K1 scales its fp32 scores. Fed K7's rounded q, K1
    # must give PagedEngine's streams exactly.
    with _k1_on_rounded_q():
        eng, rreqs, mi["engine_rounded_q"] = _variant_serve(
            "mistral (b) Engine, K1 on K7's rounded q", lambda: Engine(params, cfg, return_logprobs=True, **common),
            prompts, _engine_counts(n, VAR_STEPS, n, "contiguous", 1))
    del eng
    same = _greedy_agreement("mistral (b) Engine on K7's rounded q vs PagedEngine", rreqs, preqs)
    if same != len(prompts):
        raise AssertionError(f"mistral (b): on K7's rounded q the Engine's streams equal PagedEngine's "
                             f"{same}/{len(prompts)}, not all")
    out["mistral"] = mi
    log(f"[variants] mistral (b): TTFT p50 {mi['engine']['stats']['p50_ttft_ms']} ms, decode "
        f"{mi['engine']['stats']['decode_tokens_per_s']} tok/s (Engine), {mi['paged']['stats']['decode_tokens_per_s']} "
        f"(PagedEngine); {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # (c) Gemma-7B generate at its 4 splits (K2 at D 256)
    t0 = time.perf_counter()
    cfg = ModelConfig.gemma_7b()
    params, _ = build_model(cfg, dev)
    prompts = _variant_prompts(cfg.vocab_size, 1000, 1500, seed=SEED + 2)
    log(f"[variants] gemma_7b L={cfg.num_layers} Hq=Hkv={cfg.num_q_heads} D={cfg.head_dim}, "
        f"num_splits {cfg.num_splits}, int8 weights, tied bf16 head; prompts {[len(p) for p in prompts]}")
    out["gemma"] = {"generate": _variant_generate("gemma (c)", params, cfg, prompts, dev, 0, 0)}
    log(f"[variants] gemma (c): {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # (d) 4 Gemma-2 layers: kernels against the plain twins, past the window
    t0 = time.perf_counter()
    _path_vs_path(dev, ModelConfig.gemma2_9b(num_layers=4), "int8", "gemma2 4 layers, int8 weights, bf16 KV",
                  ("flash_prefill", "flash_decode", "flash_decode_append", "quant_matmul"),
                  prompt_lengths=[4500, 4700])
    log(f"[variants] gemma2 (d): {time.perf_counter() - t0:.1f} s; phase 10 {time.perf_counter() - t_phase:.1f} s")
    return out

# ---------------------------------------------------------------- phase 9


def _train_counts_ok(counts, n_layers):
    """One training step's counts: the attention forward with the LSE 2 L
    times (remat reruns it in the backward), each K12 kernel L times,
    nothing else."""
    want = zero_counts(flash_prefill=2 * n_layers, flash_prefill_lse=2 * n_layers,
                       flash_bwd_dq=n_layers, flash_bwd_dkdv=n_layers)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")


def _kernel_times(prof):
    """Device time by kernel from a torch.profiler run: [(name, ms, launches)],
    the most time first."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            rows.append((evt.key, (evt.self_cuda_time_total if us is None else us) / 1e3, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def _device_split(rows):
    """Device ms by kind of kernel."""
    split = {"attention forward": 0.0, "attention backward": 0.0, "matmuls": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        name = name.lower()
        kind = ("attention forward" if "flash_prefill_kernel" in name else
                "attention backward" if "flash_bwd" in name else
                "matmuls" if any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas")) else
                "other")
        split[kind] += ms
    return split


def phase_training(dev):
    """Training at full 7B-GQA width (see the module doc)."""
    from torch.profiler import ProfilerActivity, profile

    from starflashattention_tpu_torch.models import llama, lora, train
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    out = {}
    cfg = ModelConfig.llama_7b_gqa(max_seq_len=TRAIN_SEQ)
    n = cfg.num_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in train.tree_leaves(params))
    log(f"[train] llama_7b_gqa L={n} bf16, {n_params / 1e9:.3f} B parameters, seeded random init, "
        f"batch ({TRAIN_BATCH}, {TRAIN_SEQ + 1}); built in {time.perf_counter() - t0:.1f} s")

    # -- 9c: LoRA on the fresh base, rank 16 on all four targets, fp32
    # adapters on the frozen bf16 base
    base_copy = train.tree_map(torch.clone, params)
    adapters = lora.init_lora(cfg, gen, rank=LORA_RANK, device=dev)
    lora_losses, lora_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss, grads = lora.loss_and_grads(params, adapters, batch, cfg, cos, sin)
        with torch.no_grad():  # the factors; alpha / r stays fixed
            for a, g in zip(train.tree_leaves(adapters["layers"]), train.tree_leaves(grads["layers"])):
                a.add_(g, alpha=-LORA_LR)
        lora_losses.append(float(loss))  # synchronizes
        lora_ms.append((time.perf_counter() - t0) * 1e3)
        _train_counts_ok(read_counts(), n)
    same = all(torch.equal(a, b) for a, b in zip(train.tree_leaves(params), train.tree_leaves(base_copy)))
    log(f"[train] LoRA rank {LORA_RANK} (wqkv, wo, w_gate_up, w_down), plain SGD lr {LORA_LR}: losses "
        f"{lora_losses}; ms per step {[round(t, 1) for t in lora_ms]} (the first is the process's first "
        f"training step); base bytes unchanged: {same}")
    if not same:
        raise AssertionError("LoRA training changed the base weights")
    if not all(np.isfinite(lora_losses)) or not lora_losses[-1] < lora_losses[0]:
        raise AssertionError(f"LoRA: the loss did not fall: {lora_losses}")
    del base_copy, grads
    torch.cuda.empty_cache()
    merged = lora.merge(params, adapters, cfg)
    prompts, lengths = _prompts(cfg, dev, gen)
    rows = torch.arange(len(lengths), device=dev), lengths.long() - 1
    with torch.no_grad():
        want = train.forward_train(params, prompts, cfg, cos, sin, remat=False, lora=adapters)[rows]
        folded = train.forward_train(merged, prompts, cfg, cos, sin, remat=False)[rows]
        hkv, d = cfg.kv_cache_dims()
        from starflashattention_tpu_torch.cache import contiguous

        cache = contiguous.init_cache(n, len(lengths), hkv, cfg.max_seq_len, d, device=dev)
        got, _ = llama.prefill(merged, cache, prompts, lengths, cos, sin, cfg)
        del cache
    err, peak_logit = (got - want).abs().max().item(), want.abs().max().item()
    log(f"[train] merged against adapted: the merge's bf16 rounding alone (forward_train on both) "
        f"{(folded - want).abs().max().item():.3e}; the serving prefill (fp32 projections) against "
        f"forward_train (bf16 projections) on the merged model {(got - folded).abs().max().item():.3e}")
    _check(f"merged model's prefill logits against the adapted forward_train (max |logit| {peak_logit:.2f})",
           err, 0.05 * peak_logit)
    steps = LORA_NEW_TOKENS - 1
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = llama.generate(merged, cfg, prompts, lengths, LORA_NEW_TOKENS, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    want_counts = zero_counts(flash_prefill=n, flash_decode=steps * n, flash_decode_append=steps * n)
    if read_counts() != want_counts:
        raise AssertionError(f"merged generate: launch counts {read_counts()} != expected {want_counts}")
    if toks.shape != (len(lengths), LORA_NEW_TOKENS) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"merged generate: bad token stream {toks.shape}")
    log(f"[train] merged model: generate {len(lengths)} prompts x {LORA_NEW_TOKENS} tokens in {gen_s:.2f} s "
        f"through the kernels (K5, K1, K3; dense bf16 projections)")
    out["lora"] = dict(losses=lora_losses, ms=lora_ms, logit_err=err, logit_peak=peak_logit)
    del merged, adapters
    torch.cuda.empty_cache()

    # -- 9a: full fine-tuning of the same base, 32 layers, B=2, S=2048
    momentum = train.tree_map(torch.zeros_like, params)
    log(f"[train] full fine-tuning: SGD momentum {train.MOMENTUM}, lr {TRAIN_LR}, remat")
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = [], [], {}
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, TRAIN_LR)
        losses.append(float(loss))  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _train_counts_ok(read_counts(), n)
        counts = {k: counts.get(k, 0) + v for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] full fine-tuning: losses {losses}; ms per step {[round(t, 1) for t in step_ms]} "
        f"(the first includes allocation); {tokens / step_ms[-1] * 1e3:.0f} tokens/s at the last step; "
        f"peak memory {peak:.1f} GiB; launches in the {TRAIN_STEPS} steps {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"full fine-tuning: the loss did not fall: {losses}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, TRAIN_LR)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_times(prof)
    split = _device_split(kernels)
    busy = sum(split.values())
    if busy == 0:
        log("[train] the profiler saw no device time; the device split is not measured")
    else:
        log(f"[train] one step under torch.profiler: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms, "
            f"idle share {1 - busy / wall_ms:.3f}; device ms: "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
        for name, ms, count in kernels[:12]:
            log(f"[train]   {ms:8.2f} ms  {count:5d} launches  {name[:110]}")
    out["full"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms[-1] * 1e3,
                       peak_gib=peak, counts=counts, profile=split, profile_wall_ms=wall_ms)
    del params, momentum
    torch.cuda.empty_cache()

    # -- 9b: gradients through the kernels against plain attention, 2 layers, B=1
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = llama.init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    reset_counts()
    l_k, g_k = train.loss_and_grads(params, batch[:1], cfg2, cos, sin, use_flash=True)
    _train_counts_ok(read_counts(), cfg2.num_layers)
    l_p, g_p = train.loss_and_grads(params, batch[:1], cfg2, cos, sin, use_flash=False)
    worst = ("", 0.0)
    for (name, a), b in zip(_named_leaves(g_k), train.tree_leaves(g_p)):
        rel = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"[train] 2 layers, B=1, S={TRAIN_SEQ}: loss through the kernels {float(l_k):.6f}, plain attention "
        f"{float(l_p):.6f}")
    _check(f"gradients through the kernels against plain attention, worst leaf {worst[0]} "
           "(max abs error over its peak)", worst[1], TRAIN_GRAD_TOL)
    out["grads"] = dict(worst_leaf=worst[0], worst_rel=worst[1])
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return out


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in _named_leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------- phase 11


def _train_variant_counts(n_layers, banded_layers):
    """One training step's counts on a variant model: K5 with the LSE 2 L
    times (remat reruns it), each K12 kernel L times, the sliding layers'
    launches apart, nothing else."""
    return zero_counts(flash_prefill=2 * n_layers, flash_prefill_lse=2 * n_layers,
                       flash_prefill_lse_banded=2 * banded_layers, flash_bwd_dq=n_layers,
                       flash_bwd_dq_banded=banded_layers, flash_bwd_dkdv=n_layers,
                       flash_bwd_dkdv_banded=banded_layers)


def _sliding_layers(cfg):
    from starflashattention_tpu_torch.models import train

    return sum(train._train_window(cfg, i) is not None for i in range(cfg.num_layers))


def _checksums(tree):
    """Per leaf and layer slice, the sum and the sum of squares of the raw
    16-bit words: any update of a weight moves them."""
    from starflashattention_tpu_torch.models import train

    sums = []
    for leaf in train.tree_leaves(tree):
        for part in (leaf if leaf.dim() > 2 else [leaf]):
            words = part.view(torch.int16).to(torch.int64)
            sums.append((int(words.sum()), int((words * words).sum())))
    return sums


def _traced_step(tag, step):
    """One step under torch.profiler: wall ms, device ms by kind and the
    idle share (the profiler may see no device time: then not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_times(prof)
    split = _device_split(kernels)
    busy = sum(split.values())
    if busy == 0:
        log(f"[train-variants] {tag}: the profiler saw no device time; the device split is not measured")
        return dict(wall_ms=wall_ms)
    log(f"[train-variants] {tag}: one step under torch.profiler: {wall_ms:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; device ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    for name, ms, count in kernels[:10]:
        log(f"[train-variants]   {ms:8.2f} ms  {count:5d} launches  {name[:110]}")
    return dict(wall_ms=wall_ms, profile=split, idle_share=1 - busy / wall_ms)


def phase_train_variants(dev):
    """Training on the attention variants at full width (see the module doc)."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama, lora, train
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    out = {}
    torch.cuda.empty_cache()

    # -- 11a: Mistral-7B as published, full fine-tuning, one (1, 8193) batch
    t_sub = time.perf_counter()
    cfg = ModelConfig.mistral_7b()
    n, s = cfg.num_layers, TRAIN_VARIANT_SEQ["mistral"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    momentum = train.tree_map(torch.zeros_like, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = _train_variant_counts(n, _sliding_layers(cfg))
    losses, step_ms, total = [], [], {}
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, TRAIN_LR)
        losses.append(float(loss))  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"Mistral-7B training: launch counts {counts} != expected {want}")
        total = {k: total.get(k, 0) + c for k, c in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train-variants] Mistral-7B (L={n}, window {cfg.sliding_window}) full fine-tuning at B=1, S={s}: "
        f"losses {losses}; ms per step {[round(t, 1) for t in step_ms]}; {s / step_ms[-1] * 1e3:.0f} "
        f"tokens/s at the last step; peak memory {peak:.1f} GiB; launches a step {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mistral-7B training: the loss did not fall: {losses}")
    traced = _traced_step("Mistral-7B", lambda: train.train_step(params, momentum, batch, cfg, cos, sin,
                                                                  TRAIN_LR))
    out["mistral"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=s / step_ms[-1] * 1e3, peak_gib=peak,
                          counts=total, seconds=time.perf_counter() - t_sub, **traced)
    log(f"[train-variants] 11a took {out['mistral']['seconds']:.1f} s")
    del params, momentum, batch
    torch.cuda.empty_cache()

    # -- 11b: Gemma-2-9B, LoRA rank 16 on the four targets, B=1, S=6144
    t_sub = time.perf_counter()
    cfg = ModelConfig.gemma2_9b()
    n, s = cfg.num_layers, TRAIN_VARIANT_SEQ["gemma2"]
    sliding = _sliding_layers(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    adapters = lora.init_lora(cfg, gen, rank=LORA_RANK, device=dev)
    before = _checksums(params)
    want = _train_variant_counts(n, sliding)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, total = [], [], {}
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss, grads = lora.loss_and_grads(params, adapters, batch, cfg, cos, sin)
        with torch.no_grad():
            for a, g in zip(train.tree_leaves(adapters["layers"]), train.tree_leaves(grads["layers"])):
                a.add_(g, alpha=-LORA_LR)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"Gemma-2-9B LoRA: launch counts {counts} != expected {want}")
        total = {k: total.get(k, 0) + c for k, c in counts.items()}
        del grads
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = _checksums(params) == before
    log(f"[train-variants] Gemma-2-9B (L={n}: {sliding} sliding layers at window {cfg.sliding_window}, "
        f"{n - sliding} full) LoRA rank {LORA_RANK}, plain SGD lr {LORA_LR}, B=1, S={s}: losses {losses}; ms "
        f"per step {[round(t, 1) for t in step_ms]}; {s / step_ms[-1] * 1e3:.0f} tokens/s at the last step; "
        f"peak memory {peak:.1f} GiB; base weights unchanged {same}; launches a step {counts}")
    if not same:
        raise AssertionError("Gemma-2-9B LoRA training changed the base weights")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Gemma-2-9B LoRA: the loss did not fall: {losses}")
    out["gemma2"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=s / step_ms[-1] * 1e3, peak_gib=peak,
                         counts=total)
    prompts = _variant_prompts(cfg.vocab_size, *TRAIN_MERGE_PROMPTS, n=2)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    tokens = torch.zeros((2, int(lengths.max())), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    rows = torch.arange(2, device=dev), lengths.long() - 1

    def last_logits(p, **kw):
        with torch.no_grad():
            return train.forward_train(p, tokens, cfg, cos, sin, remat=False, **kw)[rows]

    def served(p):  # the serving prefill: fp32 projections, a contiguous cache
        with torch.no_grad():
            hkv, d = cfg.kv_cache_dims()
            cache = contiguous.init_cache(n, 2, hkv, cfg.max_seq_len, d, device=dev)
            return llama.prefill(p, cache, tokens, lengths, cos, sin, cfg)[0]

    def first_layers(p, k):  # the model cut to its first k layers (views of the stacks)
        return dict(p, layers={name: w[:k] for name, w in p["layers"].items()})

    adapted, base_train, base_served = last_logits(params, lora=adapters), last_logits(params), served(params)
    short = dataclasses.replace(cfg, num_layers=MERGE_CHECK_LAYERS)
    short_adapters = dict(adapters, layers={name: {"a": ab["a"][:MERGE_CHECK_LAYERS],
                                                   "b": ab["b"][:MERGE_CHECK_LAYERS]}
                                            for name, ab in adapters["layers"].items()})
    with torch.no_grad():
        want = train.forward_train(first_layers(params, MERGE_CHECK_LAYERS), tokens, short, cos, sin,
                                   remat=False, lora=short_adapters)[rows]
    merged = lora.merge(params, adapters, cfg)
    del params
    torch.cuda.empty_cache()
    merged_train, merged_served = last_logits(merged), served(merged)
    with torch.no_grad():
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(MERGE_CHECK_LAYERS, 2, hkv, cfg.max_seq_len, d, device=dev)
        got = llama.prefill(first_layers(merged, MERGE_CHECK_LAYERS), cache, tokens, lengths, cos, sin, short)[0]
        del cache
    peak_logit = want.abs().max().item()
    err = (got - want).abs().max().item()
    route = {"base": (base_served - base_train).abs().max().item(),
             "merged": (merged_served - merged_train).abs().max().item(),
             "served_vs_adapted": (merged_served - adapted).abs().max().item(),
             "adapters": (adapted - base_train).abs().max().item()}
    route["merge_rounding"] = (merged_train - adapted).abs().max().item()
    log(f"[train-variants] Gemma-2-9B merged, all {n} layers, last positions of prompts of {lengths.tolist()} "
        f"tokens (max |logit| {adapted.abs().max().item():.2f}): the serving prefill (fp32 projections) "
        f"against forward_train (bf16 projections) on the base {route['base']:.3e} and on the merged model "
        f"{route['merged']:.3e}; forward_train on the merged model against the adapted one (the merge's bf16 "
        f"rounding) {route['merge_rounding']:.3e}; the served merged model against the adapted forward_train "
        f"{route['served_vs_adapted']:.3e}; the adapters' own effect {route['adapters']:.3e}")
    _check(f"Gemma-2-9B merged model cut to its first {MERGE_CHECK_LAYERS} layers: prefill logits against the "
           f"adapted forward_train's (max |logit| {peak_logit:.2f})", err, 0.05 * peak_logit)
    out["gemma2"].update(logit_err=err, logit_peak=peak_logit, route=route)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = llama.generate(merged, cfg, tokens, lengths, 8, device=dev)
    torch.cuda.synchronize()
    steps = 8 - 1
    want = zero_counts(flash_prefill=n, flash_decode=steps * n, flash_decode_banded=steps * sliding,
                       flash_decode_append=steps * n)
    if read_counts() != want:
        raise AssertionError(f"Gemma-2-9B merged generate: launch counts {read_counts()} != expected {want}")
    if toks.shape != (2, 8) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"Gemma-2-9B merged generate: bad token stream {toks.shape}")
    log(f"[train-variants] Gemma-2-9B merged: generate 2 prompts ({lengths.tolist()} tokens) x 8 tokens in "
        f"{time.perf_counter() - t0:.2f} s through the kernels: {toks.tolist()}")
    out["gemma2"]["seconds"] = time.perf_counter() - t_sub
    log(f"[train-variants] 11b took {out['gemma2']['seconds']:.1f} s")
    del merged, adapters, batch
    torch.cuda.empty_cache()

    # -- 11c: every parameter's gradient through the kernels against plain
    # attention's, 2 layers at full width, B=1, S=4608
    t_sub = time.perf_counter()
    s = TRAIN_VARIANT_SEQ["gemma"]
    out["grads"] = {}
    for tag, cfg in (("Mistral-7B + 4 sinks", ModelConfig.mistral_7b(num_layers=2, attention_sinks=VARIANT_SINKS)),
                     ("Gemma-2-9B", ModelConfig.gemma2_9b(num_layers=2)),
                     ("Gemma-7B", ModelConfig.gemma_7b(num_layers=2))):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = llama.init_params(cfg, gen, device=dev)
        batch = torch.randint(0, cfg.vocab_size, (1, s + 1), generator=gen, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        reset_counts()
        l_k, g_k = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=True)
        want = _train_variant_counts(2, _sliding_layers(cfg))
        if read_counts() != want:
            raise AssertionError(f"{tag}: launch counts {read_counts()} != expected {want}")
        l_p, g_p = train.loss_and_grads(params, batch, cfg, cos, sin, use_flash=False)
        worst = ("", 0.0)
        for (name, a), b in zip(_named_leaves(g_k), train.tree_leaves(g_p)):
            r = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
            worst = max(worst, (name, r), key=lambda x: x[1])
        log(f"[train-variants] {tag}, 2 layers, B=1, S={s}: loss through the kernels {float(l_k):.6f}, "
            f"plain attention {float(l_p):.6f}")
        _check(f"{tag}: gradients through the kernels against plain attention, worst leaf {worst[0]} (max abs "
               "error over its peak)", worst[1], TRAIN_GRAD_TOL)
        out["grads"][tag] = dict(worst_leaf=worst[0], worst_rel=worst[1], counts=want)
        del params, g_k, g_p, batch
        torch.cuda.empty_cache()
    out["grads_seconds"] = time.perf_counter() - t_sub
    log(f"[train-variants] 11c took {out['grads_seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 5


def _moe_step_projections(cfg, lm_head):
    """Weight-only kernel calls a prefill or decode step of a quantized MoE
    model makes: ``wo`` (MLA) or ``wqkv`` and ``wo`` a layer, gate_up and
    down for every expert of every MoE layer, and ``lm_head`` (1 when the
    head is quantized)."""
    attn = 1 if cfg.mla else 2
    return attn * cfg.num_layers + 2 * cfg.num_experts * (cfg.num_layers - cfg.first_k_dense) + lm_head


def _moe_generate_counts(cfg, qmm_name, lm_head, new_tokens):
    n, steps, p = cfg.num_layers, new_tokens - 1, _moe_step_projections(cfg, lm_head)
    # the prefill's rows take the tiled kernel, but for the lm_head's (one a prompt)
    return zero_counts(flash_prefill=n, flash_decode=steps * n, flash_decode_append=steps * n,
                       **{qmm_name: (steps + 1) * p, qmm_name + "_tiled": p - lm_head})


def _param_bytes(tree):
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _streams_or_ties(tag, params, cfg, prompts, dev, want, runs):
    """Each engine run's streams equal ``want`` (generate's), or else pass
    phase 8's teacher-forced tie check on the contiguous decode route."""
    for name, reqs in runs.items():
        streams = [r.output for r in reqs]
        same = sum(a == b for a, b in zip(streams, want))
        log(f"[deepseek] {tag}: {name}'s streams equal generate's {same}/{len(want)}")
        if same != len(want):
            _tie_check(f"{tag} {name}", params, cfg, prompts, streams, dev, label="deepseek")


def _latent_prefill_ms(dev, cfg, prompts):
    """One K5 call at generate's prefill shape for ``prompts`` (the model's
    query heads on its latent KV head, the cache's rows, q_offsets 0), on
    seeded random rows: ms by CUDA events."""
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    hkv, d = cfg.kv_cache_dims()
    b, sq = len(prompts), max(map(len, prompts))
    q = torch.randn((b, cfg.num_q_heads, sq, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, hkv, cfg.max_seq_len, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    ms = Timer(dev)(lambda: flash_prefill(q, k, v, lens, causal=True, sm_scale=cfg.sm_scale()))
    del q, k, v
    torch.cuda.empty_cache()
    return ms


def phase_deepseek(dev, smi):
    """DeepSeek-V2-Lite and Mixtral-8x7B at full width (see the module doc)."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    out, t_phase = {}, time.perf_counter()

    # (a) DeepSeek-V2-Lite as published: int4 g128 routed experts and wo, the rest bf16
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig.deepseek_v2_lite(max_seq_len=LATENT_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.quantize_model_weights(llama.init_params(cfg, gen, quantize="int4", device=dev), "int4",
                                          consume=True)
    torch.cuda.synchronize()
    n, e, proj = cfg.num_layers, cfg.num_experts, _moe_step_projections(cfg, 0)
    hkv, d = cfg.kv_cache_dims()
    prompts = _variant_prompts(cfg.vocab_size, 1000, 3000, seed=SEED + 3)
    weight_bytes = _param_bytes(params) - _param_bytes(params["embed"])
    log(f"[deepseek] deepseek_v2_lite L={n} H={cfg.hidden_size} Hq={cfg.num_q_heads} latent row {d} lanes "
        f"(kv_lora_rank {cfg.kv_lora_rank} + rope {cfg.qk_rope_head_dim}), {e} experts top-"
        f"{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared, first {cfg.first_k_dense} dense at "
        f"{cfg.dense_inter_size}, V={cfg.vocab_size}, max_seq_len {cfg.max_seq_len}; int4 g128 experts + wo, "
        f"bf16 rest, bf16 latent cache; {weight_bytes / 1e9:.3f} GB of weights less the embedding; built in "
        f"{time.perf_counter() - t0:.1f} s; prompts {[len(p) for p in prompts]}; {smi}")
    ds = {"generate": _checked_generate(
        "deepseek (a)", params, cfg, prompts, dev,
        _moe_generate_counts(cfg, "quant_matmul_int4", 0, DSV2_NEW_TOKENS), DSV2_NEW_TOKENS, label="deepseek")}
    common = dict(num_slots=LATENT_BATCH, steps_per_round=VAR_STEPS, return_logprobs=True, device=dev)
    runs = {}
    eng, runs["Engine"], ds["engine"] = _variant_serve(
        "deepseek (a) Engine", lambda: Engine(params, cfg, **common), prompts,
        _engine_counts(n, VAR_STEPS, 0, "contiguous", 0, proj, "quant_matmul_int4"), DSV2_NEW_TOKENS, "deepseek")
    del eng
    eng, runs["PagedEngine"], ds["paged"] = _variant_serve(
        "deepseek (a) PagedEngine", lambda: PagedEngine(params, cfg, page_size=PAGE_SIZE,
                                                        prefill_chunk=LATENT_CHUNK, **common),
        prompts, _engine_counts(n, VAR_STEPS, 0, "paged", 0, proj, "quant_matmul_int4"), DSV2_NEW_TOKENS,
        "deepseek")
    del eng
    _greedy_agreement("deepseek (a) Engine vs PagedEngine", runs["Engine"], runs["PagedEngine"], "deepseek")
    t1 = time.perf_counter()
    _streams_or_ties("deepseek (a)", params, cfg, prompts, dev, ds["generate"]["streams"], runs)
    log(f"[deepseek] (a): {t1 - t0:.1f} s, then the stream checks {time.perf_counter() - t1:.1f} s")
    g, pg = ds["generate"]["counts"], ds["paged"]["counts"]
    steps, p_steps = DSV2_NEW_TOKENS - 1, ds["paged"]["stats"]["decode_rounds"] * VAR_STEPS
    log(f"[deepseek] (a) launches a step: K1 {g['flash_decode'] / steps:.0f}, K3 folded into K1 {g['flash_decode_append'] / steps:.0f}, "
        f"K6 {(g['quant_matmul_int4'] - g['quant_matmul_int4_tiled']) / steps:.0f} (decode), K5 "
        f"{g['flash_prefill']} and K6 tiled {g['quant_matmul_int4_tiled']} a prefill; PagedEngine: K7 "
        f"{pg['paged_flash_decode'] / p_steps:.0f}, K8 folded into K7 {pg['paged_flash_decode_append'] / p_steps:.0f}; TTFT p50 "
        f"{ds['engine']['stats']['p50_ttft_ms']} ms (Engine), {ds['paged']['stats']['p50_ttft_ms']} ms "
        f"(PagedEngine), generate {ds['generate']['wall_s']:.2f} s; {smi}")
    k5_ms = _latent_prefill_ms(dev, cfg, prompts)
    ds["k5_prefill_ms"] = g["flash_prefill"] * k5_ms
    log(f"[deepseek] (a) K5 at D 640: {g['flash_prefill']} launches a prefill x {k5_ms:.4f} ms = "
        f"{ds['k5_prefill_ms']:.2f} device ms a prefill (generate's: B {len(prompts)}, Sq "
        f"{max(map(len, prompts))}, Skv {cfg.max_seq_len}; CUDA events, L2 flushed, median of 20); TTFT p50 "
        f"{ds['engine']['stats']['p50_ttft_ms']} ms (Engine); {smi}")

    # (b) JAX's decode chain (bench_suite.py:1180-1212): B 4 at 4096 - 33 rows, greedy
    t0 = time.perf_counter()
    cache = contiguous.init_cache(n, LATENT_BATCH, hkv, cfg.max_seq_len, d, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    start = cfg.max_seq_len - DSV2_CHAIN_STEPS - 1

    def chain(k, tok):
        for _ in range(k):
            logits, _ = llama.decode_step(params, cache, tok, cos, sin, cfg)
            tok = llama.sample(logits)
        return tok

    tok = torch.zeros((LATENT_BATCH,), dtype=torch.int32, device=dev)
    cache.lengths.fill_(start)
    tok = chain(2, tok)  # warm-up
    cache.lengths.fill_(start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = chain(DSV2_CHAIN_STEPS, tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DSV2_CHAIN_STEPS
    mean_len = start + DSV2_CHAIN_STEPS / 2
    # JAX's byte accounting: weights less the embedding, the K and V latent
    # tables both read, its append term and the fp32 logits
    kv_bytes = 2 * LATENT_BATCH * hkv * mean_len * d * 2
    append_bytes = 4 * n * LATENT_BATCH * hkv * 32 * d * 2
    step_bytes = weight_bytes + kv_bytes + append_bytes + LATENT_BATCH * cfg.vocab_size * 4
    bound = step_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"[deepseek] (b) decode chain B={LATENT_BATCH} at {start}+ rows: {step_ms:.3f} ms/step "
        f"({LATENT_BATCH / step_ms * 1e3:.1f} tok/s), host clock over {DSV2_CHAIN_STEPS} steps; bytes a step "
        f"{step_bytes / 1e9:.3f} GB (weights {weight_bytes / 1e9:.3f}, latent K/V {kv_bytes / 1e9:.3f}), bound "
        f"{bound:.3f} ms at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, {bound / step_ms:.3f} of it; {smi}")
    cache.lengths.fill_(start)
    traced = _traced_steps("deepseek", "(b) decode chain", lambda: chain(DSV2_TRACED_STEPS, tok), DSV2_TRACED_STEPS)
    _split_k_share("deepseek", "(b) decode chain", traced)
    if traced:
        k1 = [v for name, v in traced["kernels"].items() if "decode_split_kernel" in name]
        log(f"[deepseek] (b) K1 (decode_split_kernel at D 640) in the traced window: "
            f"{sum(ms for ms, _ in k1):.3f} device ms a step in {sum(n for _, n in k1):.0f} launches, of "
            f"{traced['busy_ms']:.3f} busy")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[deepseek] (b): {time.perf_counter() - t0:.1f} s; (a)-(b) peak memory {peak:.1f} GiB; {smi}")
    ds["chain"] = dict(step_ms=step_ms, bound_ms=bound, bytes=step_bytes, traced=traced, peak_gib=peak)
    out["deepseek"] = ds
    del params, cache
    torch.cuda.empty_cache()

    # 4 full-width layers against the plain twins (layer 0 dense, 1-3 MoE)
    t0 = time.perf_counter()
    _path_vs_path(dev, ModelConfig.deepseek_v2_lite(num_layers=4, max_seq_len=LATENT_SEQ), "int4",
                  "deepseek_v2_lite 4 layers, int4 experts + wo + lm_head, bf16 latent KV",
                  ("flash_prefill", "flash_decode", "flash_decode_append", "quant_matmul_int4"),
                  prompt_lengths=list(DSV2_CHECK_PROMPTS))
    log(f"[deepseek] 4 layers against the plain route: {time.perf_counter() - t0:.1f} s")

    # (c) Mixtral-8x7B at full width, cut to 2 layers: int8 experts (K4 at lidx * E + e)
    t0 = time.perf_counter()
    cfg = ModelConfig.mixtral_8x7b(num_layers=2, max_seq_len=SLICE_SEQ)
    params, _ = build_model(cfg, dev)
    prompts = _variant_prompts(cfg.vocab_size, 200, 600, seed=SEED + 4)
    log(f"[deepseek] mixtral_8x7b L={cfg.num_layers} (of 32) H={cfg.hidden_size} I={cfg.intermediate_size} "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, int8 weights + experts + lm_head, bf16 KV; "
        f"prompts {[len(p) for p in prompts]}")
    mx = {"generate": _checked_generate("mixtral (c)", params, cfg, prompts, dev,
                                        _moe_generate_counts(cfg, "quant_matmul", 1, VAR_NEW_TOKENS),
                                        VAR_NEW_TOKENS, label="deepseek")}
    eng, reqs, mx["engine"] = _variant_serve(
        "mixtral (c) Engine", lambda: Engine(params, cfg, num_slots=LATENT_BATCH, steps_per_round=VAR_STEPS,
                                             device=dev),
        prompts, _engine_counts(cfg.num_layers, VAR_STEPS, 0, "contiguous", 1,
                                _moe_step_projections(cfg, 1)), label="deepseek")
    del eng
    _streams_or_ties("mixtral (c)", params, cfg, prompts, dev, mx["generate"]["streams"], {"Engine": reqs})
    out["mixtral"] = mx
    del params
    torch.cuda.empty_cache()
    log(f"[deepseek] mixtral (c): {time.perf_counter() - t0:.1f} s; phase 12 {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_decode_profile(dev):
    """bench.py's decode chains on the port: full-width 7B-GQA, B=16, every
    sequence at 512 of 1024 cache rows, greedy steps; int8 weights and
    lm_head with a bf16 cache (at one split and at four), then bench.py's
    second chain, int4 g128 weights and lm_head with an int8 cache. Times the step on the host clock, then traces a
    few steps with torch.profiler for device time by kernel and the device's
    idle share. Not part of the default run."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    batch, start_len, steps, traced = 16, 512, 32, 8
    chains = (("num_splits=1", "int8", dict(num_splits=1)),
              (f"num_splits={ModelConfig.llama_7b_gqa().num_splits}", "int8", {}),
              ("int4w+int8kv", "int4", dict(quant_mode="int8")))
    for label, mode, overrides in chains:
        cfg = ModelConfig.llama_7b_gqa(max_seq_len=SLICE_SEQ, **overrides)
        params, _ = build_model(cfg, dev, mode)
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, batch, hkv, cfg.max_seq_len, d,
                                      quant_mode=cfg.quant_mode,
                                      calibration_scale=cfg.kv_calibration_scale, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        tok = torch.zeros((batch,), dtype=torch.int32, device=dev)

        def run(n, tok):
            for _ in range(n):
                logits, _ = llama.decode_step(params, cache, tok, cos, sin, cfg)
                tok = llama.sample(logits)
            return tok

        cache.lengths.fill_(start_len)
        tok = run(3, tok)  # warm-up
        cache.lengths.fill_(start_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = run(steps, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        log(f"[profile] {label}: decode B={batch} at {start_len}+ rows: {step_ms:.3f} ms/step "
            f"({batch / step_ms * 1e3:.1f} tok/s), host clock over {steps} steps")

        cache.lengths.fill_(start_len)
        _split_k_share("profile", label, _traced_steps("profile", label, lambda: run(traced, tok), traced))
        del params, cache
        torch.cuda.empty_cache()


def _traced_steps(tag, label, run, steps):
    """``run()`` (``steps`` decode steps) under torch.profiler: logs the wall
    and device-busy ms a step, the launches a step, the device's idle share
    and the 12 costliest kernels; returns them (``kernels``: {name: (device
    ms, launches) a step}), or None where the profiler
    saw no device time. It records device activity only: with the host's
    op events too, phase 12b's 8 traced MoE steps (12,850 launches each)
    took some 70 s more to summarize (an H100 80GB HBM3 at 700 W)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        kernels[evt.key] = (us / 1e3 / steps, evt.count / steps)
    if not kernels:
        log(f"[{tag}] {label}: the profiler saw no device time; kernel breakdown not measured")
        return None
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    idle = 1 - busy * steps / wall_ms
    log(f"[{tag}] {label}: traced {steps} steps, {wall_ms / steps:.3f} ms/step wall, "
        f"device busy {busy:.3f} ms/step in {launches:.2f} kernel launches/step, idle share {idle:.3f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}]   {ms:8.3f} ms/step  {n:6.1f} launches/step  {name[:110]}")
    return dict(wall_ms=wall_ms / steps, busy_ms=busy, launches=launches, idle_share=idle, kernels=kernels)


def _split_k_share(tag, label, traced):
    """Log the split-K matmuls' (K4 / K6 at up to 64 rows) device ms a step
    in a traced window of ``_traced_steps``."""
    if not traced:
        return
    rows = [v for name, v in traced["kernels"].items() if "qmm_split_k" in name]
    log(f"[{tag}] {label}: split-K matmuls (K4 / K6 at decode rows, qmm_split_k) "
        f"{sum(ms for ms, _ in rows):.3f} device ms a step in {sum(n for _, n in rows):.0f} launches, of "
        f"{traced['busy_ms']:.3f} busy")


# ---------------------------------------------------------------- phase 13


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Rank:
    """What one rank of phase 13 or 14 checks and records: each check raises on
    this rank (which fails the world), rank 0 logs, and every number goes
    to the rank's record for the parent's summary."""

    def __init__(self, rank, tag="seq-parallel"):
        self.rank, self.rec, self.tag = rank, {}, tag

    def log(self, *args):
        if self.rank == 0:
            log(*args)

    def check(self, name, err, tol, what="max abs error over the peak"):
        self.rec.setdefault("checks", {})[name] = (err, tol)
        self.log(f"[{self.tag}] {name}: {what} {err:.3e} (tolerance {tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"rank {self.rank}: {name}: {err} > {tol}")

    def counts(self, name, counts, want):
        self.rec.setdefault("counts", {})[name] = counts
        if counts != want:
            raise AssertionError(f"rank {self.rank}: {name}: launch counts {counts} != expected {want}")


def _rel(got, want, mask=None):
    """max |got - want| over want's peak (over ``mask`` where given)."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    if mask is not None:
        err, ref = err * mask, ref * mask
    return err.max().item() / max(ref.max().item(), 1e-30)


def _timed(fn):
    """(fn's result, its host-clock ms, with the card synchronized before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rank_trace(r, tag, fn):
    """``fn()`` under torch.profiler on this rank, device activity only
    (each rank's profiler sees its own kernels and copies): the rank's wall
    ms and device ms by kind, recorded; rank 0 logs them with its costliest
    kernels. Four ranks time-slice the one card, so the ranks' busy times
    do not add up to the card's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _kernel_times(prof)
    split = _device_split(rows)
    copies = sum(ms for name, ms, _ in rows if "memcpy" in name.lower())  # gloo's host copies, in "other"
    r.rec[f"trace {tag}"] = dict(wall_ms=wall, split=split, copies_ms=copies)
    r.log(f"[seq-parallel] {tag} traced on rank 0: {wall:.1f} ms wall, device busy {sum(split.values()):.1f} ms "
          "(" + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + f"; of it copies to and from the host "
          f"{copies:.1f})")
    for name, ms, count in rows[:6]:
        r.log(f"[seq-parallel]   {ms:9.2f} ms  {count:5d} launches  {name[:110]}")


def _ring_counts(n, fwd_calls=1, bwd_calls=1, banded=False, per_step=1, offset_free=1):
    """One rank's launch counts for ``fwd_calls`` ring forwards of ``n``
    steps, each step ``per_step`` K5-with-LSE launches of which
    ``offset_free`` a call have kv_offset 0, and ``bwd_calls`` ring
    backwards (n dq and n dk/dv launches, one of each at kv_offset 0);
    ``banded``: every launch has a window."""
    f, bq = n * per_step * fwd_calls, n * bwd_calls
    want = dict(flash_prefill=f, flash_prefill_lse=f, flash_prefill_kv_offset=f - offset_free * fwd_calls,
                flash_bwd_dq=bq, flash_bwd_dkdv=bq, flash_bwd_dq_kv_offset=bq - bwd_calls,
                flash_bwd_dkdv_kv_offset=bq - bwd_calls)
    if banded:
        want.update(flash_prefill_lse_banded=f, flash_bwd_dq_banded=bq, flash_bwd_dkdv_banded=bq)
    return zero_counts(**want)


def _ring_attention_path(r, mesh, dev):
    """13a and 13b on this rank: the ring (contiguous forward and backward,
    zigzag forward, Mistral-7B's window with 4 sinks) and Ulysses against
    one process's K5 and K12 on the whole sequence."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.ops.flash_bwd import flash_prefill_bwd
    from starflashattention_tpu_torch.ops.flash_prefill import flash_prefill
    from starflashattention_tpu_torch.parallel import comm, make_ring_prefill, make_ulysses_prefill, ring
    from starflashattention_tpu_torch.parallel.ulysses import ulysses_attention

    seq = mesh.axis("seq")
    i, n = seq.index, seq.size
    b, hq, hkv, d, s = RING_BATCH, 32, 8, 128, RING_SEQ
    c = s // n
    rows = slice(i * c, (i + 1) * c)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)  # the same tensors on every rank
    bf16 = torch.bfloat16
    q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev, dtype=bf16) for _ in range(2))
    lengths = torch.tensor(RING_LENGTHS, dtype=torch.int32, device=dev)
    valid = (torch.arange(i * c, (i + 1) * c, device=dev)[None, :] < lengths[:, None])[:, None, :, None]
    tag = f"B={b} Hq={hq} Hkv={hkv} D={d} S={s} over {n} ranks, lengths {list(RING_LENGTHS)}"

    def reference(q, k, kw):
        """One process's K5 (with the LSE) and K12 on the whole sequence,
        the ranks in turn, so that each time is the card's alone: the
        kernel work the ring spreads over the ranks."""
        for turn in range(n):
            if turn == i:
                (o, lse), ms_f = _timed(lambda: flash_prefill(q, k, v, lengths, return_lse=True, **kw))
                grads, ms_b = _timed(lambda: flash_prefill_bwd(q, k, v, o, lse, do, lengths, **kw))
            dist.barrier()
        return o, [g[:, :, rows].clone() for g in grads], ms_f + ms_b

    def ring_run(name, q, k, kw, o_full, ref_grads, ms_ref):
        mine = [x[:, :, rows].contiguous().requires_grad_() for x in (q, k, v)]
        reset_counts()
        h0 = comm.host_bytes
        o, ms_f = _timed(lambda: ring.ring_attention(*mine, lengths, axis_name=seq, **kw))
        grads, ms_b = _timed(lambda: torch.autograd.grad(o, mine, do[:, :, rows]))
        r.counts(f"13a {name}", read_counts(), _ring_counts(n, banded=kw.get("window") is not None))
        r.check(f"13a ring {name} output (valid rows) vs one process's K5", _rel(o, o_full[:, :, rows], valid),
                RING_TOL)
        for g_name, g, want in zip(("dq", "dk", "dv"), grads, ref_grads):
            r.check(f"13a ring {name} {g_name} vs one process's K12", _rel(g, want), RING_GRAD_TOL)
        r.rec[f"13a {name}"] = dict(ring_fwd_ms=ms_f, ring_bwd_ms=ms_b, single_ms=ms_ref,
                                    host_bytes=comm.host_bytes - h0)
        r.log(f"[seq-parallel] 13a ring {name} at {tag}: forward {ms_f:.1f} ms, backward {ms_b:.1f} ms a rank "
              f"(host clock; gloo through the host, {(comm.host_bytes - h0) / 2**20:.0f} MiB copied by rank 0); "
              f"one process's K5 + K12 on the whole sequence, alone on the card, {ms_ref:.1f} ms")
        return mine

    # -- one untimed ring first, at full size: the rank's first forward and
    # backward cost seconds more than the next ones (on the CPU too), which
    # would hide the ring's own time
    mine = [x[:, :, rows].contiguous().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(ring.ring_attention(*mine, lengths, axis_name=seq), mine, do[:, :, rows])
    del mine

    # -- contiguous, causal; then once more under the profiler
    o_full, ref_grads, ms_ref = reference(q, k, {})
    mine = ring_run("causal", q, k, {}, o_full, ref_grads, ms_ref)
    _rank_trace(r, "13a ring causal forward + backward", lambda: torch.autograd.grad(
        ring.ring_attention(*mine, lengths, axis_name=seq), mine, do[:, :, rows]))
    del mine

    # -- zigzag (balanced), forward
    perm = torch.from_numpy(ring.zigzag_permutation(s, n)[i * c:(i + 1) * c]).to(dev)
    zig = make_ring_prefill(mesh, seq_axis="seq", balanced=True)
    reset_counts()
    o, ms = _timed(lambda: zig(*(x[:, :, perm] for x in (q, k, v)), lengths))
    r.counts("13a zigzag", read_counts(), _ring_counts(n, bwd_calls=0, per_step=4, offset_free=2))
    zvalid = (perm[None, :] < lengths[:, None])[:, None, :, None]
    r.check("13a zigzag output (valid rows) vs one process's K5", _rel(o, o_full[:, :, perm], zvalid), RING_TOL)
    r.rec["13a zigzag"] = dict(ring_fwd_ms=ms)
    r.log(f"[seq-parallel] 13a zigzag forward at {tag}: {ms:.1f} ms a rank")

    # -- 13b Ulysses, forward and gradients (the same reference)
    u = make_ulysses_prefill(mesh, seq_axis="seq")
    reset_counts()
    o, ms_f = _timed(lambda: u(*(x[:, :, rows] for x in (q, k, v)), lengths))
    r.counts("13b forward", read_counts(), zero_counts(flash_prefill=1))
    r.check("13b Ulysses output (valid rows) vs one process's K5", _rel(o, o_full[:, :, rows], valid), RING_TOL)
    mine = [x[:, :, rows].contiguous().requires_grad_() for x in (q, k, v)]
    reset_counts()
    o = ulysses_attention(*mine, lengths, axis_name=seq, differentiable=True)
    grads, ms_b = _timed(lambda: torch.autograd.grad(o, mine, do[:, :, rows]))
    r.counts("13b gradients", read_counts(),
             zero_counts(flash_prefill=1, flash_prefill_lse=1, flash_bwd_dq=1, flash_bwd_dkdv=1))
    for g_name, g, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        r.check(f"13b Ulysses {g_name} vs one process's K12", _rel(g, want), RING_GRAD_TOL)
    r.rec["13b"] = dict(fwd_ms=ms_f, bwd_ms=ms_b)
    r.log(f"[seq-parallel] 13b Ulysses at {tag}: forward {ms_f:.1f} ms, backward {ms_b:.1f} ms a rank")
    del o_full, ref_grads, mine, grads, o

    # -- Mistral-7B: window 4096 + 4 sinks, the first keys of every chunk heavy
    kw = dict(window=VARIANT_WINDOW, sinks=VARIANT_SINKS)
    qh, kh = _chunk_heavy(q, k, VARIANT_SINKS, c, gen)
    o_full, ref_grads, ms_ref = reference(qh, kh, kw)
    mine = ring_run("window 4096 + 4 sinks", qh, kh, kw, o_full, ref_grads, ms_ref)

    @dataclasses.dataclass(frozen=True)
    class RawSinks(ring._RingConfig):
        """Every chunk given the raw sinks: ``kv_offset`` ignored."""

        def kernel_kw(self, kv_offset):
            return super().kernel_kw(0)

    with torch.no_grad():
        o_raw, _ = ring._ring_forward(RawSinks(seq, True, None, **kw), *mine, lengths)
    err = _rel(o_raw, o_full[:, :, rows], valid)
    r.rec["13a raw sinks error"] = err
    # rank 0's rows see only its own chunk, where kv_offset is 0: the option
    # shows on every later rank, whose own chunk's heavy first keys the raw
    # sinks pull into rows whose band lies far past them
    r.log(f"[seq-parallel] 13a ring with the raw sinks on every chunk (kv_offset ignored): rank 0's output "
          f"{err:.3e} of the peak from one process's K5 (its rows see only chunk 0; ranks 1-{n - 1} must lie "
          f"over 4x the tolerance {RING_TOL}: see the summary)")
    if i > 0 and not err > 4 * RING_TOL:
        raise AssertionError(f"rank {r.rank}: the ring check does not see kv_offset ({err} <= {4 * RING_TOL})")
    del q, k, v, do, qh, kh, o_full, ref_grads, mine, o_raw
    torch.cuda.empty_cache()


def _sharded_decode_path(r, mesh, dev):
    """13c on this rank: ``make_seq_sharded_decode`` (bf16 and int8 KV,
    head_chunks 1 and 2) against K1 on the whole cache and against the plain
    twin on the whole cache; with head_chunks 1, K2's partials on the
    rank's shard (its 8192 rows in 4 splits) against their plain twin."""
    from starflashattention_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_plain,
                                                               flash_decode_with_stats,
                                                               flash_decode_with_stats_plain)
    from starflashattention_tpu_torch.parallel import comm, make_seq_sharded_decode

    seq = mesh.axis("seq")
    i, n = seq.index, seq.size
    cfg = SHARDED_DECODE
    b, hq, hkv, d, s = cfg["batch"], 32, 8, 128, cfg["seq"]
    c = s // n
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.linspace(*cfg["lengths"], b, device=dev).round().to(torch.int32)
    scales, quant = {}, {}
    for name, x in (("k", k), ("v", v)):  # per-KV-head absmax int8
        sc = x.float().abs().amax(dim=(0, 2, 3)) / 127.0
        scales[name] = sc
        quant[name] = (x.float() / sc[None, :, None, None]).round().clamp(-127, 127).to(torch.int8)
    tag = f"B={b} Hq={hq} Hkv={hkv} D={d}, {s} cache rows ({c} a rank), lengths {cfg['lengths'][0]}-{cfg['lengths'][1]}"
    for kv in ("bf16", "int8"):
        if kv == "bf16":
            full, extra = (k, v), {}
        else:
            full, extra = (quant["k"], quant["v"]), dict(k_scales=scales["k"], v_scales=scales["v"])
        shard = tuple(x[:, :, i * c:(i + 1) * c].contiguous() for x in full)  # the rank holds its rows
        ref, ms_ref = _timed(lambda: flash_decode(q, *full, lengths, num_splits=1, **extra))
        # the plain twins on (B, Hq, S, D) fp32 copies of the rows: two sequences at a time
        plain = torch.cat([flash_decode_plain(q[j:j + 2], full[0][j:j + 2], full[1][j:j + 2], lengths[j:j + 2],
                                              num_splits=1, **extra) for j in range(0, b, 2)])
        local_len = (lengths - i * c).clamp(0, c).to(torch.int32)
        stats_kw = dict(num_splits=cfg["num_splits"], block_k=cfg["block_k"], **extra)
        parts = flash_decode_with_stats(q, *shard, local_len, **stats_kw)
        parts_plain = [torch.cat(x) for x in zip(*(flash_decode_with_stats_plain(
            q[j:j + 2], shard[0][j:j + 2], shard[1][j:j + 2], local_len[j:j + 2], **stats_kw)
            for j in range(0, b, 2)))]
        for name, err in _partial_errors(parts, parts_plain).items():
            r.check(f"13c {kv} KV: K2 partials on the rank's shard, {name}, vs the plain twin", err,
                    0.0 if name == "dead splits" else 1e-4, what="max error")
        del parts, parts_plain
        for chunks in (1, 2):
            fn = make_seq_sharded_decode(mesh, seq_axis="seq", num_splits=cfg["num_splits"],
                                         block_k=cfg["block_k"], quantized=kv == "int8", head_chunks=chunks)
            args = (q, *shard, lengths) + ((scales["k"], scales["v"]) if kv == "int8" else ())
            reset_counts()
            o = fn(*args)
            r.counts(f"13c {kv} head_chunks {chunks}", read_counts(), zero_counts(flash_decode=chunks))
            h0 = comm.host_bytes
            _, ms = _timed(lambda: fn(*args))  # the second call: the first one loads and counts
            # fp32 partials merged in another order than K1's one walk, then one bf16 rounding on each side
            # (int8: K1 rounds its output to bf16 before v_scale, as JAX does: one more)
            r.check(f"13c {kv} KV head_chunks {chunks} vs K1 on the whole cache", _ulps(o, ref),
                    3.0 if kv == "int8" else 2.0, what="largest error in bf16 ulps of each element")
            r.check(f"13c {kv} KV head_chunks {chunks} vs the plain twin on the whole cache", _ulps(o, plain),
                    3.0 if kv == "int8" else 2.0, what="largest error in bf16 ulps of each element")
            r.rec[f"13c {kv} {chunks}"] = dict(ms=ms, k1_ms=ms_ref, host_bytes=comm.host_bytes - h0)
            r.log(f"[seq-parallel] 13c {kv} KV, head_chunks {chunks}, {tag}: {ms:.2f} ms a call (host clock, "
                  f"merge through the host: {comm.host_bytes - h0} bytes on rank 0); K1 on the whole cache in "
                  f"one process {ms_ref:.2f} ms")
    del q, k, v, quant, full, shard, plain
    torch.cuda.empty_cache()


def _cp_training_path(r, mesh, dp_mesh, dev):
    """13d on this rank: context-parallel training of Mistral-7B with 4
    sinks (2 layers at full width) at B=1, S=32768, against the single
    process's gradients on rank 0; 3 SGD steps; then CP x DP on the 2 x 2
    mesh at B=2, S=16384."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.models import llama, train
    from starflashattention_tpu_torch.parallel import comm, init_opt_state, make_cp_train_step
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    cfg = ModelConfig.mistral_7b(attention_sinks=VARIANT_SINKS, num_layers=CP_LAYERS, max_seq_len=CP_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)  # the same params and batches on every rank
    params = llama.init_params(cfg, gen, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    tag = (f"Mistral-7B + {VARIANT_SINKS} sinks (window {cfg.sliding_window}), {CP_LAYERS} of 32 layers at full "
           f"width, bf16")

    def run(name, step_mesh, batch, steps, kw):
        """Rank 0's single-process gradients of the first batch, then
        ``steps`` CP steps (the first one compared)."""
        ref = None
        if r.rank == 0:
            (loss_ref, grads_ref), ms_ref = _timed(lambda: train.loss_and_grads(params, batch, cfg, cos, sin))
            ref = (float(loss_ref), grads_ref, ms_ref)
        dist.barrier()
        torch.cuda.empty_cache()
        step = make_cp_train_step(step_mesh, cfg, TRAIN_LR, **kw)
        state = init_opt_state(params)
        n_seq = step_mesh.axis("seq").size
        # remat: two ring forwards a layer, one backward
        want = _ring_counts(n_seq, fwd_calls=2 * CP_LAYERS, bwd_calls=CP_LAYERS, banded=True)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, host = [], [], []
        for t in range(steps):
            reset_counts()
            h0 = comm.host_bytes
            (_, _, loss), ms = _timed(lambda: step(params, state, batch, cos, sin))
            losses.append(float(loss))
            step_ms.append(ms)
            host.append(comm.host_bytes - h0)
            r.counts(f"13d {name} step {t}", read_counts(), want)
            if t == 0 and ref is not None:  # momentum from 0 after one step: the reduced gradients
                r.check(f"13d {name} first loss vs one process's", abs(losses[0] - ref[0]), TRAIN_GRAD_TOL,
                        what="abs error")
                worst = max((_rel(g, gr), key) for (key, g), gr in zip(
                    _named_leaves(state), train.tree_leaves(ref[1])))
                r.check(f"13d {name} every gradient vs one process's (worst: {worst[1]})", worst[0],
                        TRAIN_GRAD_TOL)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if steps > 1:  # one more step, traced
            _rank_trace(r, f"13d {name} step", lambda: step(params, state, batch, cos, sin))
        tokens = batch.shape[0] * (batch.shape[1] - 1)
        if not all(np.isfinite(losses)) or (steps > 1 and not losses[-1] < losses[0]):
            raise AssertionError(f"rank {r.rank}: 13d {name}: the loss did not fall: {losses}")
        r.rec[f"13d {name}"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms[-1] * 1e3,
                                    peak_gib=peak, host_bytes_per_step=host[-1],
                                    single_ms=None if ref is None else ref[2])
        r.log(f"[seq-parallel] 13d {name}, {tag}, B={batch.shape[0]} S={batch.shape[1] - 1}: losses {losses}; ms a "
              f"step {[round(x, 1) for x in step_ms]} (host clock); {tokens / step_ms[-1] * 1e3:.0f} tokens/s at the "
              f"last step; peak memory {peak:.1f} GiB on rank 0; {host[-1] / 2**30:.2f} GiB copied through the host "
              f"a step by rank 0 (gloo); the single process's loss and gradients "
              f"{'not run' if ref is None else f'{ref[2]:.1f} ms'}")
        del state, ref
        torch.cuda.empty_cache()

    batch = torch.randint(0, cfg.vocab_size, (1, CP_SEQ + 1), generator=gen, device=dev)
    run("CP (seq 4)", mesh, batch, CP_STEPS, {})
    b, s = CP_DP
    batch = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=dev)
    run("CP x DP (data 2, seq 2)", dp_mesh, batch, 1, dict(data_axis="data"))
    del params


def _seq_parallel_rank(rank, world, port, out_dir):
    """One rank of phase 13: joins the gloo world on this card, runs 13a-13d
    and writes its record to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(f"tcp://localhost:{port}", backend="gloo", world_size=world, rank=rank)
    mesh = make_mesh({"seq": world}, device=dev)
    dp_mesh = make_mesh({"data": 2, "seq": world // 2}, device=dev)
    r = _Rank(rank)
    for name, fn in (("13a-b", lambda: _ring_attention_path(r, mesh, dev)),
                     ("13c", lambda: _sharded_decode_path(r, mesh, dev)),
                     ("13d", lambda: _cp_training_path(r, mesh, dp_mesh, dev))):
        t0 = time.perf_counter()
        fn()
        r.rec.setdefault("seconds", {})[name] = time.perf_counter() - t0
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(r.rec, f)
    dist.destroy_process_group()


def phase_seq_parallel(smi):
    """Phase 13 (see the module doc): RING_WORLD ranks on this one card
    over gloo. Every library is built (phase 1) before the spawn, so the
    ranks only load them. Returns the ranks' records."""
    import torch.multiprocessing as mp

    from starflashattention_tpu_torch.ops._build import BUILD_DIR

    torch.cuda.empty_cache()
    out_dir = BUILD_DIR / "phase13"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    mp.spawn(_seq_parallel_rank, args=(RING_WORLD, _free_port(), str(out_dir)), nprocs=RING_WORLD, join=True)
    recs = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(RING_WORLD)]
    secs = time.perf_counter() - t0
    worst = {}
    for rec in recs:
        for name, (err, tol) in rec["checks"].items():
            worst[name] = max(worst.get(name, (0.0, tol)), (err, tol))
    for name, (err, tol) in worst.items():
        log(f"[seq-parallel] worst of {RING_WORLD} ranks: {name}: {err:.3e} (tolerance {tol:.3e})")
    totals = {}
    for rec in recs:
        for counts in rec["counts"].values():
            for key, n in counts.items():
                totals[key] = totals.get(key, 0) + n
    log(f"[seq-parallel] launches over the {RING_WORLD} ranks' counted runs: "
        + ", ".join(f"{k} {v}" for k, v in totals.items() if v))
    log(f"[seq-parallel] raw-sinks errors by rank: {[round(rec['13a raw sinks error'], 4) for rec in recs]}")
    for key in [k for k in recs[0] if k.startswith("13d ")]:
        log(f"[seq-parallel] {key} by rank: peak memory {[round(rec[key]['peak_gib'], 2) for rec in recs]} GiB, "
            f"through the host a step {[round(rec[key]['host_bytes_per_step'] / 2**30, 2) for rec in recs]} GiB, "
            f"ms a step {[round(rec[key]['step_ms'][-1], 1) for rec in recs]}")
    log(f"[seq-parallel] phase 13 took {secs:.1f} s ({smi}; the ranks' seconds: "
        f"{[{k: round(v, 1) for k, v in rec['seconds'].items()} for rec in recs]}); gloo copies every "
        "rotated chunk and reduction through the host, so these wall times are no guide to NCCL")
    return dict(records=recs, totals=totals, seconds=secs)


# ---------------------------------------------------------------- phase 14

TP_WORLD = 4  # phase 14's ranks, all on this one card
TP_DENSE_LAYERS = 8  # 14a, 14b, 14d: 7B-GQA at full width, depth cut (the default run's time limit)
TP_CHECK_LAYERS = 4  # (a)'s path-vs-path checks
TP_SERVE = dict(requests=12, slots=4, steps=8, chunk=256, new_tokens=32)
EP_NEW_TOKENS = 16
PP_DECODE_STEPS = 4
TP_TRAIN = dict(layers=2, batch=2, seq=2048, cp_seq=8192, steps=3)
TP_MESHES = {"tp4": {"model": 4}, "dp2_tp2": {"data": 2, "model": 2}, "pp4": {"pipe": 4},
             "pp2_tp2": {"pipe": 2, "model": 2}, "tp2_sp2": {"model": 2, "seq": 2}}


def _first_layers(params, k):
    """The model cut to its first k layers (views of the stacks)."""
    def cut(w):
        return {key: t[:k] for key, t in w.items()} if isinstance(w, dict) else w[:k]

    return dict(params, layers={name: cut(w) for name, w in params["layers"].items()})


def _list_prompts(prompts, lengths):
    return [prompts[i, :int(n)].tolist() for i, n in enumerate(lengths.tolist())]


class _RowScales:
    """Records what ``quantize_rows`` returns inside the W8A8 / W4A8
    matmuls (the inputs and row scales of each call, with its axis), by
    standing in for it in ``ops.quant_matmul`` while in use."""

    def __enter__(self):
        from starflashattention_tpu_torch.ops import quant_matmul as qmm

        self.qmm, self.orig, self.calls = qmm, qmm.quantize_rows, []

        def record(x, eps=1e-6, axis=None):
            x8, rs = self.orig(x, eps, axis=axis)
            self.calls.append((axis is not None, x.detach().clone(), rs.clone()))
            return x8, rs

        qmm.quantize_rows = record
        return self

    def __exit__(self, *exc):
        self.qmm.quantize_rows = self.orig


def _tp_generate(r, name, mesh, cfg, params_local, cache, prompts, lengths, steps, want):
    """TP prefill + ``steps`` greedy decode steps, counters zeroed before
    and checked after: (streams (B, steps + 1), ms of the prefill, ms a
    decode step, host bytes a decode step)."""
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.parallel import comm, make_tp_decode_step, make_tp_prefill

    cos, sin = llama.rope_tables(cfg, device=mesh.device)
    pre, step = make_tp_prefill(mesh, cfg), make_tp_decode_step(mesh, cfg)
    reset_counts()
    (logits, cache), pre_ms = _timed(lambda: pre(params_local, cache, prompts, lengths, cos, sin))
    toks = [llama.sample(logits)]
    h0 = comm.host_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = step(params_local, cache, toks[-1], cos, sin)
        toks.append(llama.sample(logits))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    host = (comm.host_bytes - h0) / max(steps, 1)
    r.counts(name, read_counts(), want)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"rank {r.rank}: {name}: non-finite logits")
    return torch.stack(toks, dim=1), pre_ms, step_ms, host


def _decode_counts(n_layers, steps, projections, prefill_rows, lm_head=1):
    """Counts of a prefill and ``steps`` decode steps on one rank (fused
    decode attention; the prefill's projections tiled past 64 rows, its
    head on the last positions' rows)."""
    proj = projections * n_layers + lm_head
    return zero_counts(flash_prefill=n_layers, flash_decode=steps * n_layers, flash_decode_append=steps * n_layers,
                       quant_matmul=proj * (steps + 1),
                       quant_matmul_tiled=projections * n_layers if prefill_rows > 64 else 0)


def _tp_dense_paths(r, meshes, dev):
    """14a, 14d, 14b, 14g on this rank: 7B-GQA at full width, TP_DENSE_LAYERS deep (int8
    weights + lm_head, bf16 KV, one split): TP 4 generate with phase 4's
    check at 4 layers and the W8A8 / W4A8 row scales; PP 4 and PP 2 x TP 2
    decode against one process; then Engine / PagedEngine on the 2 x 2
    (data, model) mesh against one process's engines, without and with
    adapters."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.parallel import comm, pp, tp
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    cfg = ModelConfig.llama_7b_gqa(num_layers=TP_DENSE_LAYERS, max_seq_len=SLICE_SEQ, num_splits=1)
    t0 = time.perf_counter()
    params, gen = build_model(cfg, dev)  # the same seeded model on every rank
    prompts, lengths = _prompts(cfg, dev, gen)
    cos, sin = llama.rope_tables(cfg, device=dev)
    b, n = prompts.shape[0], cfg.num_layers
    rows = b * prompts.shape[1]
    r.log(f"[tensor-parallel] llama_7b_gqa L={n} int8 weights + int8 lm_head, bf16 KV, built on each of "
          f"{TP_WORLD} ranks in {time.perf_counter() - t0:.1f} s")

    def full_cache(c=cfg, rows_=b):
        return contiguous.init_cache(c.num_layers, rows_, c.num_kv_heads, c.max_seq_len, c.head_dim, device=dev)

    # ---- 14a: TP 4, full depth
    mesh = meshes["tp4"]
    local = tp.shard_params(params, mesh, cfg)
    steps = SLICE_NEW_TOKENS - 1
    streams, pre_ms, step_ms, host = _tp_generate(
        r, "14a TP 4 generate", mesh, cfg, local, tp.shard_cache(full_cache(), mesh), prompts, lengths, steps,
        _decode_counts(n, steps, 4, rows))
    peak = torch.cuda.max_memory_allocated() / 2**30
    r.rec["14a streams"] = streams.tolist()
    r.rec["14a"] = dict(prefill_ms=pre_ms, step_ms=step_ms, host_bytes_per_step=host, peak_gib=peak)
    r.log(f"[tensor-parallel] 14a TP 4, {n} layers: prefill {pre_ms:.1f} ms, {step_ms:.1f} ms a decode step "
          f"(host clock), {host / 2**20:.2f} MiB through the host a step (gloo), peak memory {peak:.1f} GiB on "
          f"rank 0 (the full model for the references beside its shard)")
    if r.rank == 0:
        _tie_check("14a TP 4 streams", params, cfg, _list_prompts(prompts, lengths), streams.tolist(), dev,
                   label="tensor-parallel")
    dist.barrier()
    del local
    # 4 layers against one process (phase 4's tolerance), both on the kernels, fed the TP route's tokens
    short = dataclasses.replace(cfg, num_layers=TP_CHECK_LAYERS)
    p4 = _first_layers(params, TP_CHECK_LAYERS)
    tp_logits = _tp_logits(mesh, short, tp.shard_params(p4, mesh, short), tp.shard_cache(full_cache(short), mesh),
                           prompts, lengths, streams)
    if r.rank == 0:
        one = _one_logits(short, p4, full_cache(short), prompts, lengths, streams)
        r.check("14a TP 4 vs one process, 4 layers, prefill + 4 decode steps", _rel(tp_logits, one), 0.05)
    dist.barrier()
    # W8A8 (K10) at 4 layers: the row-parallel scales are the full rows'
    _row_scale_check(r, mesh, dataclasses.replace(short, w8a8_prefill=True), p4, full_cache(short), prompts,
                     lengths, "W8A8", "quant_matmul_w8a8")
    del p4
    # W4A8 (K11) at 4 layers on int4 weights with 64-row groups: w_down's 11008 rows make 172 groups, which
    # the model axis divides (g128's 86 would not)
    p4 = llama.init_params(short, torch.Generator(device=dev).manual_seed(SEED + 17), quantize="int4", int4_group=64,
                           device=dev)
    p4 = llama.quantize_model_weights(p4, "int4", lm_head=True, consume=True, int4_group=64)
    _row_scale_check(r, mesh, dataclasses.replace(short, w8a8_prefill=True), p4, full_cache(short), prompts,
                     lengths, "W4A8", "quant_matmul_w4a8")
    del p4
    # ---- 14d: PP 4 and PP 2 x TP 2 decode against one process
    cache = full_cache()
    llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)  # on every rank: the same bytes
    ref = None
    if r.rank == 0:  # both routes are fed the TP stream's tokens
        rc = contiguous.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone())
        ref = torch.stack([llama.decode_step(params, rc, streams[:, i], cos, sin, cfg)[0]
                           for i in range(PP_DECODE_STEPS)])
        del rc
    for name, m in (("pp4", 4), ("pp2_tp2", 2)):
        mesh = meshes[name]
        local = pp.shard_params_pp(params, mesh, cfg)
        pcache = pp.shard_cache_pp(contiguous.KVCache(cache.k.clone(), cache.v.clone(), cache.lengths.clone()),
                                   mesh)
        step = pp.make_pp_decode_step(mesh, cfg, num_microbatches=m)
        stage_layers = n // mesh.axis("pipe").size
        last = mesh.axis("pipe").index == mesh.axis("pipe").size - 1
        reset_counts()
        h0 = comm.host_bytes
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PP_DECODE_STEPS):
            lg, pcache = step(local, pcache, streams[:, i], cos, sin)
            out.append(lg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PP_DECODE_STEPS
        per_step = stage_layers * m  # each layer of the stage on each microbatch
        r.counts(f"14d {name}", read_counts(), zero_counts(
            flash_decode=PP_DECODE_STEPS * per_step, flash_decode_append=PP_DECODE_STEPS * per_step,
            quant_matmul=PP_DECODE_STEPS * (4 * per_step + (m if last else 0))))
        r.rec[f"14d {name}"] = dict(step_ms=ms, host_bytes_per_step=(comm.host_bytes - h0) / PP_DECODE_STEPS)
        if ref is not None:
            r.check(f"14d {name} (M={m}) logits vs one process, {PP_DECODE_STEPS} steps", _rel(torch.stack(out), ref),
                    0.05)
        r.log(f"[tensor-parallel] 14d {name}, {m} microbatches: {ms:.1f} ms a decode step (host clock)")
        del local, pcache
        dist.barrier()
    del cache
    torch.cuda.empty_cache()
    # ---- 14b: Engine / PagedEngine on (data 2, model 2)
    mesh = meshes["dp2_tp2"]
    serve_prompts = _serving_prompts(cfg.vocab_size)[:TP_SERVE["requests"]]
    s = TP_SERVE
    kw = dict(num_slots=s["slots"], steps_per_round=s["steps"], prefill_chunk=s["chunk"], device=dev)
    runs = {"Engine": lambda m: Engine(params, cfg, mesh=m, **kw),
            "Engine spec_decode=4": lambda m: Engine(params, cfg, mesh=m, spec_decode=SPEC_DRAFTS,
                                                     spec_ngram=SPEC_NGRAM, **kw),
            "PagedEngine": lambda m: PagedEngine(params, cfg, mesh=m, page_size=PAGE_SIZE, **kw)}
    kinds = {"Engine": "contiguous", "Engine spec_decode=4": "spec", "PagedEngine": "paged"}
    one_process = {"Engine": lambda: Engine(params, cfg, **kw),
                   "PagedEngine": lambda: PagedEngine(params, cfg, page_size=PAGE_SIZE, **kw)}
    ones = {}
    for name, make in runs.items():
        h0 = comm.host_bytes
        eng, reqs, wall, counts = _serve(lambda: make(mesh), serve_prompts,
                                         _engine_counts(n, s["steps"], 0, kinds[name], 1),
                                         new_tokens=s["new_tokens"])
        r.rec.setdefault("counts", {})[f"14b {name}"] = counts
        streams_b = [q.output for q in reqs]
        r.rec[f"14b {name} streams"] = streams_b
        r.rec[f"14b {name}"] = dict(wall_s=wall, decode_tok_s=eng.stats.decode_tokens_per_s(),
                                    host_bytes=comm.host_bytes - h0, rounds=eng.stats.decode_rounds,
                                    spec_steps=eng.stats.spec_steps)
        r.log(f"[tensor-parallel] 14b {name} on (data 2, model 2): {len(reqs)} requests in {wall:.1f} s, "
              f"{eng.stats.decode_tokens_per_s():.1f} decode tokens/s, {eng.stats.decode_rounds} rounds, "
              f"{(comm.host_bytes - h0) / 2**20:.1f} MiB through the host (gloo); {eng.stats.summary()}")
        del eng
        dist.barrier()
        if r.rank == 0:
            base = "PagedEngine" if name == "PagedEngine" else "Engine"
            if base not in ones:
                _, one_reqs, _, _ = _serve(one_process[base], serve_prompts,
                                           _engine_counts(n, s["steps"], 0, kinds[base], 1),
                                           new_tokens=s["new_tokens"])
                ones[base] = [q.output for q in one_reqs]
            same = sum(a == c for a, c in zip(streams_b, ones[base]))
            r.log(f"[tensor-parallel] 14b {name}: streams equal one process's {base} {same}/{len(reqs)}")
            if same != len(reqs):
                _tie_check(f"14b {name}", params, cfg, serve_prompts, streams_b, dev, label="tensor-parallel")
        dist.barrier()
    _tp_multi_lora(r, mesh, cfg, params, serve_prompts, kw, dev)
    del params
    torch.cuda.empty_cache()


def _tp_multi_lora(r, mesh, cfg, params, prompts, kw, dev):
    """14g on this rank: (b)'s ``Engine`` and ``PagedEngine`` on (data 2,
    model 2) with phase 17's 4 adapters, the requests on adapters 0, 1, 2, 3
    and None in turn, against one process's multi-LoRA engines (rank 0):
    equal streams, or the tie check on the adapted decode route."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.models import lora as lora_lib
    from starflashattention_tpu_torch.parallel import comm
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    t0 = time.perf_counter()
    loras = _serving_adapters(cfg, dev)  # the same draw on every rank
    adapters = _request_adapters(len(prompts))
    s, n = TP_SERVE, cfg.num_layers
    makers = {"Engine": (Engine, {}, "contiguous"), "PagedEngine": (PagedEngine, dict(page_size=PAGE_SIZE), "paged")}
    for name, (cls, extra, kind) in makers.items():
        h0 = comm.host_bytes
        eng, reqs, wall, counts = _serve(lambda: cls(params, cfg, mesh=mesh, lora_adapters=loras, **extra, **kw),
                                         prompts, _engine_counts(n, s["steps"], 0, kind, 1),
                                         new_tokens=s["new_tokens"], adapters=adapters)
        r.rec.setdefault("counts", {})[f"14g {name}"] = counts
        streams = [q.output for q in reqs]
        r.rec[f"14g {name} streams"] = streams
        r.rec[f"14g {name}"] = dict(wall_s=wall, decode_tok_s=eng.stats.decode_tokens_per_s(),
                                    host_bytes=comm.host_bytes - h0, rounds=eng.stats.decode_rounds)
        r.log(f"[tensor-parallel] 14g multi-LoRA {name} on (data 2, model 2), {len(loras)} adapters of ranks "
              f"{LORA_RANKS}: {len(reqs)} requests in {wall:.1f} s, {eng.stats.decode_tokens_per_s():.1f} decode "
              f"tokens/s, {(comm.host_bytes - h0) / 2**20:.1f} MiB through the host (gloo); {eng.stats.summary()}")
        del eng
        torch.cuda.empty_cache()
        dist.barrier()
        if r.rank == 0:
            _, one_reqs, _, _ = _serve(lambda: cls(params, cfg, lora_adapters=loras, **extra, **kw), prompts,
                                       _engine_counts(n, s["steps"], 0, kind, 1), new_tokens=s["new_tokens"],
                                       adapters=adapters)
            same = sum(a == q.output for a, q in zip(streams, one_reqs))
            r.log(f"[tensor-parallel] 14g {name}: streams equal one process's multi-LoRA {name} {same}/{len(reqs)}")
            if same != len(reqs):
                _tie_check(f"14g {name}", params, cfg, prompts, streams, dev, label="tensor-parallel",
                           lora=lora_lib.stack_adapters(loras, device=dev), adapters=adapters)
        dist.barrier()
    del loras
    torch.cuda.empty_cache()
    r.log(f"[tensor-parallel] 14g: {time.perf_counter() - t0:.1f} s")


def _tp_logits(mesh, cfg, local, cache, prompts, lengths, streams):
    """TP prefill + 4 decode steps fed ``streams``' tokens -> (5, B, V)."""
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.parallel import make_tp_decode_step, make_tp_prefill

    cos, sin = llama.rope_tables(cfg, device=mesh.device)
    step = make_tp_decode_step(mesh, cfg)
    logits, cache = make_tp_prefill(mesh, cfg)(local, cache, prompts, lengths, cos, sin)
    out = [logits]
    for i in range(4):
        logits, cache = step(local, cache, streams[:, i], cos, sin)
        out.append(logits)
    return torch.stack(out)


def _one_logits(cfg, params, cache, prompts, lengths, streams):
    """:func:`_tp_logits` on one process."""
    from starflashattention_tpu_torch.models import llama

    cos, sin = llama.rope_tables(cfg, device=prompts.device)
    logits, cache = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
    out = [logits]
    for i in range(4):
        logits, cache = llama.decode_step(params, cache, streams[:, i], cos, sin, cfg)
        out.append(logits)
    return torch.stack(out)


def _row_scale_check(r, mesh, cfg, params, cache, prompts, lengths, what, entry):
    """The prefill of ``params`` (4 layers) with ``cfg.w8a8_prefill`` on
    TP 4 and on one process: logits within phase 4's tolerance; layer 0's
    ``wo`` row scales on every rank equal the one process's bit for bit;
    its ``w_down`` row scales equal (bit for bit) those of the full rows
    gathered from the ranks' shards, and are reported against the one
    process's (the input rows follow a sum over the axis in another
    order)."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.ops.quant_matmul import quantize_rows
    from starflashattention_tpu_torch.parallel import comm, make_tp_prefill, tp

    cos, sin = llama.rope_tables(cfg, device=mesh.device)
    local = tp.shard_params(params, mesh, cfg)
    local_cache = tp.shard_cache(cache, mesh)
    reset_counts()
    with _RowScales() as rec:
        logits, _ = make_tp_prefill(mesh, cfg)(local, local_cache, prompts, lengths, cos, sin)
    counts = read_counts()
    n = cfg.num_layers
    if counts[entry] != 4 * n:
        raise AssertionError(f"rank {r.rank}: {what}: {counts[entry]} {entry} launches, expected {4 * n}")
    r.rec.setdefault("counts", {})[f"14a {what} prefill"] = counts
    row_calls = [(x, rs) for axis, x, rs in rec.calls if axis]
    (_, wo_rs), (down_x, down_rs) = row_calls[0], row_calls[1]
    full_down = comm.all_gather(down_x, mesh.axis("model"), dim=-1)
    _, full_rs = quantize_rows(full_down)
    if not torch.equal(down_rs, full_rs):
        raise AssertionError(f"rank {r.rank}: {what}: layer 0's w_down row scales are not the full rows'")
    gathered = comm.all_gather(torch.cat([wo_rs, down_rs], dim=1)[None], mesh.axis("model"), dim=0)
    if not all(torch.equal(g, gathered[0]) for g in gathered):
        raise AssertionError(f"rank {r.rank}: {what}: the ranks' row scales differ")
    if r.rank == 0:
        with _RowScales() as one:
            ref, _ = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
        one_rs = [rs for _, _, rs in one.calls]  # wqkv, wo, w_gate_up, w_down of layer 0 first
        wo_equal = torch.equal(wo_rs, one_rs[1])
        down_rows = (down_rs == one_rs[3]).float().mean().item()
        r.log(f"[tensor-parallel] 14a {what} prefill, TP 4, {n} layers: layer 0's wo row scales equal one "
              f"process's bit for bit: {wo_equal}; w_down's equal the full rows' on every rank; the share of "
              f"w_down rows whose scale equals one process's {down_rows:.4f}; {counts[entry]} {entry} launches a "
              f"rank")
        if not wo_equal:
            raise AssertionError(f"{what}: layer 0's wo row scales differ from one process's")
        r.check(f"14a {what} prefill logits vs one process, {n} layers", _rel(logits, ref), 0.05)
    dist.barrier()


def _expert_parallel_path(r, meshes, dev):
    """14c: Mixtral-8x7B at full width cut to 2 layers, int8 experts and
    weights and lm_head, TP 4 (2 whole experts a rank): generate, the
    streams equal on every rank and tie-checked on one process."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.parallel import tp
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    cfg = ModelConfig.mixtral_8x7b(num_layers=2, max_seq_len=SLICE_SEQ, num_splits=1)
    mesh = meshes["tp4"]
    # one rank builds at a time (each expert stack's quantization passes through fp32), and only rank 0,
    # which runs the reference, keeps the whole model beside its shard
    params = local = None
    torch.cuda.empty_cache()
    for k in range(TP_WORLD):
        if r.rank == k:
            params, _ = build_model(cfg, dev)
            local = tp.shard_params(params, mesh, cfg)
            if r.rank:
                params = None
            torch.cuda.empty_cache()
        dist.barrier()
    prompts_l = _variant_prompts(cfg.vocab_size, 200, 600, seed=SEED + 4)
    lengths = torch.tensor([len(p) for p in prompts_l], dtype=torch.int32, device=dev)
    prompts = torch.zeros((len(prompts_l), int(lengths.max())), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts_l):
        prompts[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    e_local = cfg.num_experts // mesh.axis("model").size
    cache = tp.shard_cache(contiguous.init_cache(cfg.num_layers, len(prompts_l), cfg.num_kv_heads, cfg.max_seq_len,
                                                 cfg.head_dim, device=dev), mesh)
    steps = EP_NEW_TOKENS - 1
    rows = len(prompts_l) * prompts.shape[1]
    streams, pre_ms, step_ms, host = _tp_generate(r, "14c EP generate", mesh, cfg, local, cache, prompts, lengths,
                                                  steps, _decode_counts(cfg.num_layers, steps, 2 + 2 * e_local,
                                                                        rows))
    r.rec["14c streams"] = streams.tolist()
    r.rec["14c"] = dict(prefill_ms=pre_ms, step_ms=step_ms, host_bytes_per_step=host)
    r.log(f"[tensor-parallel] 14c mixtral_8x7b 2 of 32 layers, {e_local} of {cfg.num_experts} experts a rank: "
          f"prefill {pre_ms:.1f} ms, {step_ms:.1f} ms a decode step (host clock)")
    if r.rank == 0:
        _tie_check("14c EP streams", params, cfg, prompts_l, streams.tolist(), dev, label="tensor-parallel")
    dist.barrier()
    del params, local, cache
    torch.cuda.empty_cache()


def _dkdv_splits(b, hkv, g, s, d, dev):
    """1 if the dk/dv wrapper splits its walks at this causal self-attention
    shape on this card, else 0."""
    from starflashattention_tpu_torch.ops import flash_bwd

    bkv, bq, _ = flash_bwd.dkdv_geometry(d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int(flash_bwd.dkdv_split_plan(b, hkv, g, s, s, True, None, 0, sms, bkv, bq)[1] > 1)


def _tp_training_path(r, meshes, dev):
    """14e: TP x DP (data 2, model 2; B=2, S=2048) and TP x CP (model 2,
    seq 2; B=1, S=8192) training of 7B-GQA at full width cut to 2 layers
    (bf16): the first step's loss and every rank's gradients within 5e-2
    (of each gradient's peak) of one process's through the kernels, on the
    rank's shard, and 3 SGD steps at lr 1.0 lower the loss."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.models import llama, train
    from starflashattention_tpu_torch.ops import flash_bwd
    from starflashattention_tpu_torch.parallel import (comm, init_opt_state, make_tp_cp_train_step,
                                                       make_tp_dp_train_step, tp)
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    t = TP_TRAIN
    torch.cuda.empty_cache()
    cfg = ModelConfig.llama_7b_gqa(num_layers=t["layers"], max_seq_len=t["cp_seq"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)  # the same params and batches on every rank
    params = llama.init_params(cfg, gen, device=dev)
    cos, sin = llama.rope_tables(cfg, device=dev)
    n = cfg.num_layers
    for name, mesh_name, (b, s), make, want in (
            ("TP x DP", "dp2_tp2", (t["batch"], t["seq"]), make_tp_dp_train_step,
             zero_counts(flash_prefill=2 * n, flash_prefill_lse=2 * n, flash_bwd_dq=n, flash_bwd_dkdv=n)),
            ("TP x CP", "tp2_sp2", (1, t["cp_seq"]), make_tp_cp_train_step,
             _ring_counts(2, fwd_calls=2 * n, bwd_calls=n))):
        mesh = meshes[mesh_name]
        # the rank's attention shard: the model axis halves the heads, the data
        # or seq axis the batch or the sequence; where the dk/dv plan splits
        # its walks, every dk/dv launch of the step is a split one (counted
        # here alone: the other paths' counts leave the split out)
        size = mesh.shape
        want = dict(want, flash_bwd_dkdv_split=want["flash_bwd_dkdv"] * _dkdv_splits(
            b // size.get("data", 1), cfg.num_kv_heads // size["model"], cfg.num_q_heads // cfg.num_kv_heads,
            s // size.get("seq", 1), cfg.head_dim, dev))
        batch = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=dev)
        (loss_ref, grads_ref), ref_ms = _timed(lambda: train.loss_and_grads(params, batch, cfg, cos, sin))
        want_grads = train.tree_leaves(tp.shard_params(grads_ref, mesh, cfg))
        del grads_ref
        local = tp.shard_params(params, mesh, cfg)
        state = init_opt_state(local)
        step = make(mesh, cfg, TRAIN_LR)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, host = [], [], []
        for i in range(t["steps"]):
            reset_counts()
            flash_bwd.flash_bwd_dkdv.launches_split = 0
            h0 = comm.host_bytes
            (_, _, loss), ms = _timed(lambda: step(local, state, batch, cos, sin))
            losses.append(float(loss))
            step_ms.append(ms)
            host.append(comm.host_bytes - h0)
            r.counts(f"14e {name} step {i}",
                     dict(read_counts(), flash_bwd_dkdv_split=flash_bwd.flash_bwd_dkdv.launches_split), want)
            if i == 0:  # momentum from 0 after one step: the reduced gradients
                r.check(f"14e {name} first loss vs one process's", abs(losses[0] - float(loss_ref)),
                        TRAIN_GRAD_TOL, what="abs error")
                worst = max((_rel(g, gr), key) for (key, g), gr in zip(_named_leaves(state), want_grads))
                r.check(f"14e {name} every gradient vs one process's (worst: {worst[1]})", worst[0],
                        TRAIN_GRAD_TOL)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"rank {r.rank}: 14e {name}: the loss did not fall: {losses}")
        tokens = b * s
        r.rec[f"14e {name}"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms[-1] * 1e3,
                                    peak_gib=peak, host_bytes_per_step=host[-1], single_ms=ref_ms)
        r.log(f"[tensor-parallel] 14e {name}, 7B-GQA width, {n} layers, bf16, B={b} S={s}: losses {losses}; ms a "
              f"step {[round(x, 1) for x in step_ms]} (host clock); {tokens / step_ms[-1] * 1e3:.0f} tokens/s; peak "
              f"memory {peak:.1f} GiB on rank 0; {host[-1] / 2**30:.2f} GiB through the host a step by rank 0; one "
              f"process's loss and gradients {ref_ms:.1f} ms")
        del local, state, want_grads
        torch.cuda.empty_cache()
        dist.barrier()
    del params


def _moe_tp_training_path(r, meshes, dev):
    """14f: Mixtral-8x7B at full width cut to 2 layers (bf16), TP x DP
    training on the model-4 mesh (2 whole experts a rank; data axis of 1),
    B=2, S=2048: 3 SGD steps at lr 1.0 lower the loss; the first step's
    loss and every rank's gradients within 5e-2 (of each gradient's peak)
    of one process's through the kernels, cut to the rank's shard, that
    process pinned to the TP step's routing (:func:`_pinned_routes`). The
    ranks share the card's memory, so one rank at a time holds the whole
    model."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.models import llama, train
    from starflashattention_tpu_torch.ops import flash_bwd
    from starflashattention_tpu_torch.parallel import comm, init_opt_state, make_tp_dp_train_step, tp
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    t = TP_TRAIN
    b, s = t["batch"], t["seq"]
    cfg = ModelConfig.mixtral_8x7b(num_layers=t["layers"], max_seq_len=s)
    mesh, n = meshes["tp4"], cfg.num_layers
    cos, sin = llama.rope_tables(cfg, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=torch.Generator(device=dev).manual_seed(SEED + 19),
                          device=dev)

    def full_model():
        return llama.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 18), device=dev)

    torch.cuda.empty_cache()
    local = None
    for k in range(TP_WORLD):
        if r.rank == k:
            params = full_model()
            local = train.tree_map(torch.clone, tp.shard_params(params, mesh, cfg))
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    e_local = local["layers"]["moe_gate_up"].shape[1]
    want = zero_counts(flash_prefill=2 * n, flash_prefill_lse=2 * n, flash_bwd_dq=n, flash_bwd_dkdv=n)
    want["flash_bwd_dkdv_split"] = n * _dkdv_splits(b, cfg.num_kv_heads // mesh.axis("model").size,
                                                    cfg.num_q_heads // cfg.num_kv_heads, s, cfg.head_dim, dev)
    state = init_opt_state(local)
    step = make_tp_dp_train_step(mesh, cfg, TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, host = [], [], []
    for i in range(t["steps"]):
        reset_counts()
        flash_bwd.flash_bwd_dkdv.launches_split = 0
        h0 = comm.host_bytes
        with _recorded_routes(llama) as recorded:
            (_, _, loss), ms = _timed(lambda: step(local, state, batch, cos, sin))
        losses.append(float(loss))
        step_ms.append(ms)
        host.append(comm.host_bytes - h0)
        r.counts(f"14f MoE TP x DP step {i}",
                 dict(read_counts(), flash_bwd_dkdv_split=flash_bwd.flash_bwd_dkdv.launches_split), want)
        if i == 0:  # momentum from 0 after one step: the gradients
            routes, got = recorded, [(key, g.clone()) for key, g in _named_leaves(state)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del local, state
    torch.cuda.empty_cache()
    for k in range(TP_WORLD):  # one process's loss and gradients on the first step's routing, a rank at a time
        if r.rank == k:
            params = full_model()
            with _pinned_routes(llama, routes) as flips:
                (loss_ref, grads_ref), ref_ms = _timed(lambda: train.loss_and_grads(params, batch, cfg, cos, sin))
            want_grads = train.tree_leaves(tp.shard_params(grads_ref, mesh, cfg))
            loss_err = abs(losses[0] - float(loss_ref))
            worst = max((_rel(g, gr), key) for (key, g), gr in zip(got, want_grads))
            del params, grads_ref, want_grads, got
            torch.cuda.empty_cache()
        dist.barrier()
    r.check("14f MoE first loss vs one process's", loss_err, TRAIN_GRAD_TOL, what="abs error")
    r.check(f"14f MoE every gradient vs one process's (worst: {worst[1]})", worst[0], TRAIN_GRAD_TOL)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"rank {r.rank}: 14f MoE: the loss did not fall: {losses}")
    tokens = b * s
    r.rec["14f MoE TP x DP"] = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms[-1] * 1e3,
                                    peak_gib=peak, host_bytes_per_step=host[-1], single_ms=ref_ms,
                                    route_flips=max(flips))
    r.log(f"[tensor-parallel] 14f MoE TP x DP, Mixtral-8x7B width, {n} layers, {e_local} of {cfg.num_experts} experts "
          f"a rank, bf16, B={b} S={s}: losses {losses}; ms a step {[round(x, 1) for x in step_ms]} (host clock); "
          f"{tokens / step_ms[-1] * 1e3:.0f} tokens/s; peak memory {peak:.1f} GiB on rank 0; "
          f"{host[-1] / 2**30:.2f} GiB through the host a step by rank 0; one process's loss and gradients "
          f"{ref_ms:.1f} ms (rank 0's), pinned to the TP step's routing, where its own top "
          f"{cfg.num_experts_per_tok} would differ for a share of the tokens of "
          + ", ".join(f"{f:.4f}" for f in flips) + " (in call order)")
    dist.barrier()


def _tensor_parallel_rank(rank, world, port, out_dir):
    """One rank of phase 14: joins the gloo world on this card, runs
    14a-14g and writes its record to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    from starflashattention_tpu_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(f"tcp://localhost:{port}", backend="gloo", world_size=world, rank=rank)
    meshes = {name: make_mesh(axes, device=dev) for name, axes in TP_MESHES.items()}
    r = _Rank(rank, "tensor-parallel")
    for name, fn in (("14a-b-d-g", lambda: _tp_dense_paths(r, meshes, dev)),
                     ("14c", lambda: _expert_parallel_path(r, meshes, dev)),
                     ("14e", lambda: _tp_training_path(r, meshes, dev)),
                     ("14f", lambda: _moe_tp_training_path(r, meshes, dev))):
        t0 = time.perf_counter()
        fn()
        r.rec.setdefault("seconds", {})[name] = time.perf_counter() - t0
        r.log(f"[tensor-parallel] {name}: {time.perf_counter() - t0:.1f} s")
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(r.rec, f)
    dist.destroy_process_group()


def phase_tensor_parallel(smi):
    """Phase 14 (see the module doc): TP_WORLD ranks on this one card over
    gloo, spawned after phase 1's build. Returns the ranks' records."""
    import torch.multiprocessing as mp

    from starflashattention_tpu_torch.ops._build import BUILD_DIR

    torch.cuda.empty_cache()
    out_dir = BUILD_DIR / "phase14"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    mp.spawn(_tensor_parallel_rank, args=(TP_WORLD, _free_port(), str(out_dir)), nprocs=TP_WORLD, join=True)
    recs = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]
    secs = time.perf_counter() - t0
    for key in [k for k in recs[0] if k.endswith("streams")]:
        if any(rec[key] != recs[0][key] for rec in recs):
            raise AssertionError(f"phase 14: {key} differ between ranks")
    log(f"[tensor-parallel] every rank's streams equal bit for bit: "
        f"{', '.join(k for k in recs[0] if k.endswith('streams'))}")
    worst = {}
    for rec in recs:
        for name, (err, tol) in rec.get("checks", {}).items():
            worst[name] = max(worst.get(name, (0.0, tol)), (err, tol))
    for name, (err, tol) in worst.items():
        log(f"[tensor-parallel] worst of the ranks: {name}: {err:.3e} (tolerance {tol:.3e})")
    totals = {}
    for rec in recs:
        for counts in rec["counts"].values():
            for key, n in counts.items():
                totals[key] = totals.get(key, 0) + n
    log(f"[tensor-parallel] launches over the {TP_WORLD} ranks' counted runs: "
        + ", ".join(f"{k} {v}" for k, v in totals.items() if v))
    for key in [k for k in recs[0] if k.startswith("14") and not k.endswith("streams")]:
        log(f"[tensor-parallel] {key} by rank: " + "; ".join(
            ", ".join(f"{f} {round(v, 2) if isinstance(v, float) else v}" for f, v in rec[key].items()
                      if not isinstance(v, list)) for rec in recs))
    log(f"[tensor-parallel] phase 14 took {secs:.1f} s ({smi}; the ranks' seconds: "
        f"{[{k: round(v, 1) for k, v in rec['seconds'].items()} for rec in recs]}); gloo copies every "
        "collective through the host, so these wall times are no guide to NCCL")
    return dict(records=recs, totals=totals, seconds=secs)


# ---------------------------------------------------------------- phase 15

CKPT_FAMILY_LAYERS = 2  # (b)'s depth
CKPT_SEQ = 1024  # (b)'s max_seq_len
# Phi-3's longrope (su) scaling at Phi-3-medium-128k's positions, 64 factors
# a list (made up here: only the route matters)
PHI3_LONGROPE = ("longrope", 4096, 131072, tuple(1.0 + 0.01 * i for i in range(64)),
                 tuple(1.0 + 0.5 * i for i in range(64)))
# (b)'s presets: (overrides, HF names with Phi-3's fused projections)
CKPT_FAMILIES = {"qwen2_7b": ({}, False), "phi3_medium": (dict(rope_scaling=PHI3_LONGROPE), True),
                 "gemma2_9b": ({}, False), "mixtral_8x7b": ({}, False), "deepseek_v2_lite": ({}, False)}


def _perturbed_norms(params, gen):
    """Every norm weight of ``params`` set in place to 1 + 0.1 N(0, 1),
    within [0.6, 1.4], so that each norm's route shows in the bits (and
    Gemma's w - 1 is exact in fp32)."""
    for tree in (params, params["layers"]):
        for name, w in tree.items():
            if name.endswith("norm"):
                noise = torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)
                w.copy_((1.0 + 0.1 * noise).clamp(0.6, 1.4))


def _zero_dense_first_experts(params, cfg):
    """DeepSeek's dense first layers never select an expert; HF stores no
    expert weights for them and the loader leaves those slices zero, so the
    source tree zeroes them too."""
    for name in ("moe_router", "moe_gate_up", "moe_down", "moe_shared_gate_up", "moe_shared_down"):
        if cfg.num_experts and name in params["layers"]:
            params["layers"][name][:cfg.first_k_dense].zero_()


def _hf_state(params, cfg, fused=False):
    """The HF state dict a checkpoint of ``cfg``'s family holds, made of
    (out, in) views of ``params`` (the inverse of
    ``models/checkpoint.load_hf_state_dict``): Llama-family names, Qwen2's
    biases, Phi-3's fused ``qkv_proj`` / ``gate_up_proj`` (``fused``),
    Gemma's norms as w - 1 in fp32 and Gemma-2's four norms, Mixtral's
    ``block_sparse_moe`` experts, DeepSeek's MLA (``kv_b_proj`` built from
    W_uk and W_uv), experts, shared experts and dense first layers."""
    lay, sd = params["layers"], {"model.embed_tokens.weight": params["embed"]}
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim

    def norm(w):
        return w.float() - 1.0 if cfg.norm_plus_one else w

    def gate_up(prefix, w, names=("gate_proj", "up_proj")):
        g, u = w.chunk(2, dim=-1)
        sd[prefix + f"{names[0]}.weight"], sd[prefix + f"{names[1]}.weight"] = g.T, u.T

    sd["model.norm.weight"] = norm(params["final_norm"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = params["lm_head"].T
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sa = p + "self_attn."
        if cfg.mla:
            if cfg.q_lora_rank is not None:
                sd[sa + "q_a_proj.weight"], sd[sa + "q_b_proj.weight"] = lay["mla_wq_a"][i].T, lay["mla_wq_b"][i].T
                sd[sa + "q_a_layernorm.weight"] = lay["mla_q_a_norm"][i]
            else:
                sd[sa + "q_proj.weight"] = lay["mla_wq"][i].T
            sd[sa + "kv_a_proj_with_mqa.weight"] = lay["mla_wkv_a"][i].T
            sd[sa + "kv_a_layernorm.weight"] = lay["mla_kv_a_norm"][i]
            sd[sa + "kv_b_proj.weight"] = torch.cat([lay["mla_wuk"][i], lay["mla_wuv"][i].transpose(1, 2)],
                                                    dim=1).reshape(-1, cfg.kv_lora_rank)
        elif fused:
            sd[sa + "qkv_proj.weight"] = lay["wqkv"][i].T
        else:
            for n, w in zip("qkv", lay["wqkv"][i].split([hq * d, hkv * d, hkv * d], dim=1)):
                sd[sa + f"{n}_proj.weight"] = w.T
        if cfg.attention_bias:
            for n, b in zip("qkv", lay["bqkv"][i].split([hq * d, hkv * d, hkv * d])):
                sd[sa + f"{n}_proj.bias"] = b
        if cfg.qk_norm:
            sd[sa + "q_norm.weight"], sd[sa + "k_norm.weight"] = lay["q_norm"][i], lay["k_norm"][i]
        sd[sa + "o_proj.weight"] = lay["wo"][i].T
        if cfg.num_experts and i < cfg.first_k_dense:
            gate_up(p + "mlp.", lay["dense_mlp"]["w_gate_up"][i])
            sd[p + "mlp.down_proj.weight"] = lay["dense_mlp"]["w_down"][i].T
        elif cfg.num_experts:
            deepseek = cfg.mla
            sd[p + ("mlp.gate.weight" if deepseek else "block_sparse_moe.gate.weight")] = lay["moe_router"][i].T
            for e in range(cfg.num_experts):
                ep = p + (f"mlp.experts.{e}." if deepseek else f"block_sparse_moe.experts.{e}.")
                gate_up(ep, lay["moe_gate_up"][i, e], ("gate_proj", "up_proj") if deepseek else ("w1", "w3"))
                sd[ep + ("down_proj.weight" if deepseek else "w2.weight")] = lay["moe_down"][i, e].T
            if cfg.n_shared_experts:
                gate_up(p + "mlp.shared_experts.", lay["moe_shared_gate_up"][i])
                sd[p + "mlp.shared_experts.down_proj.weight"] = lay["moe_shared_down"][i].T
        elif fused:
            sd[p + "mlp.gate_up_proj.weight"] = lay["w_gate_up"][i].T
            sd[p + "mlp.down_proj.weight"] = lay["w_down"][i].T
        else:
            gate_up(p + "mlp.", lay["w_gate_up"][i])
            sd[p + "mlp.down_proj.weight"] = lay["w_down"][i].T
        sd[p + "input_layernorm.weight"] = norm(lay["attn_norm"][i])
        if cfg.post_norms:
            sd[p + "post_attention_layernorm.weight"] = norm(lay["post_attn_norm"][i])
            sd[p + "pre_feedforward_layernorm.weight"] = norm(lay["mlp_norm"][i])
            sd[p + "post_feedforward_layernorm.weight"] = norm(lay["post_mlp_norm"][i])
        else:
            sd[p + "post_attention_layernorm.weight"] = norm(lay["mlp_norm"][i])
    return sd


def _same_tree(tag, got, want):
    """Every leaf of ``got`` bit for bit ``want``'s (same names, dtypes and
    shapes); raises at the first that differs."""
    a, b = dict(_named_leaves(got)), dict(_named_leaves(want))
    if sorted(a) != sorted(b):
        raise AssertionError(f"[checkpoint] {tag}: leaves {sorted(a)} != {sorted(b)}")
    for name in a:
        if not _bit_equal(a[name], b[name]):
            raise AssertionError(f"[checkpoint] {tag}: {name} differs from the source tree")
    log(f"[checkpoint] {tag}: {len(a)} leaves, {_param_bytes(got) / 1e9:.3f} GB, bit for bit the source tree")


def _timed_step(secs, name, fn):
    """fn's result, its host-clock seconds stored as ``secs[name]``."""
    out, ms = _timed(fn)
    secs[name] = ms / 1e3
    return out


def _converted(tag, cfg, dev, gen, fused=False):
    """A seeded dense bf16 tree of ``cfg`` on the card (norms perturbed),
    its HF state dict, and ``load_hf_state_dict`` of it held bit for bit to
    the tree: (source, converted, seconds)."""
    from starflashattention_tpu_torch.models import checkpoint, llama

    secs = {}
    src = _timed_step(secs, "init", lambda: llama.init_params(cfg, gen, device=dev))
    _perturbed_norms(src, gen)
    _zero_dense_first_experts(src, cfg)
    state = _hf_state(src, cfg, fused)
    got = _timed_step(secs, "convert", lambda: checkpoint.load_hf_state_dict(state, cfg, device=dev))
    del state
    _same_tree(f"{tag} load_hf_state_dict", got, src)
    return src, got, secs


def _checkpoint_7b(dev):
    """(a): 7B-GQA at full depth through the HF conversion, int8, greedy
    streams, the native save and load."""
    from starflashattention_tpu_torch.models import checkpoint, llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src, got, secs = _converted("7B-GQA", cfg, dev, gen)
    quantize = lambda tree: llama.quantize_model_weights(tree, "int8", lm_head=True, consume=True)  # noqa: E731
    qsrc = _timed_step(secs, "quantize source", lambda: quantize(src))
    qgot = _timed_step(secs, "quantize converted", lambda: quantize(got))
    del src, got
    _same_tree("7B-GQA int8", qgot, qsrc)
    prompts, lengths = _prompts(cfg, dev, gen)
    expected = slice_counts(cfg.num_layers)
    toks = {}
    for name, tree in (("source", qsrc), ("converted", qgot)):
        toks[name], _ = run_generate(tree, cfg, prompts, lengths, dev, expected, f"checkpoint 7B-GQA {name}")
    del qsrc
    with tempfile.TemporaryDirectory() as tmp:
        _timed_step(secs, "save", lambda: checkpoint.save_checkpoint(tmp, qgot, cfg))
        written = sum(f.stat().st_size for f in Path(tmp).iterdir())
        cfg2, back = _timed_step(secs, "load", lambda: checkpoint.load_checkpoint(tmp, device=dev))
    if cfg2 != cfg or hash(cfg2) != hash(cfg):
        raise AssertionError("[checkpoint] the restored config differs from the saved one")
    _same_tree("7B-GQA int8 load_checkpoint", back, qgot)
    del qgot
    toks["restored"], _ = run_generate(back, cfg2, prompts, lengths, dev, expected, "checkpoint 7B-GQA restored")
    digests = {name: stream_digest(t) for name, t in toks.items()}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"[checkpoint] 7B-GQA streams differ: {digests}")
    del back
    log(f"[checkpoint] 7B-GQA L={cfg.num_layers}: streams equal by digest {digests['source']} "
        f"(source, converted, restored); {written / 1e9:.3f} GB written by save_checkpoint")
    return dict(seconds=secs, bytes_written=written, digest=digests["source"])


def _checkpoint_family(name, dev):
    """(b): one preset at published widths and CKPT_FAMILY_LAYERS layers
    through its HF route, int8, and greedy streams equal by digest."""
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    overrides, fused = CKPT_FAMILIES[name]
    cfg = getattr(ModelConfig, name)(num_layers=CKPT_FAMILY_LAYERS, max_seq_len=CKPT_SEQ, **overrides)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src, got, secs = _converted(name, cfg, dev, gen, fused)
    qsrc = llama.quantize_model_weights(src, "int8", lm_head=True, consume=True)
    qgot = llama.quantize_model_weights(got, "int8", lm_head=True, consume=True)
    del src, got
    _same_tree(f"{name} int8", qgot, qsrc)
    prompts, lengths = _prompts(cfg, dev, gen)
    runs = {}
    for tag, tree in (("source", qsrc), ("converted", qgot)):
        torch.cuda.synchronize()
        reset_counts()
        toks = llama.generate(tree, cfg, prompts, lengths, SLICE_NEW_TOKENS, device=dev)
        torch.cuda.synchronize()
        runs[tag] = (stream_digest(toks), {k: v for k, v in read_counts().items() if v})
    counts = runs["source"][1]
    if runs["converted"] != runs["source"] or not all(counts.get(k) for k in ("flash_prefill", "flash_decode")):
        raise AssertionError(f"[checkpoint] {name}: {runs}")
    log(f"[checkpoint] {name} L={cfg.num_layers} H={cfg.hidden_size} V={cfg.vocab_size}: streams equal by "
        f"digest {runs['source'][0]}; launches {counts}")
    return dict(seconds=secs, digest=runs["source"][0])


def phase_checkpoint(dev, smi):
    """Phase 15 (see the module doc). Returns the seconds, bytes and peak
    memory of each part."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"7b": _checkpoint_7b(dev)}
    peak = {"7b": torch.cuda.max_memory_allocated() / 2**30}
    for name in CKPT_FAMILIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[name] = _checkpoint_family(name, dev)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    for name, rec in out.items():
        log(f"[checkpoint] {name}: " + ", ".join(f"{k} {v:.2f} s" for k, v in rec["seconds"].items())
            + f"; peak {peak[name]:.1f} GiB ({smi})")
    log(f"[checkpoint] phase 15 took {time.perf_counter() - t0:.1f} s")
    return dict(out, peak_gib=peak)


# ---------------------------------------------------------------- phase 16

MOE_TRAIN_LAYERS = 2  # (a)-(d): published widths, depth cut to 2 layers
MOE_CHECK_LENGTHS = (TRAIN_SEQ, 1536)  # (c)'s two prompts
# Qwen3-30B-A3B's published config.json, the fields config_from_hf reads
# (written here: nothing is downloaded)
QWEN3_30B_A3B = dict(model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                     moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
                     head_dim=128, num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
                     decoder_sparse_step=1, mlp_only_layers=[], hidden_act="silu", rms_norm_eps=1e-6,
                     rope_theta=1e6, rope_scaling=None, max_position_embeddings=40960, tie_word_embeddings=False,
                     attention_bias=False, sliding_window=None, use_sliding_window=False)
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _moe_trace_split(prof, n_local):
    """One traced MoE step's device ms by part (phase 9's kinds by kernel
    name), with the expert products apart: the GEMMs whose two operands are
    stacks over the expert axis, forward and backward (each launch charged
    to the op that issued it; None where the trace carries no shapes)."""
    split = _device_split(_kernel_times(prof))
    expert = None
    for evt in prof.events():
        shapes = getattr(evt, "input_shapes", None)
        if evt.name not in GEMM_OPS or not shapes or not getattr(evt, "kernels", None):
            continue
        if len(shapes) >= 2 and all(len(s) == 3 and s[0] == n_local for s in shapes[:2]):
            expert = (expert or 0.0) + sum(k.duration for k in evt.kernels) / 1e3
    out = {"expert matmuls": expert, "other matmuls": None if expert is None else split["matmuls"] - expert,
           "attention forward": split["attention forward"], "attention backward": split["attention backward"],
           "routing and glue": split["other"]}
    return out, sum(split.values())


def _expert_grads_nonzero(tag, grads, cfg):
    """Every expert of every layer and every layer's router got a gradient."""
    layers = grads["layers"]
    dead = [(name, i, e) for name in ("moe_gate_up", "moe_down") for i in range(cfg.num_layers)
            for e in range(layers[name].shape[1]) if not bool(layers[name][i, e].abs().amax() > 0)]
    dead += [("moe_router", i, None) for i in range(cfg.num_layers) if not bool(layers["moe_router"][i].abs().amax() > 0)]
    if dead:
        raise AssertionError(f"[moe-train] {tag}: zero gradients at {dead[:8]} ({len(dead)} in all)")


def _moe_steps(tag, cfg, params, batch, cos, sin, smi, steps=TRAIN_STEPS):
    """``steps`` SGD steps (lr TRAIN_LR, remat) with the launch counts of
    each, the experts' and routers' gradients (the momentum after the first
    step from 0), then one step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from starflashattention_tpu_torch.models import train

    momentum = train.tree_map(torch.zeros_like, params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = [], [], {}
    for i in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, TRAIN_LR)
        losses.append(float(loss))  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _train_counts_ok(read_counts(), cfg.num_layers)
        counts = {k: counts.get(k, 0) + v for k, v in read_counts().items()}
        if i == 0:
            _expert_grads_nonzero(tag, momentum, cfg)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = batch.shape[0] * (batch.shape[1] - 1)
    log(f"[moe-train] {tag}: losses {losses}; ms a step {[round(t, 1) for t in step_ms]} (host clock; the first "
        f"includes allocation); {tokens / step_ms[-1] * 1e3:.0f} tokens/s at the last step; peak memory {peak:.1f} "
        f"GiB; launches a step as expected ({2 * cfg.num_layers} K5 with the LSE, {cfg.num_layers} dq, "
        f"{cfg.num_layers} dk/dv, nothing else); every expert and router got a gradient ({smi})")
    if not all(np.isfinite(losses)) or (steps > 1 and not losses[-1] < losses[0]):
        raise AssertionError(f"[moe-train] {tag}: the loss did not fall: {losses}")
    rec = dict(losses=losses, step_ms=step_ms, tokens_per_s=tokens / step_ms[-1] * 1e3, peak_gib=peak,
               counts=counts)
    if steps > 1:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            t0 = time.perf_counter()
            params, momentum, loss = train.train_step(params, momentum, batch, cfg, cos, sin, TRAIN_LR)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        split, busy = _moe_trace_split(prof, params["layers"]["moe_gate_up"].shape[1])
        del prof
        if busy == 0:
            log(f"[moe-train] {tag}: the profiler saw no device time; the device split is not measured")
        else:
            log(f"[moe-train] {tag}: one step under torch.profiler: {wall_ms:.1f} ms wall, device busy {busy:.1f} "
                f"ms, idle share {1 - busy / wall_ms:.3f}; device ms: "
                + ", ".join(f"{k} {'not measured' if v is None else f'{v:.1f}'}" for k, v in split.items())
                + f" ({smi})")
        rec.update(profile=split, busy_ms=busy, profile_wall_ms=wall_ms)
    del momentum
    torch.cuda.empty_cache()
    return params, rec


def _moe_grads_vs_plain(tag, cfg, params, batch, cos, sin):
    """(b): every gradient at B=1 through the kernels against plain
    attention's, within TRAIN_GRAD_TOL of each gradient's peak, the plain
    route pinned to the kernels' routing (:func:`_pinned_routes`)."""
    from starflashattention_tpu_torch.models import llama, train

    reset_counts()
    with _recorded_routes(llama) as routes:
        l_k, g_k = train.loss_and_grads(params, batch[:1], cfg, cos, sin, use_flash=True)
    _train_counts_ok(read_counts(), cfg.num_layers)
    with _pinned_routes(llama, routes) as flips:
        l_p, g_p = train.loss_and_grads(params, batch[:1], cfg, cos, sin, use_flash=False)
    worst = ("", 0.0)
    for (name, a), b in zip(_named_leaves(g_k), train.tree_leaves(g_p)):
        worst = max(worst, (name, _rel(a, b)), key=lambda x: x[1])
    router = max(_rel(a, b) for a, b in zip(g_k["layers"]["moe_router"], g_p["layers"]["moe_router"]))
    log(f"[moe-train] {tag}, B=1, S={batch.shape[1] - 1}: loss through the kernels {float(l_k):.6f}, plain attention "
        f"{float(l_p):.6f}; the routers' gradients {router:.3e} of their peaks apart; plain attention pinned to the "
        f"kernels' routing, where its own top {cfg.num_experts_per_tok} would differ for a share of the tokens of "
        + ", ".join(f"{f:.4f}" for f in flips) + " (in call order: each layer's forward, then the remat reruns "
        "from the last layer)")
    _check(f"{tag}: gradients through the kernels against plain attention, worst leaf {worst[0]} (max abs error "
           "over its peak)", worst[1], TRAIN_GRAD_TOL)
    del g_k, g_p
    torch.cuda.empty_cache()
    return dict(worst_leaf=worst[0], worst_rel=worst[1], router_rel=router, flips=flips)


@contextlib.contextmanager
def _recorded_routes(llama):
    """Every ``llama._top_k`` call's indices, in call order: the training
    MoE and the serving router both take their top k through it."""
    calls, top_k = [], llama._top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        calls.append(idx.clone())
        return vals, idx

    llama._top_k = recording
    try:
        yield calls
    finally:
        llama._top_k = top_k


def _same_experts(a, b):
    """Per token (row of the flattened leading dims): whether two top-k
    index tensors pick the same set of experts."""
    k = a.shape[-1]
    return (a.reshape(-1, k).sort(dim=-1).values == b.reshape(-1, k).sort(dim=-1).values).all(dim=-1)


@contextlib.contextmanager
def _pinned_routes(llama, routes):
    """``llama._top_k`` replaying ``routes`` (recorded by
    :func:`_recorded_routes` on a run of the same calls) in call order: each
    call takes the recorded experts, their values gathered from its own
    logits (so the gradient reaches the router as through the top k), and
    logs the share of tokens whose own top k would have picked other
    experts. Two routes that differ by rounding may flip a token whose
    k-th and (k+1)-th logits nearly tie; pinned, they compare the same
    function."""
    flips, top_k, it = [], llama._top_k, iter(routes)

    def pinned(x, k):
        idx = next(it)
        if idx.shape != x.shape[:-1] + (k,):
            raise AssertionError(f"a pinned route of shape {tuple(idx.shape)} for logits {tuple(x.shape)}")
        flips.append(1.0 - _same_experts(top_k(x, k)[1], idx).float().mean().item())
        return x.gather(-1, idx), idx

    llama._top_k = pinned
    try:
        yield flips
    finally:
        llama._top_k = top_k
    if len(flips) != len(routes):
        raise AssertionError(f"{len(flips)} routings replayed of {len(routes)} recorded")


def _moe_vs_prefill(tag, cfg, params, dev, gen, cos, sin):
    """(c): forward_train's logits at each prompt's last position against
    the serving ``llama.prefill`` of the same bf16 tree (fp32 projections,
    the dense MoE in fp32), within 5% of the largest logit; the share of
    tokens whose top-k experts agree between the two routes."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama, train

    lengths = torch.tensor(MOE_CHECK_LENGTHS, dtype=torch.int32, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (len(MOE_CHECK_LENGTHS), max(MOE_CHECK_LENGTHS)), generator=gen,
                            device=dev, dtype=torch.int32)
    rows = torch.arange(len(MOE_CHECK_LENGTHS), device=dev), lengths.long() - 1
    valid = (torch.arange(prompts.shape[1], device=dev)[None, :] < lengths[:, None]).reshape(-1)
    with torch.no_grad():
        with _recorded_routes(llama) as train_routes:
            want = train.forward_train(params, prompts, cfg, cos, sin, remat=False)[rows]
        cache = contiguous.init_cache(cfg.num_layers, len(MOE_CHECK_LENGTHS), cfg.num_kv_heads, cfg.max_seq_len,
                                      cfg.head_dim, device=dev)
        with _recorded_routes(llama) as serve_routes:
            got, _ = llama.prefill(params, cache, prompts, lengths, cos, sin, cfg)
        del cache
    if len(train_routes) != cfg.num_layers or len(serve_routes) != cfg.num_layers:
        raise AssertionError(f"[moe-train] {tag}: {len(train_routes)} / {len(serve_routes)} routings recorded, "
                             f"not {cfg.num_layers}")
    agree = [_same_experts(a, b)[valid].float().mean().item() for a, b in zip(train_routes, serve_routes)]
    err, peak = (got - want).abs().max().item(), want.abs().max().item()
    log(f"[moe-train] {tag}: prompts of {list(MOE_CHECK_LENGTHS)} tokens; tokens whose top-{cfg.num_experts_per_tok} "
        f"experts agree between forward_train (bf16 projections) and the serving prefill (fp32), by layer: "
        + ", ".join(f"{a:.4f}" for a in agree))
    _check(f"{tag}: serving prefill logits against forward_train at the last positions (max |logit| {peak:.2f})",
           err, 0.05 * peak)
    return dict(logit_err=err, logit_peak=peak, route_agreement=agree)


def _qwen3_moe_config():
    """Qwen3-30B-A3B's geometry through ``checkpoint.config_from_hf``, cut
    to MOE_TRAIN_LAYERS layers."""
    import types

    from starflashattention_tpu_torch.models import checkpoint

    cfg = checkpoint.config_from_hf(types.SimpleNamespace(**QWEN3_30B_A3B))
    return dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)


def phase_moe_training(dev, smi):
    """Phase 16 (see the module doc): MoE training at Mixtral-8x7B's and
    Qwen3-30B-A3B's published widths, 2 layers each."""
    from starflashattention_tpu_torch.models import llama, train
    from starflashattention_tpu_torch.runtime.params import ModelConfig

    out, secs = {}, {}
    t_phase = time.perf_counter()
    for key, make in (("mixtral", lambda: ModelConfig.mixtral_8x7b(num_layers=MOE_TRAIN_LAYERS,
                                                                   max_seq_len=TRAIN_SEQ)),
                      ("qwen3", _qwen3_moe_config)):
        t0 = time.perf_counter()
        cfg = make()
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        params = llama.init_params(cfg, gen, device=dev)
        batch = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen, device=dev)
        cos, sin = llama.rope_tables(cfg, device=dev)
        torch.cuda.synchronize()
        name = "Mixtral-8x7B" if key == "mixtral" else "Qwen3-30B-A3B"
        n_params = sum(p.numel() for p in train.tree_leaves(params))
        log(f"[moe-train] {name} at published widths cut to {cfg.num_layers} layers: hidden {cfg.hidden_size}, "
            f"{cfg.num_q_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, {cfg.num_experts} experts top "
            f"{cfg.num_experts_per_tok} of {cfg.intermediate_size}, vocab {cfg.vocab_size}, qk_norm {cfg.qk_norm}; "
            f"{n_params / 1e9:.3f} B parameters bf16, seeded random init, batch ({TRAIN_BATCH}, {TRAIN_SEQ + 1}); "
            f"built in {time.perf_counter() - t0:.1f} s")
        tag = "16a" if key == "mixtral" else "16d"
        params, out[key] = _moe_steps(f"{tag} {name}", cfg, params, batch, cos, sin, smi,
                                      steps=TRAIN_STEPS if key == "mixtral" else 1)
        secs[tag] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[key]["grads"] = _moe_grads_vs_plain(f"16b {name}", cfg, params, batch, cos, sin)
        secs[f"16b {name}"] = time.perf_counter() - t0
        if key == "mixtral":
            t0 = time.perf_counter()
            out[key]["prefill"] = _moe_vs_prefill(f"16c {name}", cfg, params, dev, gen, cos, sin)
            secs["16c"] = time.perf_counter() - t0
        del params, batch
        torch.cuda.empty_cache()
    log(f"[moe-train] phase 16 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + f" ({smi})")
    return dict(out, seconds=secs)


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 17

LORA_RANKS = (8, 16, 32, 64)  # S-LoRA's range of serving ranks; unequal, so the stack pads to 64
# b's seeded draw: with a ~ N(0, 1/in) and scale 2, a delta is about 2 * LORA_B_STD * sqrt(r) of a unit
# projection output, 0.11 at rank 8 and 0.32 at rank 64: enough that every adapter changes most streams
LORA_B_STD = 0.02
LORA_ADAPTERS = (0, 1, 2, 3, None)  # request i's adapter LORA_ADAPTERS[i % 5]: every batch mixes them
LORA_SEED = SEED + 17  # the adapters' own generator
LORA_CHECK_LAYERS = 4  # (c)'s depth


def _serving_adapters(cfg, dev):
    """The 4 fp32 adapters of ranks ``LORA_RANKS`` on all four projections
    of ``cfg``: ``init_lora``'s ``a`` and a seeded ``b``, from one generator
    on the card seeded with ``LORA_SEED`` (every rank of phase 14 draws the
    same)."""
    from starflashattention_tpu_torch.models import lora

    gen = torch.Generator(device=dev).manual_seed(LORA_SEED)
    loras = []
    for rank in LORA_RANKS:
        lr = lora.init_lora(cfg, gen, rank=rank, device=dev)
        for ab in lr["layers"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=dev) * LORA_B_STD
        loras.append(lr)
    return loras


def _request_adapters(n):
    return [LORA_ADAPTERS[i % len(LORA_ADAPTERS)] for i in range(n)]


def _audit_prefix(eng):
    """Record, in the paged engine's prefix store, the adapter each page was
    published under, and check each hit's pages against the requester's
    adapter: -> {"hits": {adapter: hits}, "cross": pages matched across
    adapters}."""
    store, audit, owner = eng._prefix, {"hits": {}, "cross": 0}, {}
    insert, match = store.insert, store.match

    def audited_insert(tokens, n_cached, pages, adapter=-1):
        adopted = insert(tokens, n_cached, pages, adapter)
        owner.update({p: adapter for p in adopted})
        return adopted

    def audited_match(tokens, adapter=-1):
        pages, n = match(tokens, adapter)
        if pages:
            audit["hits"][adapter] = audit["hits"].get(adapter, 0) + 1
            audit["cross"] += sum(owner.get(p) != adapter for p in pages)
        return pages, n

    store.insert, store.match = audited_insert, audited_match
    return audit


def _lora_round_trace(params, cfg, prompts, stack, dev):
    """One decode round (``SERVE_STEPS`` steps, ``decode_multi``) of the
    first ``SERVE_SLOTS`` requests after their prefill, under torch.profiler,
    without and then with the adapters (each row on its phase adapter): the
    two ``_traced_steps`` records."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.models import lora as lora_lib

    b = SERVE_SLOTS
    plens = torch.tensor([len(p) for p in prompts[:b]], dtype=torch.int32, device=dev)
    padded = torch.zeros((b, int(plens.max())), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts[:b]):
        padded[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    cos, sin = llama.rope_tables(cfg, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    sel = lora_lib.adapter_onehot([-1 if a is None else a for a in _request_adapters(b)],
                                  lora_lib.num_adapters(stack), device=dev)
    traced = {}
    for key, ad in (("base", {}), ("adapters", dict(lora=stack, lora_sel=sel))):
        hkv, d = cfg.kv_cache_dims()
        cache = contiguous.init_cache(cfg.num_layers, b, hkv, cfg.max_seq_len, d, device=dev)
        logits, cache = llama.prefill(params, cache, padded, plens, cos, sin, cfg, **ad)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        llama.decode_multi(params, cache, tok, cos, sin, active, cfg, 1, **ad)  # warm-up
        traced[key] = _traced_steps(
            "multi-lora", f"decode round {'with' if ad else 'without'} the adapters (decode_multi, B={b})",
            lambda: llama.decode_multi(params, cache, tok, cos, sin, active, cfg, SERVE_STEPS, **ad), SERVE_STEPS)
        del cache
    base, with_ad = traced["base"], traced["adapters"]
    if base and with_ad:
        extra = {name: (ms - base["kernels"].get(name, (0.0, 0.0))[0], n - base["kernels"].get(name, (0.0, 0.0))[1])
                 for name, (ms, n) in with_ad["kernels"].items()}
        log(f"[multi-lora] the adapters' deltas a decode step: {with_ad['launches'] - base['launches']:.2f} more "
            f"launches ({base['launches']:.2f} -> {with_ad['launches']:.2f}), {with_ad['busy_ms'] - base['busy_ms']:.3f} "
            f"more device ms ({base['busy_ms']:.3f} -> {with_ad['busy_ms']:.3f}), idle share {base['idle_share']:.3f} "
            f"-> {with_ad['idle_share']:.3f}, wall {base['wall_ms']:.3f} -> {with_ad['wall_ms']:.3f} ms a step")
        for name, (ms, n) in sorted(extra.items(), key=lambda kv: -kv[1][0])[:8]:
            if n > 0.5:
                log(f"[multi-lora]   +{ms:8.3f} ms/step  +{n:6.1f} launches/step  {name[:110]}")
    return traced


def _merged_rows_vs_kernels(dev, cfg, params, loras, prompts, lengths):
    """(c): ``LORA_CHECK_LAYERS`` layers at full width, a prefill and 4 decode
    steps of one row per adapter and one base row, through the kernels with
    the stacked adapters, against the plain route on the dequantized
    weights with each row's ``a @ b`` merged in fp32 (one plain run a row
    group), both decoding the kernel route's greedy tokens."""
    from starflashattention_tpu_torch.cache import contiguous
    from starflashattention_tpu_torch.core import quant
    from starflashattention_tpu_torch.models import llama
    from starflashattention_tpu_torch.models import lora as lora_lib

    k = LORA_CHECK_LAYERS
    short = dataclasses.replace(cfg, num_layers=k)
    p4 = _first_layers(params, k)
    l4 = [{"layers": {n: {"a": ab["a"][:k], "b": ab["b"][:k]} for n, ab in lr["layers"].items()},
           "scale": lr["scale"]} for lr in loras]
    stack = lora_lib.stack_adapters(l4, device=dev)
    rows_ad = list(LORA_ADAPTERS)  # one row a phase adapter and a base row
    b = len(rows_ad)
    prompts, lengths = prompts[:b], lengths[:b]
    cos, sin = llama.rope_tables(short, device=dev)

    def run(p, tok_rows, lens, feed=None, **ad):
        cache = contiguous.init_cache(k, tok_rows.shape[0], short.num_kv_heads, short.max_seq_len, short.head_dim,
                                      device=dev)
        logits, cache = llama.prefill(p, cache, tok_rows, lens, cos, sin, short, **ad)
        out, fed = [logits], []
        for i in range(4):
            fed.append(llama.sample(logits) if feed is None else feed[i])
            logits, cache = llama.decode_step(p, cache, fed[-1], cos, sin, short, **ad)
            out.append(logits)
        return torch.stack(out), fed

    sel = lora_lib.adapter_onehot([-1 if a is None else a for a in rows_ad], len(loras), device=dev)
    reset_counts()
    kern, fed = run(p4, prompts, lengths, lora=stack, lora_sel=sel)
    counts = read_counts()
    need = ("flash_prefill", "flash_decode", "flash_decode_append", "quant_matmul")
    if not all(counts[n] for n in need):
        raise AssertionError(f"(c): the kernel route launched {counts}, not each of {need}")
    dense = {key: (quant.dequantize_weight(w) if isinstance(w, dict) else w) for key, w in p4.items()
             if key != "layers"}
    dense["layers"] = {n: (quant.dequantize_weight(w) if isinstance(w, dict) else w) for n, w in p4["layers"].items()}
    plain = torch.empty_like(kern)
    with plain_ops():
        for aid in LORA_ADAPTERS:
            rows = [i for i, a in enumerate(rows_ad) if a == aid]
            merged = dense if aid is None else lora_lib.merge(dense, l4[aid], short)
            idx = torch.tensor(rows, device=dev)
            got, _ = run(merged, prompts[idx], lengths[idx], feed=[f[idx] for f in fed])
            plain[:, idx] = got
            del merged
    if read_counts() != counts:
        raise AssertionError("(c): the plain route launched a kernel")
    err, peak = (kern - plain).abs().max().item(), plain.abs().max().item()
    _check(f"multi-LoRA path vs path ({k} layers, prefill + 4 decode steps, rows on adapters "
           f"{rows_ad}) logits (max |logit| {peak:.2f})", err, 0.05 * peak)
    per_row = [((kern[:, i] - plain[:, i]).abs().max() / plain[:, i].abs().max()).item() for i in range(b)]
    same_argmax = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[multi-lora] (c) each row's error over its peak {[round(e, 4) for e in per_row]}, argmax agreement "
        f"{same_argmax:.3f}; kernel launches {counts}")
    del p4, stack, dense
    torch.cuda.empty_cache()
    return dict(err=err, peak=peak, per_row=per_row)


def phase_multi_lora(dev, serving, smi):
    """Multi-LoRA serving at full 7B-GQA width (see the module doc)."""
    from starflashattention_tpu_torch.models import lora as lora_lib
    from starflashattention_tpu_torch.runtime.params import ModelConfig
    from starflashattention_tpu_torch.serving import Engine, PagedEngine

    cfg = ModelConfig.llama_7b_gqa(num_layers=SLICE_LAYERS, max_seq_len=SLICE_SEQ)
    t0 = time.perf_counter()
    params, gen = build_model(cfg, dev)
    loras = _serving_adapters(cfg, dev)
    torch.cuda.synchronize()
    # the engines' stack: (L, N, in, r_max) and (L, N, r_max, out) fp32 a target
    stack_gb = sum(ab["a"].shape[0] * len(loras) * max(LORA_RANKS) * (ab["a"].shape[1] + ab["b"].shape[2]) * 4
                   for ab in loras[0]["layers"].values()) / 1e9
    log(f"[multi-lora] llama_7b_gqa L={cfg.num_layers} int8 weights + int8 lm_head, bf16 KV; {len(loras)} fp32 "
        f"adapters of ranks {LORA_RANKS} on {sorted(loras[0]['layers'])}, b drawn at {LORA_B_STD}; the "
        f"padded stack {stack_gb:.3f} GB; built in {time.perf_counter() - t0:.1f} s ({smi})")
    prompts = _serving_prompts(cfg.vocab_size)
    adapters = _request_adapters(len(prompts))
    kw = dict(num_slots=SERVE_SLOTS, steps_per_round=SERVE_STEPS, device=dev)
    paged_kw = dict(page_size=PAGE_SIZE, prefill_chunk=SERVE_CHUNK, prefix_cache=True, num_pages=SERVE_PAGES)
    runs, reqs, audit = {}, {}, {}

    def audited_paged():
        eng = PagedEngine(params, cfg, lora_adapters=loras, **paged_kw, **kw)
        audit.update(_audit_prefix(eng))
        return eng

    plan = (("base Engine", lambda: Engine(params, cfg, **kw), False, None),
            ("multi-LoRA Engine", lambda: Engine(params, cfg, lora_adapters=loras, **kw), False, adapters),
            ("multi-LoRA PagedEngine", audited_paged, True, adapters))
    for name, make, paged, ad in plan:
        eng, reqs[name], wall, counts = _serve(make, prompts, _serving_counts(cfg.num_layers, paged), adapters=ad)
        st = eng.stats
        runs[name] = dict(wall_s=wall, stats=st.summary(), counts=counts)
        log(f"[multi-lora] {name}: {wall:.2f} s, TTFT p50 {st.p50_ttft_ms():.1f} ms, decode "
            f"{st.decode_tokens_per_s():.1f} tok/s, {json.dumps(st.summary())} ({smi})")
        log(f"[multi-lora] {name} launches {counts} (a): phase 6's expected counts")
        del eng
        torch.cuda.empty_cache()
    for name in ("contiguous", "paged") if serving else ():
        st = serving[name]["stats"]
        log(f"[multi-lora] phase 6's {name} run in this call (no adapters, logprobs on): TTFT p50 "
            f"{st['p50_ttft_ms']} ms, decode {st['decode_tokens_per_s']} tok/s")
    base = [r.output for r in reqs["base Engine"]]
    streams = {name: [r.output for r in reqs[name]] for name in ("multi-LoRA Engine", "multi-LoRA PagedEngine")}

    # (b) the base rows: bit for bit the engine without adapters
    base_rows = [i for i, a in enumerate(adapters) if a is None]
    want = _streams_digest([base[i] for i in base_rows])
    for name, got in streams.items():
        digest = _streams_digest([got[i] for i in base_rows])
        same = sum(got[i] == base[i] for i in base_rows)
        log(f"[multi-lora] (b) {name}: base rows' streams sha256 {digest}, the base Engine's {want}; equal "
            f"{same}/{len(base_rows)}")
        if name == "multi-LoRA Engine" and digest != want:
            raise AssertionError("(b): a base row's stream moved under the adapters")
    # (d) every adapter changes some of its streams
    shares = {}
    for aid in range(len(loras)):
        rows = [i for i, a in enumerate(adapters) if a == aid]
        shares[aid] = sum(streams["multi-LoRA Engine"][i] != base[i] for i in rows) / len(rows)
    log(f"[multi-lora] (d) share of each adapter's streams that differ from the base model's: "
        + ", ".join(f"adapter {a} (rank {LORA_RANKS[a]}) {s:.3f}" for a, s in shares.items()))
    if not all(s > 0 for s in shares.values()):
        raise AssertionError(f"(d): an adapter changed none of its streams: {shares}")
    # (e) prefix hits only within an adapter
    same = sum(a == b for a, b in zip(*streams.values()))
    log(f"[multi-lora] (e) prefix hits by adapter (-1 the base) {audit['hits']}, pages matched across adapters "
        f"{audit['cross']}; streams equal between the multi-LoRA Engine and PagedEngine {same}/{len(prompts)} "
        f"({same / len(prompts):.3f})")
    if audit["cross"] or not audit["hits"]:
        raise AssertionError(f"(e): prefix hits {audit['hits']}, {audit['cross']} pages across adapters")
    # both engines' streams, teacher-forced on the adapted contiguous decode route: near-ties, not errors
    stack = lora_lib.stack_adapters(loras, device=dev)
    for name, got in streams.items():
        _tie_check(f"{name} streams", params, cfg, prompts, got, dev, label="multi-lora", lora=stack,
                   adapters=adapters)
    traced = _lora_round_trace(params, cfg, prompts, stack, dev)
    del stack
    torch.cuda.empty_cache()
    p_prompts, p_lengths = _prompts(cfg, dev, gen)
    check = _merged_rows_vs_kernels(dev, cfg, params, loras, p_prompts, p_lengths)
    del params, loras
    torch.cuda.empty_cache()
    return dict(runs=runs, shares=shares, audit=audit, check=check,
                traced={k: v and {f: v[f] for f in ("wall_ms", "busy_ms", "launches", "idle_share")}
                        for k, v in traced.items()})


REPLACES = {
    "flash_decode (1 split, fused)": ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode_split.cu"),
    "flash_decode (split-KV partials)": ("starflashattention_tpu/ops/flash_decode.py:141",
                                         "flash_decode_split.cu"),
    "append_rows_kv": ("starflashattention_tpu/ops/cache_append.py:86", "cache_append.cu"),
    **{FOLD_ENTRIES[n]: ("starflashattention_tpu/ops/cache_append.py:86", "flash_decode_split.cu") for n in (1, 4)},
    FOLD_ENTRIES["paged"]: ("starflashattention_tpu/ops/cache_append.py:219", "flash_decode_split.cu"),
    FOLD_ENTRIES["verify"]: ("starflashattention_tpu/ops/cache_append.py:331", "flash_decode_split.cu"),
    "quant_matmul (small-M, decode rows)": ("starflashattention_tpu/ops/quant_matmul.py:35", "quant_matmul.cu"),
    "quant_matmul (tiled, prefill rows)": ("starflashattention_tpu/ops/quant_matmul.py:35", "quant_matmul.cu"),
    "flash_prefill": ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
    "paged_flash_decode": ("starflashattention_tpu/ops/paged_decode.py:74", "flash_decode_split.cu"),
    "append_rows_paged_kv": ("starflashattention_tpu/ops/cache_append.py:219", "cache_append.cu"),
    "flash_verify": ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode_split.cu"),
    "flash_verify int8 KV": ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode_split.cu"),
    "append_block_kv": ("starflashattention_tpu/ops/cache_append.py:331", "cache_append.cu"),
    "flash_prefill (return_lse, training)": ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
    "flash_bwd_dq": ("starflashattention_tpu/ops/flash_bwd.py:173", "flash_bwd.cu"),
    "flash_bwd_dkdv": ("starflashattention_tpu/ops/flash_bwd.py:254", "flash_bwd.cu"),
    K12_SPLIT: ("starflashattention_tpu/ops/flash_bwd.py:254", "flash_bwd.cu"),
    "quant_matmul_int4 (small-M, decode rows)": ("starflashattention_tpu/ops/quant_matmul.py:178",
                                                 "quant_matmul.cu"),
    "quant_matmul_int4 (tiled, prefill rows)": ("starflashattention_tpu/ops/quant_matmul.py:178",
                                                "quant_matmul.cu"),
    "quant_matmul_w8a8 (prefill rows)": ("starflashattention_tpu/ops/quant_matmul.py:500", "quant_matmul_a8.cu"),
    "quant_matmul_w4a8 (prefill rows)": ("starflashattention_tpu/ops/quant_matmul.py:346", "quant_matmul_a8.cu"),
    **{f"flash_decode {m} KV (1 split, fused)": ("starflashattention_tpu/ops/flash_decode.py:213",
                                                 "flash_decode_split.cu") for m in ("int8", "fp8")},
    **{f"flash_decode {m} KV (split-KV partials)": ("starflashattention_tpu/ops/flash_decode.py:141",
                                                    "flash_decode_split.cu") for m in ("int8", "fp8")},
    **{f"paged_flash_decode {m} KV": ("starflashattention_tpu/ops/paged_decode.py:74", "flash_decode_split.cu")
       for m in ("int8", "fp8")},
    **{VARIANT_ENTRIES[k]: ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode_split.cu")
       for k in ("mistral_decode", "gemma2_decode", "gemma2_decode_full", "gemma2_verify")},
    VARIANT_ENTRIES["gemma_split"]: ("starflashattention_tpu/ops/flash_decode.py:141", "flash_decode_split.cu"),
    **{VARIANT_ENTRIES[k]: ("starflashattention_tpu/ops/paged_decode.py:74", "flash_decode_split.cu")
       for k in ("mistral_paged", "gemma2_paged")},
    **{VARIANT_ENTRIES[k]: ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu")
       for k in ("gemma2_prefill", "mistral_prefill")},
    LATENT_ENTRIES["decode"]: ("starflashattention_tpu/ops/flash_decode.py:213", "flash_decode_split.cu"),
    LATENT_ENTRIES["paged"]: ("starflashattention_tpu/ops/paged_decode.py:74", "flash_decode_split.cu"),
    LATENT_ENTRIES["prefill"]: ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
    LATENT_ENTRIES["int4_experts"]: ("starflashattention_tpu/ops/quant_matmul.py:178", "quant_matmul.cu"),
    LATENT_ENTRIES["int8_experts"]: ("starflashattention_tpu/ops/quant_matmul.py:35", "quant_matmul.cu"),
    RING_ENTRIES["fwd"]: ("starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
    RING_ENTRIES["dq"]: ("starflashattention_tpu/ops/flash_bwd.py:173", "flash_bwd.cu"),
    RING_ENTRIES["dkdv"]: ("starflashattention_tpu/ops/flash_bwd.py:254", "flash_bwd.cu"),
    FUSED_MLP_ENTRY: ("starflashattention_tpu/ops/fused_mlp.py:175", "fused_mlp.cu"),
    **{TRAIN_VARIANT_ENTRIES[k]: (site, src) for k in TRAIN_VARIANT_ENTRIES
       for suffix, site, src in (("_fwd", "starflashattention_tpu/ops/flash_prefill.py:67", "flash_prefill.cu"),
                                 ("_dq", "starflashattention_tpu/ops/flash_bwd.py:173", "flash_bwd.cu"),
                                 ("_dkdv", "starflashattention_tpu/ops/flash_bwd.py:254", "flash_bwd.cu"))
       if k.endswith(suffix)},
}
# measured in phase 2 but launched by no main-path run (the quantized slice
# runs the fp8 cache only in split mode and pages only in int8; no path
# serves fp8 weights; DeepSeek-V2-Lite decodes its latent row in one split;
# the decode and verify paths run K3's, K8's and K9's work folded into the
# attention's launch, the FOLD_ENTRIES rows, and the standalone K3 / K8 / K9
# on no path): logged, not in the kernels line
OFF_PATH = ("flash_decode fp8 KV (1 split, fused)", "paged_flash_decode fp8 KV", QMM_FP8_TILED, QMM_FP8_SMALL,
            K5_TRAIN_NO_LSE, LATENT_ENTRIES["split"], "append_rows_kv", "append_rows_paged_kv", "append_block_kv")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,6,7,8,9,10,11,12,13,14,15,16,17",
                        help="comma-separated phases to run (default 1,2,3,4,6,7,8,9,10,11,12,13,14,15,16,17; phase "
                             "5, a profile of bench.py's decode chains, runs only when named)")
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import starflashattention_tpu_torch  # noqa: F401  (fails outside a checkout)
    from starflashattention_tpu_torch.ops._build import BUILD_DIR

    # the compiled library calls (flex_attention) cache their kernels in the checkout's build directory
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    seconds = {}

    def run(phase, fn):
        """fn() if ``phase`` was asked for (else {}), its seconds kept."""
        if phase not in phases:
            return {}
        t0 = time.perf_counter()
        result = fn()
        seconds[phase] = time.perf_counter() - t0
        return result

    smi = phase_device_and_build()
    seconds[1] = time.perf_counter() - t_start
    timer = Timer(dev)
    kernels = run(2, lambda: phase_kernels(dev, timer))
    runs = run(3, lambda: phase_slice(dev))
    run(4, lambda: phase_path_vs_path(dev))
    serving = run(6, lambda: phase_serving(dev))
    quant = run(7, lambda: phase_quant_slice(dev))
    spec = run(8, lambda: phase_spec(dev))
    training = run(9, lambda: phase_training(dev))
    variants = run(10, lambda: phase_variants(dev))
    train_variants = run(11, lambda: phase_train_variants(dev))
    deepseek = run(12, lambda: phase_deepseek(dev, smi))
    seq_parallel = run(13, lambda: phase_seq_parallel(smi))
    tensor_parallel = run(14, lambda: phase_tensor_parallel(smi))
    run(15, lambda: phase_checkpoint(dev, smi))
    moe_training = run(16, lambda: phase_moe_training(dev, smi))
    multi_lora = run(17, lambda: phase_multi_lora(dev, serving, smi))
    run(5, lambda: phase_decode_profile(dev))

    launches = {}
    if runs:
        fused, split = runs[1]["counts"], runs[max(runs)]["counts"]
        launches = {"flash_decode (1 split, fused)": fused["flash_decode"],
                    "flash_decode (split-KV partials)": split["flash_decode"],
                    FOLD_ENTRIES[1]: fused["flash_decode_append"],
                    FOLD_ENTRIES[4]: split["flash_decode_append"],
                    "quant_matmul (small-M, decode rows)": split["quant_matmul"] - split["quant_matmul_tiled"],
                    "quant_matmul (tiled, prefill rows)": split["quant_matmul_tiled"],
                    "flash_prefill": split["flash_prefill"]}
    if serving:
        paged = serving["paged"]["counts"]
        launches.update({"paged_flash_decode": paged["paged_flash_decode"],
                         FOLD_ENTRIES["paged"]: paged["paged_flash_decode_append"]})
    if quant:
        off, w4a8, w8a8 = (quant[key]["counts"] for key in ("off", "w4a8", "w8a8"))
        launches.update({
            "quant_matmul_int4 (small-M, decode rows)": off["quant_matmul_int4"] - off["quant_matmul_int4_tiled"],
            "quant_matmul_int4 (tiled, prefill rows)": off["quant_matmul_int4_tiled"],
            "quant_matmul_w4a8 (prefill rows)": w4a8["quant_matmul_w4a8"],
            "quant_matmul_w8a8 (prefill rows)": w8a8["quant_matmul_w8a8"],
            "flash_decode int8 KV (1 split, fused)": off["flash_decode"],
            "flash_decode int8 KV (split-KV partials)": w4a8["flash_decode"],
            "flash_decode fp8 KV (split-KV partials)": w8a8["flash_decode"],
            "paged_flash_decode int8 KV": quant["paged"]["counts"]["paged_flash_decode"]})
    if spec:
        launches.update({"flash_verify": spec["lookup"]["counts"]["flash_verify"],
                         FOLD_ENTRIES["verify"]: spec["lookup"]["counts"]["flash_verify_append"],
                         "flash_verify int8 KV": spec["int8_kv"]["counts"]["flash_verify"]})
    if training:
        full = training["full"]["counts"]
        launches.update({"flash_prefill (return_lse, training)": full["flash_prefill_lse"],
                         "flash_bwd_dq": full["flash_bwd_dq"], "flash_bwd_dkdv": full["flash_bwd_dkdv"]})
    if variants:
        g2, mi = variants["gemma2"], variants["mistral"]
        gen = g2["generate"]["counts"]
        e = VARIANT_ENTRIES
        launches.update({
            e["gemma2_decode"]: gen["flash_decode_banded"],
            e["gemma2_decode_full"]: gen["flash_decode"] - gen["flash_decode_banded"],
            e["gemma2_prefill"]: gen["flash_prefill"],
            e["gemma2_verify"]: g2["spec"]["counts"]["flash_verify"],
            e["gemma2_paged"]: g2["paged"]["counts"]["paged_flash_decode"],
            e["mistral_decode"]: mi["engine"]["counts"]["flash_decode"],
            e["mistral_prefill"]: mi["engine"]["counts"]["flash_prefill"],
            e["mistral_paged"]: mi["paged"]["counts"]["paged_flash_decode"],
            e["gemma_split"]: variants["gemma"]["generate"]["counts"]["flash_decode"]})
    if train_variants:
        mi, g2 = train_variants["mistral"]["counts"], train_variants["gemma2"]["counts"]
        g7 = train_variants["grads"]["Gemma-7B"]["counts"]
        e = TRAIN_VARIANT_ENTRIES
        launches.update({
            e["mistral_fwd"]: mi["flash_prefill_lse_banded"], e["mistral_dq"]: mi["flash_bwd_dq_banded"],
            e["mistral_dkdv"]: mi["flash_bwd_dkdv_banded"],
            e["gemma2_fwd"]: g2["flash_prefill_lse_banded"], e["gemma2_dq"]: g2["flash_bwd_dq_banded"],
            e["gemma2_dkdv"]: g2["flash_bwd_dkdv_banded"],
            e["gemma2_full_fwd"]: g2["flash_prefill_lse"] - g2["flash_prefill_lse_banded"],
            e["gemma2_full_dq"]: g2["flash_bwd_dq"] - g2["flash_bwd_dq_banded"],
            e["gemma2_full_dkdv"]: g2["flash_bwd_dkdv"] - g2["flash_bwd_dkdv_banded"],
            e["gemma_fwd"]: g7["flash_prefill_lse"], e["gemma_dq"]: g7["flash_bwd_dq"],
            e["gemma_dkdv"]: g7["flash_bwd_dkdv"]})
    if deepseek:
        ds, mx = deepseek["deepseek"], deepseek["mixtral"]["generate"]["counts"]
        gen = ds["generate"]["counts"]
        e = LATENT_ENTRIES
        launches.update({
            e["decode"]: gen["flash_decode"], e["prefill"]: gen["flash_prefill"],
            e["paged"]: ds["paged"]["counts"]["paged_flash_decode"],
            e["int4_experts"]: gen["quant_matmul_int4"] - gen["quant_matmul_int4_tiled"],
            e["int8_experts"]: mx["quant_matmul"] - mx["quant_matmul_tiled"]})
    if seq_parallel:
        tot = seq_parallel["totals"]
        launches.update({RING_ENTRIES["fwd"]: tot["flash_prefill_kv_offset"],
                         RING_ENTRIES["dq"]: tot["flash_bwd_dq_kv_offset"],
                         RING_ENTRIES["dkdv"]: tot["flash_bwd_dkdv_kv_offset"]})
    if FUSED_MLP_ENTRY in kernels:
        launches[FUSED_MLP_ENTRY] = kernels[FUSED_MLP_ENTRY]["path_launches"]
    if tensor_parallel:  # phase 14's paths add their launches over the ranks to the kernels they run
        tot = tensor_parallel["totals"]
        for entry, n in (("flash_decode (1 split, fused)", tot["flash_decode"]),
                         (FOLD_ENTRIES[1], tot["flash_decode_append"]),
                         ("quant_matmul (small-M, decode rows)", tot["quant_matmul"] - tot["quant_matmul_tiled"]),
                         ("quant_matmul (tiled, prefill rows)", tot["quant_matmul_tiled"]),
                         ("flash_prefill", tot["flash_prefill"] - tot["flash_prefill_lse"]),
                         ("paged_flash_decode", tot["paged_flash_decode"]),
                         (FOLD_ENTRIES["paged"], tot["paged_flash_decode_append"]),
                         ("flash_verify", tot["flash_verify"]),
                         (FOLD_ENTRIES["verify"], tot["flash_verify_append"]),
                         ("quant_matmul_w8a8 (prefill rows)", tot["quant_matmul_w8a8"]),
                         ("quant_matmul_w4a8 (prefill rows)", tot["quant_matmul_w4a8"]),
                         ("flash_prefill (return_lse, training)",
                          tot["flash_prefill_lse"] - tot["flash_prefill_kv_offset"]),
                         ("flash_bwd_dq", tot["flash_bwd_dq"] - tot["flash_bwd_dq_kv_offset"]),
                         ("flash_bwd_dkdv", tot["flash_bwd_dkdv"] - tot["flash_bwd_dkdv_kv_offset"])):
            launches[entry] = (launches.get(entry) or 0) + n
        launches[K12_SPLIT] = tot["flash_bwd_dkdv_split"]  # of phase 14e's dk/dv launches, the split ones
    for key in ("mixtral", "qwen3") if moe_training else ():  # phase 16's training steps
        counts = moe_training[key]["counts"]
        for entry, n in (("flash_prefill (return_lse, training)", counts["flash_prefill_lse"]),
                         ("flash_bwd_dq", counts["flash_bwd_dq"]), ("flash_bwd_dkdv", counts["flash_bwd_dkdv"])):
            launches[entry] = (launches.get(entry) or 0) + n
    for key in ("multi-LoRA Engine", "multi-LoRA PagedEngine", "base Engine") if multi_lora else ():
        counts = multi_lora["runs"][key]["counts"]  # phase 17's engines at 4 splits
        for entry, n in (("flash_decode (split-KV partials)", counts["flash_decode"]),
                         (FOLD_ENTRIES[4], counts["flash_decode_append"]),
                         ("paged_flash_decode", counts["paged_flash_decode"]),
                         (FOLD_ENTRIES["paged"], counts["paged_flash_decode_append"]),
                         ("quant_matmul (small-M, decode rows)", counts["quant_matmul"] - counts["quant_matmul_tiled"]),
                         ("quant_matmul (tiled, prefill rows)", counts["quant_matmul_tiled"]),
                         ("flash_prefill", counts["flash_prefill"])):
            launches[entry] = (launches.get(entry) or 0) + n
    line = []
    for name, r in kernels.items():
        if name in OFF_PATH:
            continue
        replaces, src = REPLACES[name]
        line.append({"name": name, "route": "cuda", "source": f"starflashattention_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches.get(name),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log("[done] seconds by phase: " + ", ".join(f"{p} {t:.1f}" for p, t in seconds.items()))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
